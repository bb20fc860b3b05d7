// xattn_stream: the streaming floor of the int8 cross-attention -- every
// byte of a row's int8 K and V memory read, almost no arithmetic.
//
// Replaces tools/bench_xattn_variants.py::run_stream (pallas_call :56,
// body _stream_kernel :45-51), the probe that times xattn_int8's K/V
// traffic alone. Same function: out[b, 0, d] = 1e-6 * (sum_{s<8} k8[b, s, d]
// + sum_{s<8} v8[b, s, d]) in f32 (the sums of int8 values are exact
// integers, so the only rounding is the final product); q is not read.
// On the TPU the BlockSpec DMA moves the whole [1, S, D] K and V blocks
// into VMEM although the body reads rows 0-7. nvcc drops loads whose
// values are unused, so this kernel consumes every byte it loads: it
// folds the row's K and V bytes into a per-row int32 checksum
// (sum of all signed bytes, mod 2**32), a second output.
//
// What bounds it on an H100: bytes (2 * S * D int8 per row, one integer
// add per byte). Design: the TPU's grid of one cell per row would give
// 24 blocks for 132 SMs at the tool's shape, so each row's [K | V] bytes
// are cut into 32 KB chunks, one block each (2820 blocks at B 24, S 1504,
// D 1280). Each thread issues its 8 independent 16-byte loads before
// using any, neighbouring threads on neighbouring addresses, as streaming
// loads (__ldcs: each byte is read once, so it need not stay in cache),
// sums the bytes with __dp4a, and the block adds its sum to the row's
// checksum with one atomic. The first block of each row also forms out[b] from
// rows 0-7 (20 KB, read a second time), each thread issuing its 16
// loads of one 16-channel slice before it sums them: loaded byte by byte,
// one row after another, those dependent loads would make this block the
// kernel's critical path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int WORDS = 8;                      // 16-byte loads per thread
constexpr int CHUNK = NTHREADS * WORDS;       // 16-byte words per block
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void __launch_bounds__(NTHREADS)
xattn_stream_kernel(const int8_t* __restrict__ k8,
                    const int8_t* __restrict__ v8, float* __restrict__ out,
                    int* __restrict__ checksum, long long row_words, int D,
                    int head_rows) {
  const int b = blockIdx.y;
  const int4* kw = reinterpret_cast<const int4*>(k8) + b * row_words;
  const int4* vw = reinterpret_cast<const int4*>(v8) + b * row_words;
  const long long w0 = (long long)blockIdx.x * CHUNK + threadIdx.x;

  // word w of the row's [K | V] bytes; past the end reads nothing
  int4 u[WORDS];
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    const long long w = w0 + (long long)i * NTHREADS;
    if (w < row_words)
      u[i] = __ldcs(kw + w);
    else if (w < 2 * row_words)
      u[i] = __ldcs(vw + (w - row_words));
    else
      u[i] = make_int4(0, 0, 0, 0);
  }
  int acc = 0;
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    acc = __dp4a(u[i].x, 0x01010101, acc);
    acc = __dp4a(u[i].y, 0x01010101, acc);
    acc = __dp4a(u[i].z, 0x01010101, acc);
    acc = __dp4a(u[i].w, 0x01010101, acc);
  }
  acc = __reduce_add_sync(FULL_MASK, acc);
  __shared__ int part[NTHREADS / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned s = 0;                           // wraps mod 2**32, as atomics do
#pragma unroll
    for (int i = 0; i < NTHREADS / 32; ++i) s += (unsigned)part[i];
    atomicAdd(reinterpret_cast<unsigned*>(checksum) + b, s);
  }

  if (blockIdx.x == 0) {
    // rows 0-7, 16 channels a thread: all 16 loads in flight at once
    const int cw = D / 16;                    // 16-byte words of a key row
    for (int c = threadIdx.x; c < cw; c += NTHREADS) {
      int4 rw[2 * 8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const bool in = r < head_rows;
        rw[2 * r] = in ? kw[r * cw + c] : make_int4(0, 0, 0, 0);
        rw[2 * r + 1] = in ? vw[r * cw + c] : make_int4(0, 0, 0, 0);
      }
      int s[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const unsigned w[4] = {(unsigned)rw[r].x, (unsigned)rw[r].y,
                               (unsigned)rw[r].z, (unsigned)rw[r].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[4 * j + i] += static_cast<int>(w[j] << (24 - 8 * i)) >> 24;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        out[(size_t)b * D + c * 16 + i] = static_cast<float>(s[i]) * 1e-6f;
    }
  }
}

}  // namespace

// k8, v8 [B, S, D] int8, contiguous and 16-byte aligned, D % 16 == 0;
// out [B, 1, D] f32; checksum [B] int32, zeroed by the caller. Returns
// cudaGetLastError() of the launch.
extern "C" int xattn_stream(const void* k8, const void* v8, float* out,
                            int* checksum, int B, int S, int D,
                            void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 16 || D % 16)
    return (int)cudaErrorInvalidValue;
  const long long row_words = (long long)S * D / 16;
  const long long blocks = (2 * row_words + CHUNK - 1) / CHUNK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, B);
  xattn_stream_kernel<<<grid, NTHREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(k8), static_cast<const int8_t*>(v8), out,
      checksum, row_words, D, S < 8 ? S : 8);
  return (int)cudaGetLastError();
}
