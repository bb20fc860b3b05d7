// align_reduce: the word-timing pass's reduction of the alignment heads'
// cross-attention to one [T, F] matrix a window.
//
// Replaces no Pallas kernel: the JAX package leaves this work to XLA
// fusion (notsofar_tpu/asr/decoding.py: _median7_network :599-616, used
// by znorm_median and median7 :722-741). The port ran it as a chain of
// PyTorch calls (ops/kernels.py align_reduce_plain): four or five
// elementwise passes for the z-norm, then torch.cat padding, an unfold
// view and torch.median, whose sort-based gatherMedian took ~129 ms of
// the card's time a window at large-v3's 320 heads. Same function: for
// window b, each selected head (layer l, head h) of w = cross[l][b, h]
// [T, F] f32, and the window's n = n_real[b] real token rows,
//   mean[f] = sum_{t < n} w[t, f] / max(n, 1)
//   var[f]  = sum_{t < n} (w[t, f] - mean[f])^2 / max(n, 1)
//   z[t, f] = (w[t, f] - mean[f]) / (sqrt(var[f]) + 1e-9)
//   m[t, f] = median of z[t, clamp(f + k, 0, F - 1)] over k = -3..3
// and out[b, t, f] = (sum over the heads of m[t, f]) / n_heads for t < n.
// Rows t >= n are written as zeros: no caller reads them (the DTW reads
// the first n - sot_len - 1 text rows of each window). Everything is f32;
// only the order of the z-norm's and the head sum's additions differs from
// the plain version. The median is the odd-even transposition network of
// the JAX package (21 compare-exchanges, then the middle lane), which
// gives the element torch.median gives for an odd width.
//
// What bounds it on an H100: bytes. Each selected head's n real rows are
// read once (4 * n * F bytes); at large-v3's 320 heads, 155 real rows and
// 1500 frames that is 298 MB a window, 0.09 ms at 3.35 TB/s. The median's
// ~30 min/max a value (the network's last passes are dead code but for the
// middle lane) and the shared-memory passes over each staged slab put the
// kernel above that line, not at it.
//
// Design. One block of 256 threads per (tile of 8 frames, window), grid
// (ceil(F / 8), B); the block loops over the selected heads (their
// [B, H, T, F] slabs found through a small device array of pointers, one
// per head, so the layers are never stacked or copied). For each head it
// stages the n real rows of the tile's 8 frames plus 4 halo frames on each
// side (16-byte cp.async copies; each halo frame gets its own column
// statistics, so the halo is reloaded, not shared with the neighbouring
// tile; past the first and last frame the edge frame is staged again,
// which is the median's edge replication), double-buffered: the next
// head's copies are in flight while this head's statistics and medians
// run. Column sums over the rows (RG row groups x the tile's columns, then
// a fixed-order sum of the groups), the same for the squared deviations,
// then the staged rows are normalised in place. Thread (row r0, frames 4g
// .. 4g + 3 of the tile, g in {0, 1}) then takes rows r0, r0 + 128, ...:
// the row's 12 staged values around its 4 frames as three 16-byte reads
// from shared memory, four independent median networks in registers, four
// adds into its register accumulators. After the last head each thread
// writes its rows of the tile once. No [B, H, T, F] intermediate, no
// padded copy and no per-layer sum goes through device memory.
//
// Why 8 frames a tile, at every shape: timed on an H100 against tiles of
// 16 and 32 frames (same kernel, 320 heads, 1500 frames), 8 was the
// fastest at 1, 2, 3, 6 and 9 windows of T 256 and at 1 and 12 windows of
// T 448 (2.1x faster than 32 at one window). 16 was faster by 8% and 4%
// at 4 and 12 windows of T 256 and by 18% at 9 windows of T 128, a
// pattern of wave tails that no simple rule of the shapes follows. 32,
// whose block holds 2.5x the staged columns and so fits 2 blocks an SM at
// T 256 against 6, was the slowest with 320 heads at every shape. An
// 8-frame tile stages twice its width (the halo) but gives one window 188
// blocks for the card's 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int HALO = 4;     // frames staged each side (3 used; 4 keep 16 B)
constexpr int STAGES = 2;   // heads in shared memory at once
constexpr int FRAMES = 4;   // frames of a row a thread takes
constexpr int TILE = 8;     // frames a block's outputs cover
constexpr int CS = TILE + 2 * HALO;    // staged columns
constexpr int TPR = TILE / FRAMES;     // threads a row
constexpr int RS = THREADS / TPR;      // rows one pass of the medians covers
constexpr int RG = THREADS / CS;       // row groups of the column sums

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the JAX package's _median7_network: 7 passes of compare-exchanges on the
// pairs (0,1),(2,3),(4,5) then (1,2),(3,4),(5,6), then the middle lane
__device__ __forceinline__ float median7(const float* v) {
  float w[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) w[i] = v[i];
#pragma unroll
  for (int p = 0; p < 7; ++p) {
#pragma unroll
    for (int i = p & 1; i < 6; i += 2) {
      const float lo = fminf(w[i], w[i + 1]);
      const float hi = fmaxf(w[i], w[i + 1]);
      w[i] = lo;
      w[i + 1] = hi;
    }
  }
  return w[3];
}

// ITEMS rows a thread (ITEMS * RS >= T); F % 4 == 0 and 16-byte aligned
// slabs, so rows are staged 16 bytes at a time and written as float4s
template <int ITEMS>
__global__ void __launch_bounds__(THREADS)
align_reduce_kernel(const float* const* __restrict__ heads,
                    const long long* __restrict__ n_real,
                    float* __restrict__ out, int n_heads, int T, int F,
                    long long bstride) {
  extern __shared__ __align__(16) float smem[];
  float* part = smem + STAGES * T * CS;   // [RG, CS] partial sums
  float* mean = part + RG * CS;           // [CS]
  float* den = mean + CS;                 // [CS] sqrt(var) + 1e-9

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TILE;
  const long long nr = n_real[b];
  const int n = (int)(nr < 0 ? 0 : (nr > T ? T : nr));
  const float cnt = (float)(nr > 1 ? nr : 1);

  // stages head i's rows of frames [f0 - HALO, f0 + TILE + HALO), each frame
  // outside [0, F) as the nearest edge frame
  auto stage_head = [&](int i) {
    if (i < n_heads) {
      const float* src = heads[i] + (size_t)b * bstride;
      float* dst = smem + (i % STAGES) * T * CS;
      constexpr int CPR = CS / 4;        // 16-byte chunks a staged row
      for (int k = tid; k < n * CPR; k += THREADS) {
        const int r = k / CPR, c = k - r * CPR;
        const int f = f0 - HALO + 4 * c;
        const float* row = src + (size_t)r * F;
        float* d = dst + r * CS + 4 * c;
        // F, f0 and HALO are multiples of 4: a chunk lies wholly inside
        // [0, F) or wholly outside, where it holds the edge frame 4 times
        if (f >= 0 && f < F) {
          cp_async16(d, row + f);
        } else {
          const float e = row[f < 0 ? 0 : F - 1];
          *reinterpret_cast<float4*>(d) = make_float4(e, e, e, e);
        }
      }
    }
    cp_async_commit();
  };

  const int g = tid % TPR, r0 = tid / TPR;
  const int fg = f0 + FRAMES * g;      // this thread's first frame
  const int sc = tid % CS, sg = tid / CS;   // column-sum slot

  float acc[ITEMS][FRAMES];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
#pragma unroll
    for (int q = 0; q < FRAMES; ++q) acc[k][q] = 0.f;

  stage_head(0);
  for (int i = 0; i < n_heads; ++i) {
    // every thread is done with head i - 1: its buffer, the sums, the stats
    __syncthreads();
    stage_head(i + 1);
    cp_async_wait_one();
    __syncthreads();
    float* x = smem + (i % STAGES) * T * CS;

    if (sg < RG) {
      float s = 0.f;
      for (int r = sg; r < n; r += RG) s += x[r * CS + sc];
      part[sg * CS + sc] = s;
    }
    __syncthreads();
    if (tid < CS) {
      float s = 0.f;
#pragma unroll
      for (int gg = 0; gg < RG; ++gg) s += part[gg * CS + tid];
      mean[tid] = s / cnt;
    }
    __syncthreads();
    if (sg < RG) {
      const float m = mean[sc];
      float s = 0.f;
      for (int r = sg; r < n; r += RG) {
        const float d = x[r * CS + sc] - m;
        s += d * d;
      }
      part[sg * CS + sc] = s;
    }
    __syncthreads();
    if (tid < CS) {
      float s = 0.f;
#pragma unroll
      for (int gg = 0; gg < RG; ++gg) s += part[gg * CS + tid];
      den[tid] = sqrtf(s / cnt) + 1e-9f;
    }
    __syncthreads();
    for (int k = tid; k < n * CS; k += THREADS) {
      const int c = k % CS;
      x[k] = (x[k] - mean[c]) / den[c];
    }
    __syncthreads();

    // frames fg + q take the staged columns FRAMES * g + q + 1 .. + 7
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int r = r0 + k * RS;
      if (r < n) {
        const float4* p =
            reinterpret_cast<const float4*>(x + r * CS + FRAMES * g);
        float v[12];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float4 u = p[j];
          v[4 * j] = u.x;
          v[4 * j + 1] = u.y;
          v[4 * j + 2] = u.z;
          v[4 * j + 3] = u.w;
        }
#pragma unroll
        for (int q = 0; q < FRAMES; ++q) acc[k][q] += median7(v + q + 1);
      }
    }
  }

  const float nh = (float)n_heads;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int r = r0 + k * RS;
    if (r >= T) continue;
    float o[FRAMES];
#pragma unroll
    for (int q = 0; q < FRAMES; ++q) o[q] = r < n ? acc[k][q] / nh : 0.f;
    if (fg < F)
      *reinterpret_cast<float4*>(out + ((size_t)b * T + r) * F + fg) =
          make_float4(o[0], o[1], o[2], o[3]);
  }
}

size_t smem_bytes(int T) {
  return sizeof(float) * ((size_t)STAGES * T * CS + RG * CS + 2 * CS);
}

template <int ITEMS>
int launch(const float* const* heads, const long long* n_real, float* out,
           int n_heads, int B, int T, int F, long long bstride,
           cudaStream_t st) {
  const size_t smem = smem_bytes(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        align_reduce_kernel<ITEMS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((F + TILE - 1) / TILE, B);
  align_reduce_kernel<ITEMS><<<grid, THREADS, smem, st>>>(
      heads, n_real, out, n_heads, T, F, bstride);
  return (int)cudaGetLastError();
}

}  // namespace

// heads: device array of n_heads pointers, each to window 0 of one selected
// head's [T, F] f32 slab, 16-byte aligned, window b at + b * bstride
// elements; n_real [B] int64 on the device; out [B, T, F] f32; F % 4 == 0;
// items in {1, 2, 4} with items * 128 >= T (ops/kernels.py
// align_reduce_launch). Returns cudaGetLastError() of the launch.
extern "C" int align_reduce(const void* heads, const void* n_real, void* out,
                            int n_heads, int B, int T, int F,
                            long long bstride, int items, void* stream) {
  if (n_heads <= 0 || B <= 0 || T <= 0 || F <= 0 || F % 4 != 0 ||
      B > 65535 || (long long)items * RS < T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const* h = static_cast<const float* const*>(heads);
  const long long* nr = static_cast<const long long*>(n_real);
  float* o = static_cast<float*>(out);
  switch (items) {
    case 1:
      return launch<1>(h, nr, o, n_heads, B, T, F, bstride, st);
    case 2:
      return launch<2>(h, nr, o, n_heads, B, T, F, bstride, st);
    case 4:
      return launch<4>(h, nr, o, n_heads, B, T, F, bstride, st);
  }
  return (int)cudaErrorInvalidValue;
}
