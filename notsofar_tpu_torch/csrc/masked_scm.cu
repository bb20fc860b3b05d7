// masked_scm: the masked spatial covariance matrices of MVDR.
//
// Replaces notsofar_tpu/ops/pallas_kernels.py::masked_scm_pallas (wrapper
// :488, pallas_call :512, body _scm_kernel :468). Same function:
//   R[b, k, f, m, n] = sum_t wta[b, f, t, k] * x[b, f, t, m] * conj(x[b, f, t, n])
//                      + 1e-15 * (m == n)
// with wta [B, F, T, K] f32, x [B, F, T, M] complex64 (interleaved float2),
// R [B, K, F, M, M] complex64; the 1e-15 lands on the real part of the
// diagonal after the sum (an all-zero window gives exactly 1e-15 * I).
//
// What bounds it on an H100: bytes. Each (b, f) reads T*M complex and T*K
// masks once and writes K*M*M complex; per frame it does ~4 FLOP for each
// of the M(M+1)/2 outer-product entries and 2K FMA-pairs per entry, ~1 FLOP
// per byte read at M = 7, K = 4, under the f32 FMA rate per byte -- but not
// far under: at the MVDR chunk's shape the FMAs alone take ~40% of the
// bytes' time, so the loads must stay in flight while the lanes compute.
//
// Design. The TPU grid (B, K, F/32) reads each x tile K times and keeps
// real and imaginary planes apart (a VMEM layout need, with F padded to
// the block). Here one warp owns one (b, f) pair and all K masks, with a
// ring of `stages` buffers of 32 frames each (x and wta, straight from the
// engine's layout: no transposes, no padding) in shared memory. The warp
// puts its first `stages` buffers in flight as asynchronous copies
// (cp.async of 8 bytes per complex, 4 per mask, each lane a share, each
// lane arriving on the buffer's mbarrier when its copies land) before it
// computes anything; as it finishes a buffer it refills it with the frames
// `stages` buffers ahead, so the next frames' bytes are in flight while the
// lanes accumulate. (The first design staged 32 frames with plain loads and
// then computed, nothing in flight between stages; stages = 1 here is that
// schedule with asynchronous copies.) Each lane owns one entry (m <= n) of
// the upper triangle (28 of 32 lanes at M = 7; a second entry per lane for
// M = 8). Per frame a lane forms its entry of x x^H once and adds it,
// weighted by each of the K masks, into K complex f32 accumulators (plain
// f32 FMAs, no tensor cores: f32 sums are the tolerance), even and odd
// frames into two sets summed at the end, so that consecutive frames' FMA
// chains do not wait on each other. The lane then
// writes its entry and, off the diagonal, the conjugate into the lower
// triangle; diagonal imaginary parts are exactly zero. Four warps (four
// frequencies) share a block. The kernel is instantiated per K and per
// entries-per-lane, so the accumulators are exactly 2 * K * EPL registers.
#include "split_softmax.cuh"

namespace {

namespace sp = nt::split;

constexpr int WARPS = 4;          // frequencies per block
constexpr int TT = 32;            // frames a buffer holds
constexpr int MAXM = 8;
constexpr int MAX_STAGES = 8;

// bytes of one warp's buffer: TT frames of M complex, then TT x K masks
__host__ __device__ inline int buf_bytes(int M, int K) {
  return sp::align_up(TT * M * 8, 16) + sp::align_up(TT * K * 4, 16);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   sp::smem_u32(dst)),
               "l"(src)
               : "memory");
}

template <int K, int EPL>         // EPL: upper-triangle entries per lane
__global__ void __launch_bounds__(WARPS * 32)
masked_scm_kernel(const float* __restrict__ wta, const float2* __restrict__ x,
                  float2* __restrict__ out, int F, int T, int M, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = blockIdx.x * WARPS + warp;
  const int b = blockIdx.y;
  if (f >= F) return;                 // whole warp leaves together

  const int bb = buf_bytes(M, K);
  const int xb = sp::align_up(TT * M * 8, 16);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * MAX_STAGES;
  unsigned char* ring = smem + WARPS * MAX_STAGES * 8 + warp * stages * bb;

  const size_t row = (size_t)b * F + f;          // (b, f) frame row
  const float2* xr = x + row * T * M;
  const float* wr = wta + row * T * K;
  const int nbuf = (T + TT - 1) / TT;

  if (lane == 0) {
    for (int s = 0; s < stages; ++s) sp::mbar_init(sp::smem_u32(bars + s), 32);
    sp::fence_mbar_init();
  }
  __syncwarp();

  // frames [i * TT, ...) into buffer i % stages, in 16-byte copies where
  // the pair's rows and a buffer's bytes are 16-byte aligned in device
  // memory (as at the MVDR chunk), else 8 and 4; every lane arrives once
  const bool x16 = ((reinterpret_cast<uintptr_t>(xr) | (TT * M * 8)) % 16 ==
                    0);
  const bool w16 = ((reinterpret_cast<uintptr_t>(wr) | (TT * K * 4)) % 16 ==
                    0);
  auto issue = [&](int i) {
    unsigned char* buf = ring + (i % stages) * bb;
    const int t0 = i * TT, nt = min(TT, T - t0);
    unsigned char* sx = buf;
    unsigned char* sw = buf + xb;
    const unsigned char* gx =
        reinterpret_cast<const unsigned char*>(xr + (size_t)t0 * M);
    const unsigned char* gw =
        reinterpret_cast<const unsigned char*>(wr + (size_t)t0 * K);
    const int nxb = nt * M * 8, nwb = nt * K * 4;
    const int x0 = x16 ? nxb / 16 * 16 : 0, w0 = w16 ? nwb / 16 * 16 : 0;
    for (int e = lane * 16; e < x0; e += 32 * 16)
      sp::cp_async16(sx + e, gx + e);
    for (int e = x0 + lane * 8; e < nxb; e += 32 * 8)
      cp_async8(sx + e, gx + e);
    for (int e = lane * 16; e < w0; e += 32 * 16)
      sp::cp_async16(sw + e, gw + e);
    for (int e = w0 + lane * 4; e < nwb; e += 32 * 4)
      sp::cp_async4(sw + e, gw + e);
    sp::cp_async_arrive(sp::smem_u32(bars + i % stages));
  };
  for (int i = 0; i < min(stages, nbuf); ++i) issue(i);

  // this lane's upper-triangle entries (m <= n), row-major
  int em[EPL], en[EPL];
  bool ev[EPL];
  const int ne = M * (M + 1) / 2;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    int e = lane + 32 * j;
    ev[j] = e < ne;
    int m = 0;
    while (ev[j] && e >= M - m) {
      e -= M - m;
      ++m;
    }
    em[j] = m;
    en[j] = m + e;
  }

  // two sets of accumulators, even and odd frames, so that a frame's FMAs
  // do not wait on the previous frame's; summed at the end
  float ar[2][EPL][K], ai[2][EPL][K];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < EPL; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) ar[h][j][k] = ai[h][j][k] = 0.f;

  // frame t of a buffer into accumulator set h
  auto accumulate = [&](const float2* sx, const float* sw, int t, int h) {
    float w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = sw[t * K + k];
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      if (!ev[j]) continue;
      const float2 u = sx[t * M + em[j]];
      const float2 v = sx[t * M + en[j]];
      const float pr = fmaf(u.x, v.x, u.y * v.y);      // Re u conj(v)
      const float pi = fmaf(u.y, v.x, -(u.x * v.y));   // Im u conj(v)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ar[h][j][k] = fmaf(w[k], pr, ar[h][j][k]);
        ai[h][j][k] = fmaf(w[k], pi, ai[h][j][k]);
      }
    }
  };

  for (int i = 0; i < nbuf; ++i) {
    const unsigned char* buf = ring + (i % stages) * bb;
    const float2* sx = reinterpret_cast<const float2*>(buf);
    const float* sw = reinterpret_cast<const float*>(buf + xb);
    sp::mbar_wait(sp::smem_u32(bars + i % stages), (i / stages) & 1);
    const int nt = min(TT, T - i * TT);
    int t = 0;
    for (; t + 1 < nt; t += 2) {
      accumulate(sx, sw, t, 0);
      accumulate(sx, sw, t + 1, 1);
    }
    if (t < nt) accumulate(sx, sw, t, 0);
    __syncwarp();                     // every lane is done with the buffer
    if (i + stages < nbuf) issue(i + stages);
  }

#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    if (!ev[j]) continue;
    const int m = em[j], n = en[j];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float2* o = out + (((size_t)b * K + k) * F + f) * M * M;
      const float re = ar[0][j][k] + ar[1][j][k];
      const float im = ai[0][j][k] + ai[1][j][k];
      if (m == n) {
        o[m * M + m] = make_float2(re + 1e-15f, 0.f);
      } else {
        o[m * M + n] = make_float2(re, im);
        o[n * M + m] = make_float2(re, -im);
      }
    }
  }
}

template <int K>
int launch(const float* wta, const void* x, void* out, int B, int F, int T,
           int M, int stages, cudaStream_t st) {
  dim3 grid((F + WARPS - 1) / WARPS, B);
  const float2* xx = static_cast<const float2*>(x);
  float2* oo = static_cast<float2*>(out);
  const size_t smem =
      WARPS * MAX_STAGES * 8 + (size_t)WARPS * stages * buf_bytes(M, K);
  if (M * (M + 1) / 2 <= 32) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          masked_scm_kernel<K, 1>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    masked_scm_kernel<K, 1><<<grid, WARPS * 32, smem, st>>>(wta, xx, oo, F,
                                                            T, M, stages);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          masked_scm_kernel<K, 2>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    masked_scm_kernel<K, 2><<<grid, WARPS * 32, smem, st>>>(wta, xx, oo, F,
                                                            T, M, stages);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// wta [B, F, T, K] f32, x [B, F, T, M] complex64 as float2, out
// [B, K, F, M, M] complex64 as float2, all contiguous; 1 <= K <= 8,
// 1 <= M <= 8; stages the buffers of 32 frames each warp keeps in flight
// (1..8). Returns cudaGetLastError() of the launch.
extern "C" int masked_scm(const float* wta, const void* x, void* out, int B,
                          int F, int T, int K, int M, int stages,
                          void* stream) {
  if (B <= 0 || F <= 0 || T <= 0 || M < 1 || M > MAXM || stages < 1 ||
      stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
#define NT_SCM_CASE(KK) \
  case KK:              \
    return launch<KK>(wta, x, out, B, F, T, M, stages, st);
    NT_SCM_CASE(1) NT_SCM_CASE(2) NT_SCM_CASE(3) NT_SCM_CASE(4)
    NT_SCM_CASE(5) NT_SCM_CASE(6) NT_SCM_CASE(7) NT_SCM_CASE(8)
#undef NT_SCM_CASE
  }
  return (int)cudaErrorInvalidValue;
}
