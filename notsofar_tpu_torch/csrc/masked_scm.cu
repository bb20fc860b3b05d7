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
// per byte read at M = 7, K = 4, far under the f32 FMA rate per byte.
//
// Design. The TPU grid (B, K, F/32) reads each x tile K times and keeps
// real and imaginary planes apart (a VMEM layout need, with F padded to
// the block). Here one warp owns one (b, f) pair and all K masks: it
// stages its frames' x and wta in shared memory, 32 frames at a time, with
// coalesced loads straight from the engine's layout (no transposes, no
// padding), and each lane owns one entry (m <= n) of the upper triangle
// (28 of 32 lanes at M = 7; a second entry per lane for M = 8). Per frame
// a lane forms its entry of x x^H once and adds it, weighted by each of
// the K masks, into K complex f32 accumulators (plain f32 FMAs, no tensor
// cores). The lane then writes its entry and, off the diagonal, the
// conjugate into the lower triangle; diagonal imaginary parts are exactly
// zero. Four warps (four frequencies) share a block. The kernel is
// instantiated per K and per entries-per-lane, so the accumulators are
// exactly 2 * K * EPL registers and the loops carry no guards.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;          // frequencies per block
constexpr int TT = 32;            // frames staged per step
constexpr int MAXM = 8;

template <int K, int EPL>         // EPL: upper-triangle entries per lane
__global__ void __launch_bounds__(WARPS * 32)
masked_scm_kernel(const float* __restrict__ wta, const float2* __restrict__ x,
                  float2* __restrict__ out, int F, int T, int M) {
  __shared__ float2 sx[WARPS][TT * MAXM];
  __shared__ __align__(16) float sw[WARPS][TT * K];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = blockIdx.x * WARPS + warp;
  const int b = blockIdx.y;
  if (f >= F) return;                 // whole warp leaves together

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

  float ar[EPL][K], ai[EPL][K];
#pragma unroll
  for (int j = 0; j < EPL; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) ar[j][k] = ai[j][k] = 0.f;

  const size_t row = (size_t)b * F + f;          // (b, f) frame row
  const float2* xr = x + row * T * M;
  const float* wr = wta + row * T * K;
  float2* sxw = sx[warp];
  float* sww = sw[warp];

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int nt = min(TT, T - t0);
    for (int i = lane; i < nt * M; i += 32) sxw[i] = xr[(size_t)t0 * M + i];
    for (int i = lane; i < nt * K; i += 32) sww[i] = wr[(size_t)t0 * K + i];
    __syncwarp();
#pragma unroll 2
    for (int t = 0; t < nt; ++t) {
      float w[K];
#pragma unroll
      for (int k = 0; k < K; ++k) w[k] = sww[t * K + k];
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        if (!ev[j]) continue;
        const float2 u = sxw[t * M + em[j]];
        const float2 v = sxw[t * M + en[j]];
        const float pr = fmaf(u.x, v.x, u.y * v.y);      // Re u conj(v)
        const float pi = fmaf(u.y, v.x, -(u.x * v.y));   // Im u conj(v)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          ar[j][k] = fmaf(w[k], pr, ar[j][k]);
          ai[j][k] = fmaf(w[k], pi, ai[j][k]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    if (!ev[j]) continue;
    const int m = em[j], n = en[j];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float2* o = out + (((size_t)b * K + k) * F + f) * M * M;
      if (m == n) {
        o[m * M + m] = make_float2(ar[j][k] + 1e-15f, 0.f);
      } else {
        o[m * M + n] = make_float2(ar[j][k], ai[j][k]);
        o[n * M + m] = make_float2(ar[j][k], -ai[j][k]);
      }
    }
  }
}

template <int K>
int launch(const float* wta, const void* x, void* out, int B, int F, int T,
           int M, cudaStream_t st) {
  dim3 grid((F + WARPS - 1) / WARPS, B);
  const float2* xx = static_cast<const float2*>(x);
  float2* oo = static_cast<float2*>(out);
  if (M * (M + 1) / 2 <= 32)
    masked_scm_kernel<K, 1><<<grid, WARPS * 32, 0, st>>>(wta, xx, oo, F, T, M);
  else
    masked_scm_kernel<K, 2><<<grid, WARPS * 32, 0, st>>>(wta, xx, oo, F, T, M);
  return (int)cudaGetLastError();
}

}  // namespace

// wta [B, F, T, K] f32, x [B, F, T, M] complex64 as float2, out
// [B, K, F, M, M] complex64 as float2, all contiguous; 1 <= K <= 8,
// 1 <= M <= 8. Returns cudaGetLastError() of the launch.
extern "C" int masked_scm(const float* wta, const void* x, void* out, int B,
                          int F, int T, int K, int M, void* stream) {
  if (B <= 0 || F <= 0 || T <= 0 || M < 1 || M > MAXM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
#define NT_SCM_CASE(KK) \
  case KK:              \
    return launch<KK>(wta, x, out, B, F, T, M, st);
    NT_SCM_CASE(1) NT_SCM_CASE(2) NT_SCM_CASE(3) NT_SCM_CASE(4)
    NT_SCM_CASE(5) NT_SCM_CASE(6) NT_SCM_CASE(7) NT_SCM_CASE(8)
#undef NT_SCM_CASE
  }
  return (int)cudaErrorInvalidValue;
}
