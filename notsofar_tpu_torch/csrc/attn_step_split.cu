// attn_step_split: one beam-search decode step of Whisper self-attention
// over a split KV cache.
//
// Replaces notsofar_tpu/ops/pallas_kernels.py::attn_step_split (wrapper
// :334, pallas_call :395). Same function: stream b's K beam queries
// (q [B*K, 1, D], dk**-0.5 folded, cache dtype) attend over the stream's
// prompt segment kp/vp [B, Pp, D] — shared by its K beams — and over the
// per-beam generated segments kg/vg [B*K, G, D]. Prompt column c is
// visible iff c >= pad[b]; generated column (j', s) is visible to beam j
// iff s <= gslot and j' == anc[b, j, s] (j' == j without anc). Masked
// logits are -1e30; f32 softmax; weights rounded to the cache dtype; p.v
// in f32; f32 output [B*K, 1, D].
//
// What bounds it on an H100: bytes. Every prompt key/value row is read
// ONCE per stream for all K beams and every generated row once, with
// ~4*dk*K FLOP per row. Generated slots past gslot have weight exactly 0
// for every beam, so only slots 0..gslot are read.
//
// Design. One block of 512 threads per (head, stream): with only
// B x H blocks in flight (40 at 2 streams), each block needs many warps
// of independent loads to keep memory busy. Visibility is derived in
// the kernel from pad, gslot and the stream's ancestry rows, which are
// staged in shared memory once; the [B, K, Pp+K*G] f32 bias the JAX
// wrapper builds in XLA is never materialized. The stream's K queries sit
// in shared memory; each physical key is read by a few lanes (16
// contiguous bytes each), dotted with all K queries and reduced with warp
// shuffles, so the K beams share one read of each key. The softmax runs
// per beam row (one warp per row), and the p.v pass reads each value row
// once for all K beams.
#include "kernel_common.cuh"

namespace {

constexpr int NWARPS = 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXK = 8;   // beams per stream this kernel accepts

template <typename T, int DK>
__global__ void __launch_bounds__(NTHREADS)
attn_step_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const T* __restrict__ kg,
                       const T* __restrict__ vg, const int* __restrict__ pads,
                       const int* __restrict__ anc, float* __restrict__ out,
                       int K, int Pp, int G, int D, int gslot) {
  constexpr int VEC = nt::Vec<T>::N;
  constexpr int LPK = DK / VEC;
  constexpr int KPW = 32 / LPK;
  constexpr int NG = NTHREADS / LPK;
  const int ng = gslot + 1;               // generated slots in use
  const int ncol = Pp + K * ng;           // prompt cols, then (j', s)
  extern __shared__ float smem[];
  float* qs = smem;                       // [K][DK] queries
  float* lg = qs + K * DK;                // [K][ncol] logits -> weights
  float* red = lg + K * ncol;             // [NG][DK] partial outputs
  int* owner = reinterpret_cast<int*>(red + NG * DK);   // [K][ng]

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pad = pads[b];

  for (int i = threadIdx.x; i < K * DK; i += NTHREADS) {
    const int j = i / DK, d = i % DK;
    qs[i] = static_cast<float>(q[(size_t)(b * K + j) * D + h * DK + d]);
  }
  // owner[j][s]: the physical beam row whose slot-s K/V is in beam j's
  // history (its own row without an ancestry matrix)
  for (int i = threadIdx.x; i < K * ng; i += NTHREADS) {
    const int j = i / ng, s = i % ng;
    owner[i] = anc ? anc[((size_t)b * K + j) * G + s] : j;
  }
  __syncthreads();

  // row of physical column `col` (prompt, or generated (j', s))
  auto key_row = [&](const T* prompt, const T* gen, int col) -> const T* {
    if (col < Pp) return prompt + ((size_t)b * Pp + col) * D + h * DK;
    const int r = col - Pp, jp = r / ng, s = r % ng;
    return gen + ((size_t)(b * K + jp) * G + s) * D + h * DK;
  };

  // logits: each key read once, dotted with all K beam queries
  {
    const int sub = lane / LPK, c = lane % LPK;
    for (int c0 = warp * KPW; c0 < ncol; c0 += NWARPS * KPW) {
      const int col = c0 + sub;
      float kv[VEC];
      if (col < ncol) {
        nt::load16(key_row(kp, kg, col) + c * VEC, kv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kv[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < MAXK; ++j) {
        if (j >= K) break;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc = fmaf(qs[j * DK + c * VEC + i], kv[i], acc);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(nt::FULL_MASK, acc, off);
        if (c == 0 && col < ncol) {
          bool vis;
          if (col < Pp) {
            vis = col >= pad;
          } else {
            const int r = col - Pp, jp = r / ng, s = r % ng;
            vis = jp == owner[j * ng + s];
          }
          lg[j * ncol + col] = vis ? acc : nt::MASKED;
        }
      }
    }
  }
  __syncthreads();

  // softmax per beam row, one warp per row
  for (int j = warp; j < K; j += NWARPS) {
    float* row = lg + j * ncol;
    float m = -INFINITY;
    for (int c = lane; c < ncol; c += 32) m = fmaxf(m, row[c]);
    m = nt::warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < ncol; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
    sum = nt::warp_sum(sum);
    for (int c = lane; c < ncol; c += 32) row[c] = nt::round_as(row[c] / sum, vp);
  }
  __syncthreads();

  // p.v: each value row read once for all K beams
  const int c = threadIdx.x % LPK, grp = threadIdx.x / LPK;
  float acc[MAXK][VEC];
#pragma unroll
  for (int j = 0; j < MAXK; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[j][i] = 0.f;
  for (int col = grp; col < ncol; col += NG) {
    float vv[VEC];
    nt::load16(key_row(vp, vg, col) + c * VEC, vv);
#pragma unroll
    for (int j = 0; j < MAXK; ++j) {
      if (j >= K) break;
      const float p = lg[j * ncol + col];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[j][i] = fmaf(p, vv[i], acc[j][i]);
    }
  }
  // reduce the key groups one beam at a time through shared memory
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    if (j >= K) break;
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[grp * DK + c * VEC + i] = acc[j][i];
    __syncthreads();
    for (int d = threadIdx.x; d < DK; d += NTHREADS) {
      float o = 0.f;
      for (int g2 = 0; g2 < NG; ++g2) o += red[g2 * DK + d];
      out[(size_t)(b * K + j) * D + h * DK + d] = o;
    }
    __syncthreads();
  }
}

template <typename T, int DK>
int launch(const void* q, const void* kp, const void* vp, const void* kg,
           const void* vg, const int* pads, const int* anc, float* out, int B,
           int K, int Pp, int G, int D, int gslot, cudaStream_t st) {
  constexpr int NG = NTHREADS / (DK / nt::Vec<T>::N);
  const int ncol = Pp + K * (gslot + 1);
  size_t smem = (size_t)(K * DK + K * ncol + NG * DK) * sizeof(float) +
                (size_t)K * (gslot + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_step_split_kernel<T, DK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(D / DK, B);
  attn_step_split_kernel<T, DK><<<grid, NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const T*>(kg),
      static_cast<const T*>(vg), pads, anc, out, K, Pp, G, D, gslot);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B*K, 1, D]; kp, vp [B, Pp, D]; kg, vg [B*K, G, D] (bf16 when is_bf16,
// else f32), contiguous; pads [B] int32; anc [B, K, G] int32 or NULL;
// out [B*K, 1, D] f32. 1 <= K <= 8, 0 <= gslot < G. Returns
// cudaGetLastError() of the launch.
extern "C" int attn_step_split(const void* q, const void* kp, const void* vp,
                               const void* kg, const void* vg, const int* pads,
                               const int* anc, float* out, int B, int K,
                               int Pp, int G, int D, int dk, int gslot,
                               int is_bf16, void* stream) {
  if (K < 1 || K > MAXK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dk == 64)
      return launch<__nv_bfloat16, 64>(q, kp, vp, kg, vg, pads, anc, out, B, K, Pp, G, D, gslot, st);
    if (dk == 128)
      return launch<__nv_bfloat16, 128>(q, kp, vp, kg, vg, pads, anc, out, B, K, Pp, G, D, gslot, st);
  } else {
    if (dk == 64)
      return launch<float, 64>(q, kp, vp, kg, vg, pads, anc, out, B, K, Pp, G, D, gslot, st);
    if (dk == 128)
      return launch<float, 128>(q, kp, vp, kg, vg, pads, anc, out, B, K, Pp, G, D, gslot, st);
  }
  return (int)cudaErrorInvalidValue;
}
