// attn_step_split_bias: one beam-search decode step of self-attention
// over a split KV cache, with a general additive f32 bias in place of the
// (pad, gslot, ancestry) visibility -- the body of attn_step_split timed
// alone by tools/bisect_attn_split.py.
//
// Replaces tools/bisect_attn_split.py::kernel_only (:58, pallas_call :61),
// which calls notsofar_tpu/ops/pallas_kernels.py::_attn_step_split_kernel
// (:270-330) on the blocks attn_step_split passes it (:395-416). Same
// function: stream b's K beam queries q [B, K, D] (dk**-0.5 folded, cache
// dtype) attend over the stream's keys [kp[b] | kg[b]] (prompt rows, then
// the generated rows, [B, Pp, D] and [B, Ng, D]): per head, f32 logits
// plus bias[b, j, c] in f32, then the max, exp and sum in f32 over all
// Pp + Ng columns, weights normalized and rounded to the value dtype, p.v
// in f32; out [B, K, D] f32. A row whose every column is -1e30 has max
// -1e30 and exp(0) = 1 everywhere: the uniform average of the values, as
// the TPU kernel gives.
//
// What bounds it on an H100: bytes. Every key and value row of a stream is
// read once for its K beams (the bias says nothing about which columns
// matter, so all are read), with ~4*dk*K FLOP per row. Design:
// attn_step_split.cu's, with the visibility derived from pad, gslot and
// ancestry replaced by the stream's bias rows, copied into the logit block
// first (coalesced) so that each logit is added to its bias in shared
// memory, not after a device-memory load of its own (K dependent loads
// per key); one block of 512 threads per (head, stream); the K queries in shared
// memory; each key read by a few lanes (16 contiguous bytes each), dotted
// with all K queries and reduced with warp shuffles; the whole [K, ncol]
// logit block in shared memory, so the weights are normalized before they
// are rounded; one warp per beam row for the softmax; the p.v pass reads
// each value row once for all K beams.
#include "kernel_common.cuh"

namespace {

constexpr int NWARPS = 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXK = 8;   // beams per stream this kernel accepts

template <typename T, int DK>
__global__ void __launch_bounds__(NTHREADS)
attn_step_split_bias_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                            const T* __restrict__ vp, const T* __restrict__ kg,
                            const T* __restrict__ vg,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int K, int Pp, int Ng,
                            int D) {
  constexpr int VEC = nt::Vec<T>::N;
  constexpr int LPK = DK / VEC;
  constexpr int KPW = 32 / LPK;
  constexpr int NG = NTHREADS / LPK;
  const int ncol = Pp + Ng;               // prompt cols, then generated
  extern __shared__ float smem[];
  float* qs = smem;                       // [K][DK] queries
  float* lg = qs + K * DK;                // [K][ncol] logits -> weights
  float* red = lg + K * ncol;             // [NG][DK] partial outputs

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* brow = bias + (size_t)b * K * ncol;

  for (int i = threadIdx.x; i < K * DK; i += NTHREADS) {
    const int j = i / DK, d = i % DK;
    qs[i] = static_cast<float>(q[(size_t)(b * K + j) * D + h * DK + d]);
  }
  // the stream's bias rows start the logit block (coalesced, 4 loads in
  // flight per thread); each logit is then added to its bias in place
  const int nb = K * ncol;
  for (int i0 = threadIdx.x; i0 < nb; i0 += 4 * NTHREADS) {
    float b4[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r * NTHREADS;
      b4[r] = i < nb ? brow[i] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r * NTHREADS;
      if (i < nb) lg[i] = b4[r];
    }
  }
  __syncthreads();

  auto key_row = [&](const T* prompt, const T* gen, int col) -> const T* {
    if (col < Pp) return prompt + ((size_t)b * Pp + col) * D + h * DK;
    return gen + ((size_t)b * Ng + (col - Pp)) * D + h * DK;
  };

  // logits: each key read once, dotted with all K beam queries, plus bias
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
        if (c == 0 && col < ncol) lg[j * ncol + col] += acc;
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
           const void* vg, const float* bias, float* out, int B, int K,
           int Pp, int Ng, int D, cudaStream_t st) {
  constexpr int NG = NTHREADS / (DK / nt::Vec<T>::N);
  const size_t smem =
      ((size_t)K * DK + (size_t)K * (Pp + Ng) + (size_t)NG * DK) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_step_split_bias_kernel<T, DK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(D / DK, B);
  attn_step_split_bias_kernel<T, DK><<<grid, NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const T*>(kg),
      static_cast<const T*>(vg), bias, out, K, Pp, Ng, D);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, K, D]; kp, vp [B, Pp, D]; kg, vg [B, Ng, D] (bf16 when is_bf16,
// else f32), contiguous, 16-byte aligned; bias [B, K, Pp + Ng] f32; out
// [B, K, D] f32. 1 <= K <= 8, dk in {64, 128}, D % dk == 0,
// Pp + Ng >= 1. Returns cudaGetLastError() of the launch.
extern "C" int attn_step_split_bias(const void* q, const void* kp,
                                    const void* vp, const void* kg,
                                    const void* vg, const float* bias,
                                    float* out, int B, int K, int Pp, int Ng,
                                    int D, int dk, int is_bf16,
                                    void* stream) {
  if (K < 1 || K > MAXK || Pp + Ng < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dk == 64)
      return launch<__nv_bfloat16, 64>(q, kp, vp, kg, vg, bias, out, B, K, Pp, Ng, D, st);
    if (dk == 128)
      return launch<__nv_bfloat16, 128>(q, kp, vp, kg, vg, bias, out, B, K, Pp, Ng, D, st);
  } else {
    if (dk == 64)
      return launch<float, 64>(q, kp, vp, kg, vg, bias, out, B, K, Pp, Ng, D, st);
    if (dk == 128)
      return launch<float, 128>(q, kp, vp, kg, vg, bias, out, B, K, Pp, Ng, D, st);
  }
  return (int)cudaErrorInvalidValue;
}
