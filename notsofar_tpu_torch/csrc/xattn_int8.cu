// xattn_int8: cross-attention of a few decode queries against int8 K/V
// memory (the int8 Whisper decoder's cross-attention at Tq <= 8).
//
// Replaces notsofar_tpu/ops/pallas_kernels.py::xattn_int8 (wrapper :108,
// pallas_call :130, body _xattn_int8_kernel :40-104). Same function: for
// each row b, head h and query t, f32 logits over dk of q_eff (bf16 in
// the serving model, f32 in the f32 parity model; the caller folded in the
// per-channel k scales and both dk**-0.25 factors) times the int8 keys;
// -1e30 for keys s >= s_valid; f32 max, exp and sum over the row;
// p = bf16(exp / sum) -- normalize, then round, as the TPU kernel does;
// out = (f32 sum_s p * v8) * v_scale[b, channel].
//
// What bounds it on an H100: bytes. Each (row, head) reads its s_valid
// int8 keys and values once (2 * s_valid * dk bytes) and does 4 * Tq * dk
// FLOP per key: ~2 Tq FLOP per byte, far below the ridge. Keys past
// s_valid (zero padding) are never read.
//
// Design. One block of 256 threads per (head, row): heads are addressed
// directly instead of the TPU kernel's 128-lane head groups, masked-lane
// dots and stacked [H*T, S] logit block (VMEM and MXU layout needs). An
// online (flash-decoding) softmax would round unnormalized weights, a
// different rounding point, so the whole logit block [Tq, S_pad] f32 stays
// in shared memory (48.1 KB at Tq 8, S_pad 1504: dynamic shared memory),
// beside the query tile, staged once as f32. Pass 1: a key's dk int8
// channels are dk/16 lanes' 16-byte loads, neighbouring lanes on
// neighbouring addresses (a warp covers 8 keys of dk 64 per load); each
// lane widens its 16 values to f32 and dots them with the Tq queries
// (16-byte shared loads, broadcast to the warp's keys); warp shuffles
// reduce the lanes of a key. Softmax: one warp per query row. Pass 2:
// each lane owns 8 channels of one key per step (8-byte loads) and
// accumulates Tq x 8 f32 sums over a strided key subset; the subsets are
// reduced by shuffles within a warp, then across warps in shared memory,
// and the v-scale is applied on the way out. No tensor cores and no copy
// pipelining yet.
#include "kernel_common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int CPL = 8;                   // channels per lane in pass 2

// byte i (0..3) of w as a signed int8, widened to f32 (exact)
__device__ __forceinline__ float sbyte(unsigned w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T, int DK, int TQ>
__global__ void __launch_bounds__(NTHREADS)
xattn_int8_kernel(const T* __restrict__ q,
                  const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ v8,
                  const float* __restrict__ vs, float* __restrict__ out,
                  int S_pad, int D, int s_valid) {
  constexpr int LPK = DK / 16;           // lanes per key in pass 1
  constexpr int KPW = 32 / LPK;          // keys per warp load in pass 1
  constexpr int LPV = DK / CPL;          // lanes per key in pass 2
  constexpr int VPW = 32 / LPV;          // keys per warp load in pass 2
  extern __shared__ float smem[];
  float* qs = smem;                      // [TQ][DK] queries in f32
  float* lg = qs + TQ * DK;              // [TQ][S_pad] logits, then weights
  float* red = lg + TQ * S_pad;          // [NWARPS][TQ][DK] partial outputs

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t mem = (size_t)b * S_pad * D + (size_t)h * DK;

  for (int e = threadIdx.x; e < TQ * DK; e += NTHREADS)
    qs[e] = to_f32(q[((size_t)b * TQ + e / DK) * D + h * DK + e % DK]);
  __syncthreads();

  // pass 1: logits of the s_valid keys; padding keys are masked, not read
  {
    const int sub = lane / LPK, c = lane % LPK;
    for (int s0 = warp * KPW; s0 < s_valid; s0 += NWARPS * KPW) {
      const int s = s0 + sub;
      float acc[TQ];
#pragma unroll
      for (int t = 0; t < TQ; ++t) acc[t] = 0.f;
      if (s < s_valid) {
        const int4 u = *reinterpret_cast<const int4*>(
            k8 + mem + (size_t)s * D + c * 16);
        const unsigned w[4] = {(unsigned)u.x, (unsigned)u.y, (unsigned)u.z,
                               (unsigned)u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float k0 = sbyte(w[j], 0), k1 = sbyte(w[j], 1);
          const float k2 = sbyte(w[j], 2), k3 = sbyte(w[j], 3);
#pragma unroll
          for (int t = 0; t < TQ; ++t) {
            const float4 qv =
                reinterpret_cast<const float4*>(qs + t * DK + c * 16)[j];
            acc[t] = fmaf(qv.x, k0, acc[t]);
            acc[t] = fmaf(qv.y, k1, acc[t]);
            acc[t] = fmaf(qv.z, k2, acc[t]);
            acc[t] = fmaf(qv.w, k3, acc[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < TQ; ++t) {
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          acc[t] += __shfl_xor_sync(nt::FULL_MASK, acc[t], off);
      }
      if (c == 0 && s < s_valid) {
#pragma unroll
        for (int t = 0; t < TQ; ++t) lg[t * S_pad + s] = acc[t];
      }
    }
    for (int s = s_valid + threadIdx.x; s < S_pad; s += NTHREADS) {
#pragma unroll
      for (int t = 0; t < TQ; ++t) lg[t * S_pad + s] = nt::MASKED;
    }
  }
  __syncthreads();

  // softmax, one warp per query row: max, exp, sum, then p = bf16(e / sum)
  if (warp < TQ) {
    float* row = lg + warp * S_pad;
    float m = -INFINITY;
    for (int s = lane; s < S_pad; s += 32) m = fmaxf(m, row[s]);
    m = nt::warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < S_pad; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    sum = nt::warp_sum(sum);
    for (int s = lane; s < S_pad; s += 32)
      row[s] = __bfloat162float(__float2bfloat16(row[s] / sum));
  }
  __syncthreads();

  // pass 2: p.v over the s_valid keys (padding keys have p = 0)
  {
    const int sub = lane / LPV, c = lane % LPV;
    float acc[TQ][CPL];
#pragma unroll
    for (int t = 0; t < TQ; ++t)
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[t][i] = 0.f;
    for (int s0 = warp * VPW; s0 < s_valid; s0 += NWARPS * VPW) {
      const int s = s0 + sub;
      if (s < s_valid) {
        const int2 u = *reinterpret_cast<const int2*>(
            v8 + mem + (size_t)s * D + c * CPL);
        float vv[CPL];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vv[i] = sbyte((unsigned)u.x, i);
          vv[4 + i] = sbyte((unsigned)u.y, i);
        }
#pragma unroll
        for (int t = 0; t < TQ; ++t) {
          const float p = lg[t * S_pad + s];
#pragma unroll
          for (int i = 0; i < CPL; ++i) acc[t][i] = fmaf(p, vv[i], acc[t][i]);
        }
      }
    }
    // the VPW key subsets of a warp share a channel slice: lanes c, c + LPV..
#pragma unroll
    for (int t = 0; t < TQ; ++t)
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int off = LPV; off < 32; off <<= 1)
          acc[t][i] += __shfl_xor_sync(nt::FULL_MASK, acc[t][i], off);
    if (sub == 0) {
#pragma unroll
      for (int t = 0; t < TQ; ++t)
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          red[(warp * TQ + t) * DK + c * CPL + i] = acc[t][i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TQ * DK; e += NTHREADS) {
    const int t = e / DK, d = e % DK;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += red[(w * TQ + t) * DK + d];
    out[((size_t)b * TQ + t) * D + h * DK + d] =
        o * vs[(size_t)b * D + h * DK + d];
  }
}

template <typename T, int DK, int TQ>
int launch(const void* q, const void* k8, const void* v8, const float* vs,
           float* out, int B, int S_pad, int D, int s_valid,
           cudaStream_t st) {
  const size_t smem = ((size_t)TQ * (DK + S_pad) + (size_t)NWARPS * TQ * DK)
                      * sizeof(float);
  // the opt-in above 48 KB is set once per instance and device, and raised
  // only when a larger S_pad arrives, not on every decode-step launch
  constexpr int MAX_DEVICES = 64;
  static size_t opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted_in[dev]) {
    e = cudaFuncSetAttribute(xattn_int8_kernel<T, DK, TQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = smem;
  }
  dim3 grid(D / DK, B);
  xattn_int8_kernel<T, DK, TQ><<<grid, NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), vs, out, S_pad, D, s_valid);
  return (int)cudaGetLastError();
}

template <typename T, int DK>
int launch_tq(int Tq, const void* q, const void* k8, const void* v8,
              const float* vs, float* out, int B, int S_pad, int D,
              int s_valid, cudaStream_t st) {
  switch (Tq) {
    case 1: return launch<T, DK, 1>(q, k8, v8, vs, out, B, S_pad, D, s_valid, st);
    case 2: return launch<T, DK, 2>(q, k8, v8, vs, out, B, S_pad, D, s_valid, st);
    case 3: return launch<T, DK, 3>(q, k8, v8, vs, out, B, S_pad, D, s_valid, st);
    case 4: return launch<T, DK, 4>(q, k8, v8, vs, out, B, S_pad, D, s_valid, st);
    case 5: return launch<T, DK, 5>(q, k8, v8, vs, out, B, S_pad, D, s_valid, st);
    case 6: return launch<T, DK, 6>(q, k8, v8, vs, out, B, S_pad, D, s_valid, st);
    case 7: return launch<T, DK, 7>(q, k8, v8, vs, out, B, S_pad, D, s_valid, st);
    case 8: return launch<T, DK, 8>(q, k8, v8, vs, out, B, S_pad, D, s_valid, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, Tq, D] (bf16 when is_bf16, else f32); k8, v8 [B, S_pad, D] int8;
// vs [B, D] f32; out [B, Tq, D] f32; all contiguous and 16-byte aligned.
// 1 <= Tq <= 8, dk in {64, 128}, D % dk == 0, 0 < s_valid <= S_pad.
// Returns cudaGetLastError() of the launch.
extern "C" int xattn_int8(const void* q, const void* k8, const void* v8,
                          const float* vs, float* out, int B, int Tq,
                          int S_pad, int D, int dk, int s_valid, int is_bf16,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dk == 64)
      return launch_tq<__nv_bfloat16, 64>(Tq, q, k8, v8, vs, out, B, S_pad,
                                          D, s_valid, st);
    if (dk == 128)
      return launch_tq<__nv_bfloat16, 128>(Tq, q, k8, v8, vs, out, B, S_pad,
                                           D, s_valid, st);
  } else {
    if (dk == 64)
      return launch_tq<float, 64>(Tq, q, k8, v8, vs, out, B, S_pad, D,
                                  s_valid, st);
    if (dk == 128)
      return launch_tq<float, 128>(Tq, q, k8, v8, vs, out, B, S_pad, D,
                                   s_valid, st);
  }
  return (int)cudaErrorInvalidValue;
}
