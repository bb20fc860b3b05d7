// Helpers shared by the decode-step attention kernels (attn_step.cu,
// attn_step_split.cu): 16-byte vector loads of bf16 or f32 rows into f32
// registers, and the rounding of softmax weights to the cache dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nt {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float MASKED = -1e30f;   // the JAX kernels' masked-logit value

// elements of T in one 16-byte load
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const float* p, float* out) {
  float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x;
  out[1] = u.y;
  out[2] = u.z;
  out[3] = u.w;
}

// softmax weights are cast to the value dtype before the p.v product
// (the Pallas kernels' p.astype(v.dtype))
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_as(float x, const float*) { return x; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

}  // namespace nt
