// attn_step: single-token self-attention against a KV cache (one greedy
// or sampled Whisper decode step).
//
// Replaces notsofar_tpu/ops/pallas_kernels.py::attn_step (wrapper :224,
// pallas_call :262). Same function: q [B, 1, D] in the cache dtype with
// the full dk**-0.5 folded in; key s of row b is visible iff
// s <= pos and (s >= pad[b] or s == pos), others get -1e30; f32 softmax;
// weights rounded to the cache dtype; p.v accumulated in f32; f32 output.
//
// What bounds it on an H100: bytes. Each (row, head) reads its keys and
// values once and does 4*dk FLOP per key: ~1 FLOP per byte, far below the
// ridge. Keys past `pos` have weight exactly 0, so the kernel reads only
// keys 0..pos — the bytes this step needs, not the cache's width.
//
// Design. One block of 256 threads per (head, row): heads are addressed
// directly instead of the TPU kernel's 128-lane head groups. A key's dk
// channels are split over a few lanes, each reading 16 contiguous bytes
// (neighbouring lanes, neighbouring addresses), and reduced with warp
// shuffles; logits live in shared memory for the softmax; the p.v pass
// gives each thread a 16-byte channel slice and a strided subset of keys,
// then reduces the key groups through shared memory.
#include "kernel_common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

template <typename T, int DK>
__global__ void __launch_bounds__(NTHREADS)
attn_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pads,
                 float* __restrict__ out, int ctx, int D, int pos) {
  constexpr int VEC = nt::Vec<T>::N;     // elements per 16-byte load
  constexpr int LPK = DK / VEC;          // lanes per key
  constexpr int KPW = 32 / LPK;          // keys per warp pass
  constexpr int NG = NTHREADS / LPK;     // key groups in the p.v pass
  extern __shared__ float smem[];
  float* lg = smem;                      // [pos + 1] logits, then weights
  float* red = smem + ctx;               // [NG][DK] partial outputs
  __shared__ float wred[NWARPS];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nkeys = pos + 1;
  const int pad = pads[b];
  const size_t row = (size_t)b * ctx * D + (size_t)h * DK;

  // logits: LPK lanes per key, KPW keys per warp pass
  {
    const int sub = lane / LPK, c = lane % LPK;
    float qv[VEC];
    nt::load16(q + (size_t)b * D + h * DK + c * VEC, qv);
    for (int s0 = warp * KPW; s0 < nkeys; s0 += NWARPS * KPW) {
      const int s = s0 + sub;
      float acc = 0.f;
      if (s < nkeys) {
        float kv[VEC];
        nt::load16(k + row + (size_t)s * D + c * VEC, kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc = fmaf(qv[i], kv[i], acc);
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(nt::FULL_MASK, acc, off);
      if (c == 0 && s < nkeys)
        lg[s] = (s >= pad || s == pos) ? acc : nt::MASKED;
    }
  }
  __syncthreads();

  // softmax over keys 0..pos (later keys would contribute exp(-1e30) = 0)
  float m = -INFINITY;
  for (int s = threadIdx.x; s < nkeys; s += NTHREADS) m = fmaxf(m, lg[s]);
  m = nt::warp_max(m);
  if (lane == 0) wred[warp] = m;
  __syncthreads();
  m = wred[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, wred[w]);
  __syncthreads();
  float sum = 0.f;
  for (int s = threadIdx.x; s < nkeys; s += NTHREADS) {
    float e = expf(lg[s] - m);
    lg[s] = e;
    sum += e;
  }
  sum = nt::warp_sum(sum);
  if (lane == 0) wred[warp] = sum;
  __syncthreads();
  sum = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) sum += wred[w];
  for (int s = threadIdx.x; s < nkeys; s += NTHREADS)
    lg[s] = nt::round_as(lg[s] / sum, v);
  __syncthreads();

  // p.v: each thread owns one 16-byte channel slice over a key subset
  {
    const int c = threadIdx.x % LPK, grp = threadIdx.x / LPK;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int s = grp; s < nkeys; s += NG) {
      float vv[VEC];
      nt::load16(v + row + (size_t)s * D + c * VEC, vv);
      const float p = lg[s];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[grp * DK + c * VEC + i] = acc[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < DK; d += NTHREADS) {
    float o = 0.f;
    for (int grp = 0; grp < NG; ++grp) o += red[grp * DK + d];
    out[(size_t)b * D + h * DK + d] = o;
  }
}

template <typename T, int DK>
int launch(const void* q, const void* k, const void* v, const int* pads,
           float* out, int B, int ctx, int D, int pos, cudaStream_t st) {
  constexpr int NG = NTHREADS / (DK / nt::Vec<T>::N);
  size_t smem = (size_t)(ctx + NG * DK) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_step_kernel<T, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(D / DK, B);
  attn_step_kernel<T, DK><<<grid, NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pads, out, ctx, D, pos);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, 1, D]; k, v [B, ctx, D] (bf16 when is_bf16, else f32), contiguous;
// pads [B] int32; out [B, 1, D] f32. 0 <= pos < ctx. Returns
// cudaGetLastError() of the launch.
extern "C" int attn_step(const void* q, const void* k, const void* v,
                         const int* pads, float* out, int B, int ctx, int D,
                         int dk, int pos, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dk == 64) return launch<__nv_bfloat16, 64>(q, k, v, pads, out, B, ctx, D, pos, st);
    if (dk == 128) return launch<__nv_bfloat16, 128>(q, k, v, pads, out, B, ctx, D, pos, st);
  } else {
    if (dk == 64) return launch<float, 64>(q, k, v, pads, out, B, ctx, D, pos, st);
    if (dk == 128) return launch<float, 128>(q, k, v, pads, out, B, ctx, D, pos, st);
  }
  return (int)cudaErrorInvalidValue;
}
