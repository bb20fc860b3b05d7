// encoder_mha: unmasked bidirectional attention for the Whisper encoder.
//
// Replaces notsofar_tpu/ops/pallas_kernels.py::encoder_mha (wrapper :573,
// pallas_call :603). Same function: q and k arrive pre-scaled by
// dk**-0.25 in the model dtype (bf16 when serving), logits and softmax
// are f32, the normalized weights are rounded to the value dtype
// (p.astype(v.dtype)), p.v accumulates in f32 and the output is rounded
// to the value dtype. Keys at or past S are masked with -1e30. bf16 runs
// on the tensor cores (below); f32 models, used for parity runs, take a
// plain f32 FMA kernel (encoder_mha_f32_kernel).
//
// What bounds it on an H100: operations. 4*S^2*dk FLOP per (batch, head)
// (two products) against 2*3*S*dk*2 bytes moved, i.e. ~S/3 = 500 FLOP per
// byte at S=1500 — above the card's ~295 FLOP/byte bf16 ridge, so the
// tensor cores, not HBM, are the limit (large-v3 encode, 3 windows:
// 34.6 GFLOP per layer, ~35 us at 989 TFLOP/s).
//
// Design. The TPU kernel keeps whole K and V rows resident in VMEM
// (2 x 192 KB at S_pad=1536); that does not fit a Hopper block's 227 KB
// of shared memory next to anything else, so keys are streamed through
// shared memory in 64-key tiles. To keep the TPU kernel's rounding points
// exactly (p normalized by the full row sum BEFORE its bf16 rounding) the
// kernel makes two passes over the keys: pass 1 computes each query row's
// max and sum exp (online), pass 2 recomputes the logits, forms the
// normalized p, rounds it to bf16 and accumulates p.v. That costs 1.5x
// the QK^T work of a one-pass online softmax — a later PR's trade.
// Products run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate): a block of 4 warps owns 64 query rows, 16 per warp; each
// head is addressed directly (no 128-lane head groups, which exist only
// for the TPU's (8, 128) tiling).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BLOCK_Q = NWARPS * 16;   // query rows per block
constexpr int BLOCK_K = 64;            // keys per shared-memory tile
constexpr int NT = BLOCK_K / 8;        // 8-key n-tiles per key tile
constexpr int PAD = 8;                 // smem row padding (bank spread)
constexpr float MASKED = -1e30f;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> packed bf16x2, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// K tile [BLOCK_K][DK] -> Ks (row-major, padded); keys >= S zero-filled
template <int DK>
__device__ __forceinline__ void load_k_tile(const __nv_bfloat16* kbh, int k0,
                                            int S,
                                            __nv_bfloat16 (*Ks)[DK + PAD]) {
  constexpr int CPR = DK / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < BLOCK_K * CPR; c += NTHREADS) {
    int r = c / CPR, col = (c % CPR) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (k0 + r < S)
      u = *reinterpret_cast<const uint4*>(kbh + (size_t)(k0 + r) * DK + col);
    *reinterpret_cast<uint4*>(&Ks[r][col]) = u;
  }
}

// V tile [BLOCK_K][DK] -> Vt transposed [DK][BLOCK_K] so the p.v product
// reads its B operand (keys contiguous per output dim) as 32-bit pairs
template <int DK>
__device__ __forceinline__ void load_v_tile(const __nv_bfloat16* vbh, int k0,
                                            int S,
                                            __nv_bfloat16 (*Vt)[BLOCK_K + PAD]) {
  constexpr int CPR = DK / 8;
  for (int c = threadIdx.x; c < BLOCK_K * CPR; c += NTHREADS) {
    int r = c / CPR, col = (c % CPR) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (k0 + r < S)
      u = *reinterpret_cast<const uint4*>(vbh + (size_t)(k0 + r) * DK + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) Vt[col + i][r] = e[i];
  }
}

// logits of this warp's 16 query rows against the tile's 64 keys;
// s[nt][0..1] -> row g, keys nt*8 + 2t, +1; s[nt][2..3] -> row g+8
template <int DK>
__device__ __forceinline__ void qk_tile(const uint32_t (&qa)[DK / 16][4],
                                        __nv_bfloat16 (*Ks)[DK + PAD], int k0,
                                        int S, int g, int t, float (&s)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const __nv_bfloat16* kr = &Ks[nt * 8 + g][kk * 16 + 2 * t];
      mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
    }
    int key = k0 + nt * 8 + 2 * t;
    if (key >= S) { s[nt][0] = MASKED; s[nt][2] = MASKED; }
    if (key + 1 >= S) { s[nt][1] = MASKED; s[nt][3] = MASKED; }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DK>
__global__ void __launch_bounds__(NTHREADS)
encoder_mha_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int S) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_K][DK + PAD];
  __shared__ __align__(16) __nv_bfloat16 Vt[DK][BLOCK_K + PAD];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma groupID, thread-in-group
  const int r0 = blockIdx.x * BLOCK_Q + warp * 16 + g, r1 = r0 + 8;
  const size_t base = (size_t)bh * S * DK;
  const __nv_bfloat16* qbh = q + base;
  const __nv_bfloat16* kbh = k + base;
  const __nv_bfloat16* vbh = v + base;

  // this warp's 16 query rows as mma A fragments, kept in registers
  uint32_t qa[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < S ? ld32(qbh + (size_t)r0 * DK + c) : 0u;
    qa[kk][1] = r1 < S ? ld32(qbh + (size_t)r1 * DK + c) : 0u;
    qa[kk][2] = r0 < S ? ld32(qbh + (size_t)r0 * DK + c + 8) : 0u;
    qa[kk][3] = r1 < S ? ld32(qbh + (size_t)r1 * DK + c + 8) : 0u;
  }

  // pass 1: row max and sum of exp (online over key tiles)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[NT][4];
  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();
    load_k_tile<DK>(kbh, k0, S, Ks);
    __syncthreads();
    qk_tile<DK>(qa, Ks, k0, S, g, t, s);
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      t0 = fmaxf(t0, fmaxf(s[nt][0], s[nt][1]));
      t1 = fmaxf(t1, fmaxf(s[nt][2], s[nt][3]));
    }
    float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
    l0 *= __expf(m0 - n0);
    l1 *= __expf(m1 - n1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      l0 += __expf(s[nt][0] - n0) + __expf(s[nt][1] - n0);
      l1 += __expf(s[nt][2] - n1) + __expf(s[nt][3] - n1);
    }
    m0 = n0;
    m1 = n1;
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // pass 2: normalized p (rounded to bf16) times V
  float acc[DK / 8][4];
#pragma unroll
  for (int d = 0; d < DK / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();
    load_k_tile<DK>(kbh, k0, S, Ks);
    load_v_tile<DK>(vbh, k0, S, Vt);
    __syncthreads();
    qk_tile<DK>(qa, Ks, k0, S, g, t, s);
#pragma unroll
    for (int kc = 0; kc < BLOCK_K / 16; ++kc) {
      // C fragments of n-tiles 2kc, 2kc+1 are the A fragment of keys
      // 16kc..16kc+15 (row g: a0, a2; row g+8: a1, a3)
      const float* lo = s[2 * kc];
      const float* hi = s[2 * kc + 1];
      uint32_t pa[4];
      pa[0] = pack_bf16(__expf(lo[0] - m0) / l0, __expf(lo[1] - m0) / l0);
      pa[1] = pack_bf16(__expf(lo[2] - m1) / l1, __expf(lo[3] - m1) / l1);
      pa[2] = pack_bf16(__expf(hi[0] - m0) / l0, __expf(hi[1] - m0) / l0);
      pa[3] = pack_bf16(__expf(hi[2] - m1) / l1, __expf(hi[3] - m1) / l1);
#pragma unroll
      for (int d = 0; d < DK / 8; ++d) {
        const __nv_bfloat16* vr = &Vt[d * 8 + g][kc * 16 + 2 * t];
        mma_bf16(acc[d], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // acc[d][0..1] -> row g, dims d*8 + 2t, +1; acc[d][2..3] -> row g+8
  __nv_bfloat16* obh = o + base;
#pragma unroll
  for (int d = 0; d < DK / 8; ++d) {
    int c = d * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(obh + (size_t)r0 * DK + c) =
          pack_bf16(acc[d][0], acc[d][1]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(obh + (size_t)r1 * DK + c) =
          pack_bf16(acc[d][2], acc[d][3]);
  }
}

// f32 models (parity runs): the same two passes in plain f32 FMAs, one
// query row per thread, keys and values staged through shared memory in
// tiles every thread of the block reads (broadcast). Softmax weights stay
// f32 (p.astype(v.dtype) is exact), as do the products and the output.
constexpr int F32_ROWS = 128;          // query rows (threads) per block
constexpr int F32_TILE = 32;           // keys per shared-memory tile

// rows k0.. of a [S, DK] f32 head -> tile (rows >= S zero-filled)
template <int DK>
__device__ __forceinline__ void load_f32_tile(const float* src, int k0, int S,
                                              float (*tile)[DK]) {
  for (int i = threadIdx.x; i < F32_TILE * DK; i += F32_ROWS) {
    const int r = i / DK, d = i % DK;
    tile[r][d] = k0 + r < S ? src[(size_t)(k0 + r) * DK + d] : 0.f;
  }
}

template <int DK>
__device__ __forceinline__ float dot_f32(const float (&a)[DK],
                                         const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DK; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

template <int DK>
__global__ void __launch_bounds__(F32_ROWS)
encoder_mha_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S) {
  __shared__ float Ks[F32_TILE][DK];
  __shared__ float Vs[F32_TILE][DK];
  const size_t base = (size_t)blockIdx.y * S * DK;
  const int row = blockIdx.x * F32_ROWS + threadIdx.x;
  const bool valid = row < S;
  float qr[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d)
    qr[d] = valid ? q[base + (size_t)row * DK + d] : 0.f;

  // pass 1: row max and sum of exp
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < S; k0 += F32_TILE) {
    __syncthreads();
    load_f32_tile<DK>(k + base, k0, S, Ks);
    __syncthreads();
    const int n = min(F32_TILE, S - k0);
    for (int r = 0; r < n; ++r) {
      const float s = dot_f32<DK>(qr, Ks[r]);
      const float mn = fmaxf(m, s);
      l = l * expf(m - mn) + expf(s - mn);
      m = mn;
    }
  }
  // pass 2: normalized p times V
  float acc[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < S; k0 += F32_TILE) {
    __syncthreads();
    load_f32_tile<DK>(k + base, k0, S, Ks);
    load_f32_tile<DK>(v + base, k0, S, Vs);
    __syncthreads();
    const int n = min(F32_TILE, S - k0);
    for (int r = 0; r < n; ++r) {
      const float p = expf(dot_f32<DK>(qr, Ks[r]) - m) / l;
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] = fmaf(p, Vs[r][d], acc[d]);
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < DK; ++d) o[base + (size_t)row * DK + d] = acc[d];
  }
}

}  // namespace

// q, k, v, o: [BH, S, dk], all bf16 when is_bf16 else all f32, contiguous.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int encoder_mha(const void* q, const void* k, const void* v,
                           void* o, int BH, int S, int dk, int is_bf16,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, BH);
    auto qp = static_cast<const __nv_bfloat16*>(q);
    auto kp = static_cast<const __nv_bfloat16*>(k);
    auto vp = static_cast<const __nv_bfloat16*>(v);
    auto op = static_cast<__nv_bfloat16*>(o);
    if (dk == 64)
      encoder_mha_kernel<64><<<grid, NTHREADS, 0, st>>>(qp, kp, vp, op, S);
    else if (dk == 128)
      encoder_mha_kernel<128><<<grid, NTHREADS, 0, st>>>(qp, kp, vp, op, S);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    dim3 grid((S + F32_ROWS - 1) / F32_ROWS, BH);
    auto qp = static_cast<const float*>(q);
    auto kp = static_cast<const float*>(k);
    auto vp = static_cast<const float*>(v);
    auto op = static_cast<float*>(o);
    if (dk == 64)
      encoder_mha_f32_kernel<64><<<grid, F32_ROWS, 0, st>>>(qp, kp, vp, op, S);
    else if (dk == 128)
      encoder_mha_f32_kernel<128><<<grid, F32_ROWS, 0, st>>>(qp, kp, vp, op, S);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
