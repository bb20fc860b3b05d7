// xattn_onedot: the "one-matmul" variant of the int8 cross-attention
// that tools/bench_xattn_variants.py times, at one decode query per row.
//
// Replaces tools/bench_xattn_variants.py::onedot (wrapper :96, pallas_call
// :105, body _onedot_kernel :75-94). Same function: for row b and head h,
// f32 logits over dk of q (bf16) times the int8 keys (the TPU kernel dots
// all heads at once against a head-masked [D, H] query; masked lanes add
// exact zeros, so addressing heads directly is the same function); -1e30
// for keys s >= s_valid; f32 max, exp and sum; p[h] = bf16(exp / sum)
// (normalize, then round). The value pass takes pe = pltpu.repeat(p, dk,
// 1), which TILES the [S, H] weights along the lanes: lane d gets head
// d % H's weights, not head d / dk's, so the result is not xattn_int8's
// attention. Each product is rounded to bf16, as (v.astype(bf16) *
// pe).astype(f32) writes it: out[d] = (f32 sum_s bf16(v8[s, d] *
// p[d % H][s])) * v_scale[d]. A product of an int8 value and a bf16 weight
// is exact in f32, so bf16(v * p) is one rounding of an exact value; the
// product is formed with __fmul_rn so that the compiler cannot contract it
// into the sum.
//
// What bounds it on an H100: bytes (2 * s_valid * D int8 per row, 4 FLOP
// per key and channel). Design: every lane of a row needs the weights of
// every head, so one block of 512 threads per row computes all H softmax
// rows into shared memory ([H][S] f32, 120 KB at S 1504, H 20; the row
// stride is odd so that the lanes of a value row, which read H rows at one
// column, hit distinct banks). Pass 1 walks the row's (key, head) pairs,
// which lie contiguous in memory at dk bytes each: dk/16 lanes' 16-byte
// loads per pair, reduced with shuffles. Pass 2 gives each thread 8
// channels and a subset of the keys (8-byte loads, a key row's 8-channel
// groups on neighbouring threads), then the key subsets are summed in
// shared memory. In both passes a thread issues 4 independent loads
// before it uses them, so that one block keeps enough bytes in flight.
// Keys past s_valid (p = 0) are not read. One block per row (24 at the
// tool's shape) leaves most SMs idle: a first kernel.
#include "kernel_common.cuh"

namespace {

constexpr int NWARPS = 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int CPL = 8;                   // channels per thread in pass 2
constexpr int UNR = 4;                   // loads a thread issues before use

// byte i (0..3) of w as a signed int8, widened to f32 (exact)
__device__ __forceinline__ float sbyte(unsigned w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

template <int DK>
__global__ void __launch_bounds__(NTHREADS)
xattn_onedot_kernel(const __nv_bfloat16* __restrict__ q,
                    const int8_t* __restrict__ k8,
                    const int8_t* __restrict__ v8,
                    const float* __restrict__ vs, float* __restrict__ out,
                    int S, int D, int s_valid) {
  constexpr int LPK = DK / 16;           // lanes per (key, head) in pass 1
  constexpr int KPW = 32 / LPK;          // (key, head) pairs per warp load
  const int H = D / DK;
  const int SP = S | 1;                  // odd row stride of the weights
  const int NCG = D / CPL;               // 8-channel groups of a key row
  const int KSUB = NTHREADS / NCG;       // key subsets in pass 2
  extern __shared__ float smem[];
  float* qs = smem;                      // [D] query in f32
  float* lg = qs + D;                    // [H][SP] logits, then weights
  float* red = lg + H * SP;              // [KSUB][D] partial outputs

  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t mem = (size_t)b * S * D;

  for (int d = threadIdx.x; d < D; d += NTHREADS)
    qs[d] = __bfloat162float(q[(size_t)b * D + d]);
  __syncthreads();

  // pass 1: pair u = s * H + h is key s's head-h slice, at byte u * DK of
  // the row; pairs of keys past s_valid are masked, not read
  {
    const int sub = lane / LPK, c = lane % LPK;
    const int n_pairs = s_valid * H;
    for (int u0 = warp * KPW; u0 < n_pairs; u0 += NWARPS * KPW * UNR) {
      int4 w4[UNR];
#pragma unroll
      for (int r = 0; r < UNR; ++r) {
        const int u = u0 + r * NWARPS * KPW + sub;
        w4[r] = u < n_pairs ? *reinterpret_cast<const int4*>(
                                  k8 + mem + (size_t)u * DK + c * 16)
                            : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int r = 0; r < UNR; ++r) {
        const int u = u0 + r * NWARPS * KPW + sub;
        const int h = u % H;
        const unsigned w[4] = {(unsigned)w4[r].x, (unsigned)w4[r].y,
                               (unsigned)w4[r].z, (unsigned)w4[r].w};
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qv =
              reinterpret_cast<const float4*>(qs + h * DK + c * 16)[j];
          acc = fmaf(qv.x, sbyte(w[j], 0), acc);
          acc = fmaf(qv.y, sbyte(w[j], 1), acc);
          acc = fmaf(qv.z, sbyte(w[j], 2), acc);
          acc = fmaf(qv.w, sbyte(w[j], 3), acc);
        }
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(nt::FULL_MASK, acc, off);
        if (c == 0 && u < n_pairs) lg[h * SP + u / H] = acc;
      }
    }
    for (int i = threadIdx.x; i < H * (S - s_valid); i += NTHREADS)
      lg[(i / (S - s_valid)) * SP + s_valid + i % (S - s_valid)] = nt::MASKED;
  }
  __syncthreads();

  // softmax per head row, one warp per row: p = bf16(e / sum)
  for (int h = warp; h < H; h += NWARPS) {
    float* row = lg + h * SP;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
    m = nt::warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    sum = nt::warp_sum(sum);
    for (int s = lane; s < S; s += 32)
      row[s] = __bfloat162float(__float2bfloat16_rn(row[s] / sum));
  }
  __syncthreads();

  // pass 2: lane d sums bf16(v[s, d] * p[d % H][s]) over its key subset
  const int cg = threadIdx.x % NCG, ks = threadIdx.x / NCG;
  if (ks < KSUB) {
    int hd[CPL];                          // weight row of each channel
#pragma unroll
    for (int i = 0; i < CPL; ++i) hd[i] = ((cg * CPL + i) % H) * SP;
    float acc[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
    for (int s0 = ks; s0 < s_valid; s0 += KSUB * UNR) {
      int2 u[UNR];
#pragma unroll
      for (int r = 0; r < UNR; ++r) {
        const int s = s0 + r * KSUB;
        u[r] = s < s_valid ? *reinterpret_cast<const int2*>(
                                 v8 + mem + (size_t)s * D + cg * CPL)
                           : make_int2(0, 0);
      }
#pragma unroll
      for (int r = 0; r < UNR; ++r) {
        const int s = s0 + r * KSUB;
        if (s >= s_valid) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i] += __bfloat162float(__float2bfloat16_rn(
              __fmul_rn(sbyte((unsigned)u[r].x, i), lg[hd[i] + s])));
          acc[4 + i] += __bfloat162float(__float2bfloat16_rn(
              __fmul_rn(sbyte((unsigned)u[r].y, i), lg[hd[4 + i] + s])));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) red[ks * D + cg * CPL + i] = acc[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NTHREADS) {
    float o = 0.f;
    for (int k = 0; k < KSUB; ++k) o += red[k * D + d];
    out[(size_t)b * D + d] = o * vs[(size_t)b * D + d];
  }
}

template <int DK>
int launch(const void* q, const void* k8, const void* v8, const float* vs,
           float* out, int B, int S, int D, int s_valid, cudaStream_t st) {
  const int H = D / DK, KSUB = NTHREADS / (D / CPL);
  const size_t smem =
      ((size_t)D + (size_t)H * (S | 1) + (size_t)KSUB * D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        xattn_onedot_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  xattn_onedot_kernel<DK><<<B, NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), vs, out, S, D, s_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, 1, D] bf16; k8, v8 [B, S, D] int8; vs [B, D] f32; out [B, 1, D]
// f32; all contiguous and 16-byte aligned. dk in {64, 128}, D % dk == 0,
// D <= 4096, 0 < s_valid <= S. Returns cudaGetLastError() of the launch.
extern "C" int xattn_onedot(const void* q, const void* k8, const void* v8,
                            const float* vs, float* out, int B, int S, int D,
                            int dk, int s_valid, void* stream) {
  if (D > CPL * NTHREADS || D % dk) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk == 64) return launch<64>(q, k8, v8, vs, out, B, S, D, s_valid, st);
  if (dk == 128) return launch<128>(q, k8, v8, vs, out, B, S, D, s_valid, st);
  return (int)cudaErrorInvalidValue;
}
