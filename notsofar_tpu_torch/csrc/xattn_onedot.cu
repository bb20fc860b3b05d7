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
// per key and channel). The first design gave each row one block of 512
// threads: 24 blocks at the tool's shape on 132 SMs, most of the card idle
// (0.2971 ms against a 0.0277 ms bound). Design: the split-softmax
// skeleton (split_softmax.cuh) over a row's keys. A row is a thread-block
// cluster of R <= 8 blocks along x, grid (R, B); block r owns the
// contiguous share of keys [r * ceil(s_valid / R), ...) and computes ALL H
// heads' logits on it ([H][share] f32 in shared memory; the row stride is
// odd so that the lanes of a value row, which read H rows at one column,
// hit distinct banks). Pass 1 walks the share's (key, head) pairs, which
// lie contiguous in memory at dk bytes each: dk/16 lanes' 16-byte loads
// per pair, reduced with shuffles. Every head's (max, sum) over the share
// is pushed to the peers over distributed shared memory and, after a
// cluster barrier, combined in rank order, so that every block normalizes
// with the same f32 statistics and rounds p = bf16(exp(s - m) / l). Pass 2
// gives each thread 8 channels (lane d taking head d % H's weights) and a
// subset of the share's keys (8-byte loads, a key row's 8-channel groups
// on neighbouring threads), the rounded products summed in f32; the key
// subsets are summed in shared memory, and the R partial [D] sums are
// pushed to the blocks owning each slice and summed there in rank order,
// times the v-scales. A thread issues 4 (pass 1, 16 bytes each) or 8
// (pass 2, 8 bytes each) independent loads before it uses them. Keys past
// s_valid (p = 0) are not read.
#include "split_softmax.cuh"

namespace cg = cooperative_groups;

namespace {

namespace sp = nt::split;

constexpr int NWARPS = 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int CPL = 8;                   // channels per thread in pass 2
constexpr int UNR1 = 4;                  // loads a thread issues before use,
constexpr int UNR2 = 8;                  // pass 1 and pass 2

// byte i (0..3) of w as a signed int8, widened to f32 (exact)
__device__ __forceinline__ float sbyte(unsigned w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

// shared memory of a block in floats: the query [D], logits -> weights
// [H][SP], the key subsets' partial outputs [KSUB][D], the peers' partial
// outputs of this block's slice [R][ceil(D / R)], then (8-byte aligned) the
// peers' stats [R][H] and the global stats [H] as float2
__host__ __device__ inline int stats_offset(int D, int H, int SP, int R) {
  const int KSUB = NTHREADS / (D / CPL);
  return sp::align_up(D + H * SP + KSUB * D + R * ((D + R - 1) / R), 2);
}
__host__ __device__ inline int smem_floats(int D, int H, int SP, int R) {
  return stats_offset(D, H, SP, R) + 2 * (R + 1) * H;
}

// two blocks a SM (<= 64 registers): the tool's 24 rows x 8 blocks all
// resident at once
template <int DK>
__global__ void __launch_bounds__(NTHREADS, 2)
xattn_onedot_kernel(const __nv_bfloat16* __restrict__ q,
                    const int8_t* __restrict__ k8,
                    const int8_t* __restrict__ v8,
                    const float* __restrict__ vs, float* __restrict__ out,
                    int S, int D, int s_valid, int SP) {
  constexpr int LPK = DK / 16;           // lanes per (key, head) in pass 1
  constexpr int KPW = 32 / LPK;          // (key, head) pairs per warp load
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int H = D / DK;
  const int NCG = D / CPL;               // 8-channel groups of a key row
  const int KSUB = NTHREADS / NCG;       // key subsets in pass 2
  const int slice = (D + R - 1) / R;
  extern __shared__ float smem[];
  float* qs = smem;                      // [D] query in f32
  float* lg = qs + D;                    // [H][SP] logits, then weights
  float* red = lg + H * SP;              // [KSUB][D] partial outputs
  float* recv = red + KSUB * D;          // [R][slice] peers' partials
  float2* peer = reinterpret_cast<float2*>(smem + stats_offset(D, H, SP,
                                                               R));  // [R][H]
  float2* gstat = peer + R * H;          // [H]

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const sp::Share sh = sp::share_of(s_valid, R, rank);
  const int len = sh.len;
  const size_t mem = ((size_t)b * S + sh.c0) * D;

  sp::cluster_arrive();
  for (int d = threadIdx.x; d < D; d += NTHREADS)
    qs[d] = __bfloat162float(q[(size_t)b * D + d]);
  __syncthreads();

  // pass 1: pair u = i * H + h is share key i's head-h slice, at byte u *
  // DK of the share
  {
    const int sub = lane / LPK, c = lane % LPK;
    const int n_pairs = len * H;
    for (int u0 = warp * KPW; u0 < n_pairs; u0 += NWARPS * KPW * UNR1) {
      int4 w4[UNR1];
#pragma unroll
      for (int r = 0; r < UNR1; ++r) {
        const int u = u0 + r * NWARPS * KPW + sub;
        w4[r] = u < n_pairs ? *reinterpret_cast<const int4*>(
                                  k8 + mem + (size_t)u * DK + c * 16)
                            : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int r = 0; r < UNR1; ++r) {
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
  }
  __syncthreads();

  // every head's (max, sum) over the share to the peers, combined in rank
  // order; then p = bf16(exp(s - m) / l) with the global statistics
  sp::cluster_wait();   // every peer has started: pushes may begin
  sp::push_stats<NTHREADS>(cluster, lg, SP, len, H, peer, R, rank);
  cluster.sync();
  sp::combine_stats<NTHREADS>(peer, gstat, H, R);
  for (int e = threadIdx.x; e < H * len; e += NTHREADS) {
    const int h = e / len, i = e % len;
    const float2 gs = gstat[h];
    lg[h * SP + i] = __bfloat162float(
        __float2bfloat16_rn(expf(lg[h * SP + i] - gs.x) / gs.y));
  }
  __syncthreads();

  // pass 2: lane d sums bf16(v[s, d] * p[d % H][s]) over its key subset
  const int cg8 = threadIdx.x % NCG, ks = threadIdx.x / NCG;
  if (ks < KSUB) {
    int hd[CPL];                          // weight row of each channel
#pragma unroll
    for (int i = 0; i < CPL; ++i) hd[i] = ((cg8 * CPL + i) % H) * SP;
    float acc[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
    for (int s0 = ks; s0 < len; s0 += KSUB * UNR2) {
      int2 u[UNR2];
#pragma unroll
      for (int r = 0; r < UNR2; ++r) {
        const int s = s0 + r * KSUB;
        u[r] = s < len ? *reinterpret_cast<const int2*>(
                             v8 + mem + (size_t)s * D + cg8 * CPL)
                       : make_int2(0, 0);
      }
#pragma unroll
      for (int r = 0; r < UNR2; ++r) {
        const int s = s0 + r * KSUB;
        if (s >= len) break;
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
    for (int i = 0; i < CPL; ++i) red[ks * D + cg8 * CPL + i] = acc[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NTHREADS) {
    float o = 0.f;
    for (int k = 0; k < KSUB; ++k) o += red[k * D + d];
    sp::push_partial(cluster, recv, d, o, slice, rank);
  }
  cluster.sync();
  sp::sum_received<NTHREADS>(recv, D, slice, R, rank, [&](int d, float o) {
    out[(size_t)b * D + d] = o * vs[(size_t)b * D + d];
  });
}

template <int DK>
int launch(const void* q, const void* k8, const void* v8, const float* vs,
           float* out, int B, int S, int D, int s_valid, int R,
           cudaStream_t st) {
  const int SP = ((s_valid + R - 1) / R) | 1;   // odd row stride >= share
  const size_t smem = (size_t)smem_floats(D, D / DK, SP, R) * sizeof(float);
  return sp::launch_cluster<xattn_onedot_kernel<DK>>(
      R, B, 1, NTHREADS, smem, st, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(k8), static_cast<const int8_t*>(v8), vs,
      out, S, D, s_valid, SP);
}

}  // namespace

// q [B, 1, D] bf16; k8, v8 [B, S, D] int8; vs [B, D] f32; out [B, 1, D]
// f32; all contiguous and 16-byte aligned. dk in {64, 128}, D % dk == 0,
// D <= 4096, 0 < s_valid <= S; R the cluster size (1..8). Returns
// cudaGetLastError() of the launch.
extern "C" int xattn_onedot(const void* q, const void* k8, const void* v8,
                            const float* vs, float* out, int B, int S, int D,
                            int dk, int s_valid, int R, void* stream) {
  if (D > CPL * NTHREADS || D % dk || R < 1 || R > sp::MAX_CLUSTER ||
      s_valid < 1 || s_valid > S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk == 64)
    return launch<64>(q, k8, v8, vs, out, B, S, D, s_valid, R, st);
  if (dk == 128)
    return launch<128>(q, k8, v8, vs, out, B, S, D, s_valid, R, st);
  return (int)cudaErrorInvalidValue;
}
