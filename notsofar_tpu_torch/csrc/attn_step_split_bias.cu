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
// the TPU kernel gives. Any K, as the TPU kernel takes.
//
// What bounds it on an H100: bytes. Every key and value row of a stream is
// read once for its K beams (the bias says nothing about which columns
// matter, so all are read), with ~4*dk*K FLOP per row.
//
// Design (split_softmax.cuh). A (head, stream) pair is a thread-block
// cluster of R <= 8 blocks along x (grid (R, H, B), R from
// attn_step_split_bias_launch). Block r owns a contiguous share of the
// Pp + Ng columns. Its first instructions put the queries and the stream's
// bias share [K, share] (4-byte copies into the logit block), the share's
// key rows (one mbarrier per 32 rows; each also covers the queries and the
// bias) and its value rows (one mbarrier) in flight into shared memory.
// bf16 caches run on the tensor cores (mma.sync m16n8k16, f32
// accumulation): logits with a warp taking 16 columns at a time as they
// land, 8 beams a tile, each added to its bias; p.v with the weights as A
// (16 beams a tile) and the value rows as B through ldmatrix.trans, each
// warp its own channels. f32 caches (the parity path) use f32 FMAs: one
// thread per column for the logits, 8 beams at a time through registers;
// 4 channels of a value row per thread for p.v. Each block pushes its
// share's per-beam max and sum to its peers; after a cluster barrier every
// block combines the R pairs in rank order, forms p = round(exp(s - m) /
// l) from its stored logits with the global m and l (the TPU kernel's
// rounding point) and its share's p.v in f32, and pushes its partial
// [K, dk] output to the blocks that own its slices; after a second
// barrier each sums its slice over the R blocks in rank order. Per-beam
// state lives in shared memory sized by K (no beam limit; the wrapper
// raises where a block would pass 227 KB).
#include <type_traits>

#include "split_softmax.cuh"

namespace cg = cooperative_groups;

namespace {

namespace sp = nt::split;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int JG = 8;   // beams per register group (f32 path)

// byte offsets of one block's shared memory: mbarriers (values, then one
// per 32 key rows), the queries [K][DK], key rows [per][DK] and value rows
// [per][DK] in the cache dtype (esize bytes), bias -> logits -> weights
// [K][per] f32, the bf16 path's bf16 weights [align(K, 16)][per + 8] or
// the f32 path's warps' partial outputs [NWARPS][JG][DK], the peers'
// partial outputs of this block's slice [R][ceil(K * DK / R)], the peers'
// stats [R][K], global stats [K]
struct Layout {
  int bars, qrows, ks, vs, lg, pb, red, recv, peer, gstat, bytes;
};

__host__ __device__ inline Layout layout(int per, int dk, int esize, int K,
                                         int R) {
  Layout L;
  int o = 0;
  L.bars = o;
  o += sp::align_up(8 * (1 + (per + sp::CH - 1) / sp::CH), 128);
  L.qrows = o;
  o += K * dk * esize;
  L.ks = o;
  o += per * dk * esize;
  L.vs = o;
  o += per * dk * esize;
  L.lg = o;
  o += K * per * 4;
  L.pb = L.red = o;
  o += esize == 2 ? sp::align_up(K, 16) * (per + 8) * 2
                  : NWARPS * JG * dk * 4;
  L.recv = o;
  o += sp::align_up(R * ((K * dk + R - 1) / R) * 4, 16);
  L.peer = o;
  o += 8 * R * K;
  L.gstat = o;
  o += 8 * K;
  L.bytes = o;
  return L;
}

// two bf16 B fragments (keys 0-7 and 8-15 of a k-step, 8 channels) of the
// value rows, transposed by ldmatrix; lanes 0-15 give the rows' addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr, uint32_t& b0,
                                                  uint32_t& b1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

template <typename T, int DK>
__global__ void __launch_bounds__(NTHREADS, 2)
attn_step_split_bias_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                            const T* __restrict__ vp, const T* __restrict__ kg,
                            const T* __restrict__ vg,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int K, int Pp, int Ng,
                            int D, int per) {
  constexpr int RB = DK * (int)sizeof(T);   // bytes of a row
  constexpr int PPR = RB / 16;              // its 16-byte pieces
  constexpr int KS = DK / 16;               // mma k-steps over the channels
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;   // mma fragment coordinates
  const int ncol = Pp + Ng;                // prompt cols, then generated
  const sp::Share sh = sp::share_of(ncol, R, rank);
  const int c0 = sh.c0, len = sh.len;
  const int nck = (len + sp::CH - 1) / sp::CH;
  const int len16 = (len + 15) / 16 * 16;
  const int nout = K * DK, slice = (nout + R - 1) / R;

  const Layout L = layout(per, DK, (int)sizeof(T), K, R);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const unsigned char* sq = smem + L.qrows;
  unsigned char* ks = smem + L.ks;
  unsigned char* vsm = smem + L.vs;
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(smem + L.pb);
  const int ps = per + 8;                  // pb row stride (8 mod 16)
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  float2* peer = reinterpret_cast<float2*>(smem + L.peer);
  float2* gstat = reinterpret_cast<float2*>(smem + L.gstat);
  auto bar = [&](int i) { return sp::smem_u32(bars + i); };   // 0: values

  auto row = [&](const T* prompt, const T* gen, int i) -> const T* {
    const int col = c0 + i;
    if (col < Pp) return prompt + ((size_t)b * Pp + col) * D + h * DK;
    return gen + ((size_t)b * Ng + (col - Pp)) * D + h * DK;
  };

  // the queries, the bias share, the key rows and the value rows in flight
  // before anything else
  if (tid == 0) {
    for (int i = 0; i <= nck; ++i) sp::mbar_init(bar(i), NTHREADS);
    sp::fence_mbar_init();
  }
  if constexpr (TC) {
    // the tensor cores' value tiles run to a multiple of 16 rows: zeros
    // past len (rows no copy writes)
    for (int e = tid; e < (len16 - len) * RB / 16; e += NTHREADS)
      reinterpret_cast<uint4*>(vsm + len * RB)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  sp::cluster_arrive();
  if (len > 0) {
    sp::stage_rows<NTHREADS, false>(smem + L.qrows, RB, 0, K, [&](int j) {
      return q + (size_t)(b * K + j) * D + h * DK;
    });
    const float* brow = bias + (size_t)b * K * ncol + c0;
    for (int idx = tid; idx < K * len; idx += NTHREADS) {
      const int j = idx / len, i = idx - j * len;
      sp::cp_async4(lg + j * per + i, brow + (size_t)j * ncol + i);
    }
  }
  for (int c = 0; c < nck; ++c) {
    sp::stage_rows<NTHREADS, true>(ks, RB, c * sp::CH,
                                   min(len, (c + 1) * sp::CH),
                                   [&](int r) { return row(kp, kg, r); });
    sp::cp_async_arrive(bar(1 + c));
  }
  sp::stage_rows<NTHREADS, true>(vsm, RB, 0, len,
                                 [&](int r) { return row(vp, vg, r); });
  sp::cp_async_arrive(bar(0));

  // logits plus bias
  if constexpr (TC) {
    // a warp takes 16 columns (rows g and g + 8 of the tile) at a time;
    // lane c4's DK/4 channels of a row are DK/2 contiguous bytes: word w
    // holds channels c4 * DK/4 + 2w, + 1
    constexpr int NP = DK / 32;              // pieces of a lane's slice
    const int nqt = (K + 7) / 8;
    for (int mt = warp; mt * 16 < len; mt += NWARPS) {
      sp::mbar_wait(bar(1 + mt * 16 / sp::CH), 0);
      const int i0 = mt * 16 + g, i1 = i0 + 8;
      uint32_t w0[2 * KS], w1[2 * KS];
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        uint4 u0 = make_uint4(0u, 0u, 0u, 0u), u1 = u0;
        if (i0 < len)
          u0 = *reinterpret_cast<const uint4*>(
              ks + i0 * RB + sp::slot(i0, c4 * NP + pc, PPR) * 16);
        if (i1 < len)
          u1 = *reinterpret_cast<const uint4*>(
              ks + i1 * RB + sp::slot(i1, c4 * NP + pc, PPR) * 16);
        w0[4 * pc] = u0.x, w0[4 * pc + 1] = u0.y, w0[4 * pc + 2] = u0.z,
        w0[4 * pc + 3] = u0.w;
        w1[4 * pc] = u1.x, w1[4 * pc + 1] = u1.y, w1[4 * pc + 2] = u1.z,
        w1[4 * pc + 3] = u1.w;
      }
      for (int nt = 0; nt < nqt; ++nt) {
        // the queries as B fragments: lane (g, c4) holds beam 8nt + g's
        // channels c4 * DK/4 + 4s .. + 3 for k-step s
        const int jq = nt * 8 + g;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          uint2 qv = make_uint2(0u, 0u);
          if (jq < K)
            qv = *reinterpret_cast<const uint2*>(sq + jq * RB +
                                                 (c4 * (DK / 4) + 4 * s) * 2);
          sp::mma_bf16(d, w0[2 * s], w1[2 * s], w0[2 * s + 1], w1[2 * s + 1],
                       qv.x, qv.y);
        }
        // d: (column i0, beam 8nt + 2c4), (i0, +1), (i1, 2c4), (i1, +1)
        const int j0 = nt * 8 + 2 * c4;
        if (j0 < K) {
          if (i0 < len) lg[j0 * per + i0] += d[0];
          if (i1 < len) lg[j0 * per + i1] += d[2];
        }
        if (j0 + 1 < K) {
          if (i0 < len) lg[(j0 + 1) * per + i0] += d[1];
          if (i1 < len) lg[(j0 + 1) * per + i1] += d[3];
        }
      }
    }
  } else {
    const float* qs = reinterpret_cast<const float*>(sq);
    // one thread per column, its key row dotted with all K queries (JG at
    // a time)
    for (int i = tid; i < len; i += NTHREADS) {
      sp::mbar_wait(bar(1 + i / sp::CH), 0);
      for (int j0 = 0; j0 < K; j0 += JG) {
        float acc[JG];
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) acc[jj] = 0.f;
#pragma unroll
        for (int k = 0; k < PPR; ++k) {
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + i * RB + sp::slot(i, k, PPR) * 16);
#pragma unroll
          for (int jj = 0; jj < JG; ++jj) {
            if (j0 + jj < K) {
              // the same address in every lane
              const float4 qv =
                  reinterpret_cast<const float4*>(qs + (j0 + jj) * DK)[k];
              acc[jj] = fmaf(qv.x, kv.x, acc[jj]);
              acc[jj] = fmaf(qv.y, kv.y, acc[jj]);
              acc[jj] = fmaf(qv.z, kv.z, acc[jj]);
              acc[jj] = fmaf(qv.w, kv.w, acc[jj]);
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < JG; ++jj)
          if (j0 + jj < K) lg[(j0 + jj) * per + i] += acc[jj];
      }
    }
  }
  __syncthreads();

  sp::cluster_wait();   // every peer has started: pushes may begin
  sp::push_stats<NTHREADS>(cluster, lg, per, len, K, peer, R, rank);
  cluster.sync();
  sp::combine_stats<NTHREADS>(peer, gstat, K, R);

  if constexpr (TC) {
    // p = bf16(exp(s - m) / l) as the bf16 A operand: zeros past len and
    // for the padded beams
    const int kp16 = (K + 15) / 16 * 16;
    for (int j = 0; j < kp16; ++j) {
      const float2 gs = j < K ? gstat[j] : make_float2(0.f, 1.f);
      for (int i = tid; i < len16; i += NTHREADS)
        pb[j * ps + i] =
            j < K && i < len
                ? __float2bfloat16(expf(lg[j * per + i] - gs.x) / gs.y)
                : __float2bfloat16(0.f);
    }
    __syncthreads();
    if (len > 0) sp::mbar_wait(bar(0), 0);
    // p.v: warp w takes the 8-channel tiles w, w + 8, ..., every key
    // k-step, 16 beams a tile
    for (int jt = 0; jt < kp16; jt += 16) {
      for (int nt = warp; nt < DK / 8; nt += NWARPS) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < len16; k0 += 16) {
          const __nv_bfloat16* pa = pb + (jt + g) * ps + k0 + 2 * c4;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(pa);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(pa + 8 * ps);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(pa + 8);
          const uint32_t a3 =
              *reinterpret_cast<const uint32_t*>(pa + 8 * ps + 8);
          const int r = k0 + (lane & 15);
          uint32_t b0, b1;
          ldmatrix_x2_trans(
              sp::smem_u32(vsm + r * RB + sp::slot(r, nt, PPR) * 16), b0, b1);
          sp::mma_bf16(d, a0, a1, a2, a3, b0, b1);
        }
        // d: (beam jt + g, channel 8nt + 2c4), (.., + 1), (beam + 8, ..)
        const int j = jt + g, dd = nt * 8 + 2 * c4;
        if (j < K) {
          sp::push_partial(cluster, recv, j * DK + dd, d[0], slice, rank);
          sp::push_partial(cluster, recv, j * DK + dd + 1, d[1], slice, rank);
        }
        if (j + 8 < K) {
          sp::push_partial(cluster, recv, (j + 8) * DK + dd, d[2], slice,
                           rank);
          sp::push_partial(cluster, recv, (j + 8) * DK + dd + 1, d[3], slice,
                           rank);
        }
      }
    }
  } else {
    for (int j = 0; j < K; ++j) {
      const float2 gs = gstat[j];
      for (int i = tid; i < len; i += NTHREADS)
        lg[j * per + i] = expf(lg[j * per + i] - gs.x) / gs.y;
    }
    __syncthreads();
    // p.v over the share: 4 channels (one piece) of a value row per
    // thread, rows strided over the block's row groups, JG beams at a time
    constexpr int LPR = DK / 4;             // threads per value row
    constexpr int NGR = NTHREADS / LPR;     // row groups
    const int ch = tid % LPR, grp = tid / LPR;
    if (len > 0) sp::mbar_wait(bar(0), 0);
    for (int j0 = 0; j0 < K; j0 += JG) {
      float acc[JG][4];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
      for (int i = grp; i < len; i += NGR) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vsm + i * RB + sp::slot(i, ch, PPR) * 16);
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          if (j0 + jj < K) {
            const float pw = lg[(j0 + jj) * per + i];
            acc[jj][0] = fmaf(pw, vv.x, acc[jj][0]);
            acc[jj][1] = fmaf(pw, vv.y, acc[jj][1]);
            acc[jj][2] = fmaf(pw, vv.z, acc[jj][2]);
            acc[jj][3] = fmaf(pw, vv.w, acc[jj][3]);
          }
        }
      }
      // a warp's row groups by shuffles, then the warps through shared
      // memory
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int o = LPR; o < 32; o <<= 1)
            acc[jj][e] += __shfl_xor_sync(nt::FULL_MASK, acc[jj][e], o);
      if (lane < LPR) {
#pragma unroll
        for (int jj = 0; jj < JG; ++jj)
          reinterpret_cast<float4*>(red + (warp * JG + jj) * DK)[ch] =
              make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]);
      }
      __syncthreads();
      for (int idx = tid; idx < JG * DK; idx += NTHREADS) {
        if (j0 + idx / DK < K) {
          float o = 0.f;
#pragma unroll
          for (int w = 0; w < NWARPS; ++w) o += red[w * JG * DK + idx];
          sp::push_partial(cluster, recv, j0 * DK + idx, o, slice, rank);
        }
      }
      __syncthreads();
    }
  }
  cluster.sync();

  sp::sum_received<NTHREADS>(recv, nout, slice, R, rank,
                             [&](int idx, float o) {
                               const int j = idx / DK, d = idx % DK;
                               out[(size_t)(b * K + j) * D + h * DK + d] = o;
                             });
}

template <typename T, int DK>
int launch(const void* q, const void* kp, const void* vp, const void* kg,
           const void* vg, const float* bias, float* out, int B, int K,
           int Pp, int Ng, int D, int R, cudaStream_t st) {
  const int per = sp::share_rows(Pp + Ng, R);
  const size_t smem = layout(per, DK, (int)sizeof(T), K, R).bytes;
  return sp::launch_cluster<attn_step_split_bias_kernel<T, DK>>(
      R, D / DK, B, NTHREADS, smem, st, static_cast<const T*>(q),
      static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const T*>(kg), static_cast<const T*>(vg), bias, out, K, Pp,
      Ng, D, per);
}

}  // namespace

// q [B, K, D]; kp, vp [B, Pp, D]; kg, vg [B, Ng, D] (bf16 when is_bf16,
// else f32), contiguous, 16-byte aligned; bias [B, K, Pp + Ng] f32; out
// [B, K, D] f32. K >= 1, dk in {64, 128}, D % dk == 0, Pp + Ng >= 1; R the
// cluster size (1..8). Returns cudaGetLastError() of the launch.
extern "C" int attn_step_split_bias(const void* q, const void* kp,
                                    const void* vp, const void* kg,
                                    const void* vg, const float* bias,
                                    float* out, int B, int K, int Pp, int Ng,
                                    int D, int dk, int R, int is_bf16,
                                    void* stream) {
  if (K < 1 || Pp + Ng < 1 || R < 1 || R > sp::MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dk == 64)
      return launch<__nv_bfloat16, 64>(q, kp, vp, kg, vg, bias, out, B, K, Pp, Ng, D, R, st);
    if (dk == 128)
      return launch<__nv_bfloat16, 128>(q, kp, vp, kg, vg, bias, out, B, K, Pp, Ng, D, R, st);
  } else {
    if (dk == 64)
      return launch<float, 64>(q, kp, vp, kg, vg, bias, out, B, K, Pp, Ng, D, R, st);
    if (dk == 128)
      return launch<float, 128>(q, kp, vp, kg, vg, bias, out, B, K, Pp, Ng, D, R, st);
  }
  return (int)cudaErrorInvalidValue;
}
