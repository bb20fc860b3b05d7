// xattn_step: the float decoder's cross-attention at a decode step, a few
// queries per window against the bf16 (or f32) cross-attention memory.
//
// Replaces no Pallas kernel: the JAX package runs this as two XLA einsums
// (notsofar_tpu/models/whisper.py MHA._attend_precomputed, float branch,
// :321-335) whose dtype conversions fuse into the operand reads. The
// port's matmul path widened the memory to f32 in device memory at every
// step and layer instead (xattn_step_plain). Same function: for window b,
// head h and query t (the beams of a window folded into the query axis,
// Tq <= 8), logits = f32 sum over dk of dtype(q * dk**-0.25) *
// dtype(k * dk**-0.25) -- each operand rounded to the memory's dtype as
// PyTorch rounds `qh * scale` (an f32 product, then round to nearest even),
// each product exact in f32 for bf16; softmax in f32; p = dtype(exp(s - m)
// / l) (normalize, then round); out = dtype(f32 sum_s p * v).
//
// What bounds it on an H100: bytes. Each (window, head) reads its S keys
// and values once, 2 * S * dk * 2 bytes in bf16, and does 4 * Tq * dk FLOP
// per key, ~Tq FLOP per byte: far below the ridge. At large-v3 (S 1500, D
// 1280) and 3 windows a layer moves 23.0 MB, ~6.9 us at 3.35 TB/s. At that
// size a block's chain of latencies weighs as much as the bytes: its keys'
// arrival, the logits, two cluster barriers, the weights, p.v, the exchange
// of partial outputs. In a decode step one launch's staged memory fills most
// of the card's shared memory, so the next launch's blocks start only as
// this one's end, and every microsecond of a block's life is paid in full.
//
// Design: the split-softmax skeleton of xattn_int8's few-rows path
// (split_softmax.cuh). A (head, window) pair is a thread-block cluster of
// R <= 8 blocks along x, grid (R, H, B). Block r owns the contiguous share
// of keys [r * ceil(S / R), ...). The plan (ops/kernels.py
// xattn_step_launch) is a function of the shapes alone (one launch
// captured in a CUDA graph serves every step): R = 8 wherever S gives 8
// shares of 32 keys, the fastest of R = 1-8 at 1-3 windows and Tq 1 and 5
// (PERF.md). At large-v3's 3 windows x 20 heads: 480 blocks of ~50-55 KB,
// four to an SM, one wave.
//  * Staging: the block's first instructions put the share's key rows (one
//    mbarrier per 32 rows) and value rows (one mbarrier) in flight into
//    shared memory as 16-byte cp.async copies. (TMA boxes of 32 rows, one
//    thread issuing them, measured slower at both Tq in a CUDA graph, on
//    one memory and on 32 layers' memories: PERF.md.) The kernel is
//    launched with programmatic dependence (launch_cluster_pdl): the memory
//    is fixed for a whole decode call, so those copies are issued before
//    griddepcontrol.wait, while the query's GEMV may still run; the raw
//    queries (1 KB at most), which that GEMV writes, are loaded after the
//    wait with plain loads, and then the next kernel may launch.
//  * bf16 logits on the tensor cores: a warp takes 16 keys at a time as
//    they land, scales and rounds each key element in registers (k *
//    dk**-0.25 -> bf16, the reference's rounding point, so no scaled copy of
//    the memory is ever written) and multiplies them with the scaled queries
//    (mma.sync m16n8k16, the Tq <= 8 queries as the 8 columns, f32
//    accumulation). f32 logits (the parity model): one thread per key, f32
//    FMAs. The logits stay in shared memory; (max, sum) are pushed to the
//    peers and combined in rank order after a cluster barrier; p is formed
//    from the stored logits with the global max and sum and rounded, a
//    key's Tq weights together.
//  * bf16 p.v at Tq >= 2 on the tensor cores: out^T [dk x Tq] = V^T P^T,
//    mma.sync m16n8k16 with 16 channels x 16 keys of V as the A operand
//    (ldmatrix.trans from the staged rows) and P's 16 keys x 8 queries as B
//    (zero past Tq and past the share). p is exact in bf16, so every
//    product is exact in f32 and only the order of the f32 sums differs
//    from the plain version. A warp owns 16 (dk 64) or 32 (dk 128) channels
//    over the whole share, so no sum crosses warps inside a block; it loads
//    the fragments of four 16-key tiles before their products, which run in
//    two chains. At one query (7 of the mma's 8 columns empty) and for f32,
//    f32 FMAs over the staged rows and a reduction through shared memory.
//  * The R partial [Tq, dk] outputs are pushed to their owners over
//    distributed shared memory, summed in rank order and rounded to the
//    dtype.
// Built with -DXATTN_STEP_STAMPS (tools/time_decode_step.py --phases
// only), thread 0 of every block writes (clock64, globaltimer) at the
// phase boundaries marked STAMP(i) into a buffer given as a last argument.
#include <type_traits>

#include "split_softmax.cuh"

namespace cg = cooperative_groups;

#ifdef XATTN_STEP_STAMPS
#define STAMP_PARAM , unsigned long long* __restrict__ stamps
#define STAMP_CPARAM , void* stamps
#define STAMP_ARG , static_cast<unsigned long long*>(stamps)
#define STAMP_PASS , stamps
#define STAMP(i) stamp(stamps, i)
#else
#define STAMP_PARAM
#define STAMP_CPARAM
#define STAMP_ARG
#define STAMP_PASS
#define STAMP(i)
#endif

namespace {

namespace sp = nt::split;

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

#ifdef XATTN_STEP_STAMPS
constexpr int NSTAMPS = 9;

__device__ __forceinline__ void stamp(unsigned long long* st, int i) {
  if (threadIdx.x == 0) {
    const size_t blk =
        blockIdx.x + gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    st[(blk * NSTAMPS + i) * 2] = (unsigned long long)clock64();
    st[(blk * NSTAMPS + i) * 2 + 1] = g;
  }
}
#endif

// p.v on the tensor cores (else f32 FMAs)
template <typename T, int TQ>
struct TcPv {
  static constexpr bool value =
      std::is_same<T, __nv_bfloat16>::value && TQ > 1;
};

// byte offsets of a block's shared memory: mbarriers (values, then one per
// 32 key rows), the raw queries [T][dk], key rows [per][dk] and value rows
// [per][dk] in the memory's dtype (esize bytes), logits -> weights
// [T][per] f32, the warps' partial outputs [NWARPS][T][dk] (FMA p.v only),
// the peers' partial outputs of this block's slice [R][ceil(T * dk / R)],
// the peers' stats [R][T], global stats [T]
struct Layout {
  int bars, qrows, ks, vs, lg, red, recv, peer, gstat, bytes;
};

__host__ __device__ inline Layout layout(int per, int dk, int esize, int T,
                                         int R) {
  Layout L;
  int o = 0;
  L.bars = o;
  o += sp::align_up(8 * (1 + (per + sp::CH - 1) / sp::CH), 128);
  L.qrows = o;
  o += T * dk * esize;
  L.ks = o;
  o += per * dk * esize;
  L.vs = o;
  o += per * dk * esize;
  L.lg = o;
  o += T * per * 4;
  L.red = o;
  o += (esize == 4 || T == 1) ? NWARPS * T * dk * 4 : 0;
  L.recv = o;
  o += sp::align_up(R * ((T * dk + R - 1) / R) * 4, 16);
  L.peer = o;
  o += 8 * R * T;
  L.gstat = o;
  o += 8 * T;
  L.bytes = o;
  return L;
}

// channels per thread in the FMA p.v pass: Tq x C f32 sums stay <= 32
// registers
template <int TQ>
struct PV {
  static constexpr int C = TQ <= 2 ? 16 : TQ <= 4 ? 8 : 4;
};

// two bf16 values (a bf16x2 word) times sc, each rounded to bf16 as
// PyTorch rounds a bf16 tensor times a scalar: f32 product, then RNE
__device__ __forceinline__ uint32_t scaled_pair(uint32_t w, float sc) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  const __nv_bfloat162 r = __floats2bfloat162_rn(f.x * sc, f.y * sc);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// four 8 x 8 bf16 matrices, transposed: lane l gives the address of row
// l % 8 of matrix l / 8; a[j] is matrix j's fragment as mma.sync's A takes
// it
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }

template <typename T, int DK, int TQ>
__global__ void __launch_bounds__(NTHREADS, 4)
xattn_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S, int D,
                  float sc, int per STAMP_PARAM) {
  constexpr int RB = DK * (int)sizeof(T);   // bytes of a row
  constexpr int PPR = RB / 16;              // 16-byte pieces of a row
  constexpr int EPP = 16 / (int)sizeof(T);  // elements of a piece
  constexpr int KS = DK / 16;               // mma k-steps over the channels
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;   // mma fragment coordinates
  const sp::Share sh = sp::share_of(S, R, rank);
  const int len = sh.len;
  const int nck = (len + sp::CH - 1) / sp::CH;
  const int nout = TQ * DK, slice = (nout + R - 1) / R;

  const Layout L = layout(per, DK, (int)sizeof(T), TQ, R);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const unsigned char* sq = smem + L.qrows;
  unsigned char* ks = smem + L.ks;
  unsigned char* vsm = smem + L.vs;
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  float2* peer = reinterpret_cast<float2*>(smem + L.peer);
  float2* gstat = reinterpret_cast<float2*>(smem + L.gstat);
  auto bar = [&](int i) { return sp::smem_u32(bars + i); };   // 0: values

  STAMP(0);
  // the share's key rows and value rows in flight before anything else,
  // before the wait on the query's kernel (no kernel of a decode call
  // writes the memory); the queries after it
  if (tid == 0) {
    for (int i = 0; i <= nck; ++i) sp::mbar_init(bar(i), NTHREADS);
    sp::fence_mbar_init();
  }
  __syncthreads();
  sp::cluster_arrive();
  const size_t mem = ((size_t)b * S + sh.c0) * D + (size_t)h * DK;
  for (int c = 0; c < nck; ++c) {
    sp::stage_rows<NTHREADS, true>(ks, RB, c * sp::CH,
                                   min(len, (c + 1) * sp::CH), [&](int r) {
                                     return k + mem + (size_t)r * D;
                                   });
    sp::cp_async_arrive(bar(1 + c));
  }
  sp::stage_rows<NTHREADS, true>(vsm, RB, 0, len, [&](int r) {
    return v + mem + (size_t)r * D;
  });
  sp::cp_async_arrive(bar(0));
  // the tensor-core p.v reads the share's last 16-key tile whole: its
  // value rows past the share are zeros (their weights are zeros)
  if constexpr (TcPv<T, TQ>::value)
    for (int p = tid; p < ((len + 15) / 16 * 16 - len) * PPR; p += NTHREADS)
      *reinterpret_cast<uint4*>(vsm + (len + p / PPR) * RB + (p % PPR) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
  sp::pdl_wait();
  for (int p = tid; p < TQ * PPR; p += NTHREADS) {
    const int t = p / PPR, kp = p % PPR;
    *reinterpret_cast<uint4*>(smem + L.qrows + t * RB + kp * 16) =
        *reinterpret_cast<const uint4*>(q + ((size_t)b * TQ + t) * D +
                                        h * DK + kp * EPP);
  }
  sp::pdl_launch_dependents();   // every load of the kernel issued
  __syncthreads();
  STAMP(1);

  if constexpr (TC) {
    if (len > 0) {
      sp::mbar_wait(bar(1), 0);
      // the scaled queries as B fragments: lane (g, c4) holds query g's
      // channels c4 * DK/4 + 4s .. + 3 for k-step s
      uint32_t qb[KS][2];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint2 u = make_uint2(0u, 0u);
        if (g < TQ) {
          u = *reinterpret_cast<const uint2*>(sq + g * RB +
                                              (c4 * (DK / 4) + 4 * s) * 2);
          u.x = scaled_pair(u.x, sc);
          u.y = scaled_pair(u.y, sc);
        }
        qb[s][0] = u.x;
        qb[s][1] = u.y;
      }
      // a warp takes 16 keys (rows g and g + 8 of the tile) at a time;
      // lane c4 reads its DK/4 channels of each (KS/2 pieces): word 2s
      // holds channels c4 * DK/4 + 4s, + 1, word 2s + 1 the next two
      for (int mt = warp; mt * 16 < len; mt += NWARPS) {
        sp::mbar_wait(bar(1 + mt * 16 / sp::CH), 0);
        const int i0 = mt * 16 + g, i1 = i0 + 8;
        uint32_t w0[2 * KS], w1[2 * KS];
#pragma unroll
        for (int pc = 0; pc < KS / 2; ++pc) {
          const int kp = c4 * (KS / 2) + pc;
          uint4 u0 = make_uint4(0u, 0u, 0u, 0u), u1 = u0;
          if (i0 < len)
            u0 = *reinterpret_cast<const uint4*>(
                ks + i0 * RB + sp::slot(i0, kp, PPR) * 16);
          if (i1 < len)
            u1 = *reinterpret_cast<const uint4*>(
                ks + i1 * RB + sp::slot(i1, kp, PPR) * 16);
          w0[4 * pc] = u0.x, w0[4 * pc + 1] = u0.y, w0[4 * pc + 2] = u0.z,
          w0[4 * pc + 3] = u0.w;
          w1[4 * pc] = u1.x, w1[4 * pc + 1] = u1.y, w1[4 * pc + 2] = u1.z,
          w1[4 * pc + 3] = u1.w;
        }
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < KS; ++s)
          sp::mma_bf16(d, scaled_pair(w0[2 * s], sc),
                       scaled_pair(w1[2 * s], sc),
                       scaled_pair(w0[2 * s + 1], sc),
                       scaled_pair(w1[2 * s + 1], sc), qb[s][0], qb[s][1]);
        // d: (key i0, query 2c4), (i0, 2c4 + 1), (i1, 2c4), (i1, 2c4 + 1)
        const int t0 = 2 * c4;
        if (t0 < TQ) {
          if (i0 < len) lg[t0 * per + i0] = d[0];
          if (i1 < len) lg[t0 * per + i1] = d[2];
        }
        if (t0 + 1 < TQ) {
          if (i0 < len) lg[(t0 + 1) * per + i0] = d[1];
          if (i1 < len) lg[(t0 + 1) * per + i1] = d[3];
        }
      }
    }
  } else {
    const float* qs = reinterpret_cast<const float*>(sq);
    // one thread per key, its chunk of 32 rows waited for first; q and k
    // scaled in f32 (each product rounded, as `qh * scale` in f32)
    for (int i = tid; i < len; i += NTHREADS) {
      sp::mbar_wait(bar(1 + i / sp::CH), 0);
      float acc[TQ];
#pragma unroll
      for (int t = 0; t < TQ; ++t) acc[t] = 0.f;
#pragma unroll
      for (int kp = 0; kp < PPR; ++kp) {
        float kf[4];
        nt::load16(reinterpret_cast<const float*>(
                       ks + i * RB + sp::slot(i, kp, PPR) * 16),
                   kf);
#pragma unroll
        for (int e = 0; e < 4; ++e) kf[e] = __fmul_rn(kf[e], sc);
#pragma unroll
        for (int t = 0; t < TQ; ++t) {
          const float4 qv = reinterpret_cast<const float4*>(qs + t * DK)[kp];
          acc[t] = fmaf(__fmul_rn(qv.x, sc), kf[0], acc[t]);
          acc[t] = fmaf(__fmul_rn(qv.y, sc), kf[1], acc[t]);
          acc[t] = fmaf(__fmul_rn(qv.z, sc), kf[2], acc[t]);
          acc[t] = fmaf(__fmul_rn(qv.w, sc), kf[3], acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < TQ; ++t) lg[t * per + i] = acc[t];
    }
  }
  __syncthreads();
  STAMP(2);

  sp::cluster_wait();   // every peer has started: pushes may begin
  sp::push_stats<NTHREADS>(cluster, lg, per, len, TQ, peer, R, rank);
  cluster.sync();
  sp::combine_stats<NTHREADS>(peer, gstat, TQ, R);
  STAMP(3);
  // p = dtype(exp(s - m) / l) from the stored logits and the global m, l,
  // a key's TQ weights together (independent chains); for the tensor
  // cores, zeros up to the share's last 16-key tile
  const int plen = TcPv<T, TQ>::value ? (len + 15) / 16 * 16 : len;
  float2 gs[TQ];
#pragma unroll
  for (int t = 0; t < TQ; ++t) gs[t] = gstat[t];
  for (int i = tid; i < plen; i += NTHREADS)
#pragma unroll
    for (int t = 0; t < TQ; ++t)
      lg[t * per + i] =
          i < len ? nt::round_as(expf(lg[t * per + i] - gs[t].x) / gs[t].y,
                                 static_cast<const T*>(nullptr))
                  : 0.f;
  __syncthreads();
  STAMP(4);

  if constexpr (TcPv<T, TQ>::value) {
    // out^T = V^T P^T over the share: warp w owns the 16-channel tiles
    // w * MPW .. + MPW - 1; per 16 keys, lane l gives the address of key
    // k0 + l % 8 + 8 * (l / 16) at channel m0 + 8 * (l / 8 % 2), so
    // ldmatrix.trans hands it A = (channels g, g + 8) x (keys 2c4, 2c4 + 1,
    // + 8, + 9); B holds query g's weights of the same keys (zero past Tq).
    // The fragments of U tiles are loaded before their products, which run
    // in two chains (even and odd tiles) summed at the end.
    constexpr int MPW = DK / 16 / NWARPS;
    constexpr int U = 4;
    float acc[2][MPW][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int m = 0; m < MPW; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][m][e] = 0.f;
    if (len > 0) sp::mbar_wait(bar(0), 0);
    STAMP(5);
    const uint32_t vb = sp::smem_u32(vsm);
    const int lrow = (lane & 7) + 8 * (lane >> 4), lch = 8 * ((lane >> 3) & 1);
    const float* pg = lg + min(g, TQ - 1) * per + 2 * c4;
    for (int k1 = 0; k1 < len; k1 += 16 * U) {
      uint32_t a[U][MPW][4], bf[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k0 = k1 + 16 * u;
        bf[u][0] = bf[u][1] = 0u;
        if (k0 < len) {
          if (g < TQ) {
            const float2 p0 = *reinterpret_cast<const float2*>(pg + k0);
            const float2 p1 = *reinterpret_cast<const float2*>(pg + k0 + 8);
            bf[u][0] = sp::pack_exact(p0.x, p0.y);
            bf[u][1] = sp::pack_exact(p1.x, p1.y);
          }
          const int r = k0 + lrow;
#pragma unroll
          for (int m = 0; m < MPW; ++m)
            ldsm_x4_trans(a[u][m],
                          vb + r * RB +
                              sp::slot(r, ((warp * MPW + m) * 16 + lch) / 8,
                                       PPR) * 16);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k1 + 16 * u < len)
#pragma unroll
          for (int m = 0; m < MPW; ++m)
            sp::mma_bf16(acc[u & 1][m], a[u][m][0], a[u][m][1], a[u][m][2],
                         a[u][m][3], bf[u][0], bf[u][1]);
    }
    STAMP(6);
    // acc[c][m]: (channel m0 + g, query 2c4), (m0 + g, 2c4 + 1), (m0 + g +
    // 8, 2c4), (m0 + g + 8, 2c4 + 1)
#pragma unroll
    for (int m = 0; m < MPW; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 2 * c4 + (e & 1);
        const int ch = (warp * MPW + m) * 16 + g + 8 * (e >> 1);
        if (t < TQ)
          sp::push_partial(cluster, recv, t * DK + ch,
                           acc[0][m][e] + acc[1][m][e], slice, rank);
      }
  } else {
    // FMA p.v over the share: C channels of a value row per thread, rows
    // strided over the block's row groups
    constexpr int C = PV<TQ>::C;
    constexpr int LPR = DK / C;            // threads per value row
    constexpr int NGR = NTHREADS / LPR;    // row groups
    const int ch = tid % LPR, grp = tid / LPR;
    float acc[TQ][C];
#pragma unroll
    for (int t = 0; t < TQ; ++t)
#pragma unroll
      for (int e = 0; e < C; ++e) acc[t][e] = 0.f;
    if (len > 0) sp::mbar_wait(bar(0), 0);
    STAMP(5);
    for (int i = grp; i < len; i += NGR) {
      float vf[C];
#pragma unroll
      for (int j = 0; j < C / EPP; ++j)
        nt::load16(reinterpret_cast<const T*>(
                       vsm + i * RB +
                       sp::slot(i, ch * (C / EPP) + j, PPR) * 16),
                   vf + EPP * j);
#pragma unroll
      for (int t = 0; t < TQ; ++t) {
        const float pw = lg[t * per + i];
#pragma unroll
        for (int e = 0; e < C; ++e) acc[t][e] = fmaf(pw, vf[e], acc[t][e]);
      }
    }
    // a warp's row groups by shuffles, then the warps through shared memory
#pragma unroll
    for (int t = 0; t < TQ; ++t)
#pragma unroll
      for (int e = 0; e < C; ++e)
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          acc[t][e] += __shfl_xor_sync(nt::FULL_MASK, acc[t][e], o);
    if (lane < LPR) {
#pragma unroll
      for (int t = 0; t < TQ; ++t)
#pragma unroll
        for (int e = 0; e < C; ++e)
          red[(warp * TQ + t) * DK + ch * C + e] = acc[t][e];
    }
    __syncthreads();
    STAMP(6);
    for (int idx = tid; idx < nout; idx += NTHREADS) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) o += red[w * nout + idx];
      sp::push_partial(cluster, recv, idx, o, slice, rank);
    }
  }
  cluster.sync();
  STAMP(7);

  sp::sum_received<NTHREADS>(recv, nout, slice, R, rank, [&](int idx,
                                                             float o) {
    const int t = idx / DK, d = idx % DK;
    store_as(out + ((size_t)b * TQ + t) * D + h * DK + d, o);
  });
  STAMP(8);
}

template <typename T, int DK, int TQ>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int D, float sc, int R, cudaStream_t st STAMP_CPARAM) {
  const int per = sp::share_rows(S, R);
  const size_t smem = layout(per, DK, (int)sizeof(T), TQ, R).bytes;
  return sp::launch_cluster_pdl<xattn_step_kernel<T, DK, TQ>>(
      R, D / DK, B, NTHREADS, smem, st, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, D, sc, per STAMP_ARG);
}

template <typename T, int DK>
int launch_tq(int Tq, const void* q, const void* k, const void* v, void* out,
              int B, int S, int D, float sc, int R,
              cudaStream_t st STAMP_CPARAM) {
#define XATTN_STEP_CASE(n)                                            \
  case n:                                                             \
    return launch<T, DK, n>(q, k, v, out, B, S, D, sc, R, st STAMP_PASS);
  switch (Tq) {
    XATTN_STEP_CASE(1) XATTN_STEP_CASE(2) XATTN_STEP_CASE(3)
    XATTN_STEP_CASE(4) XATTN_STEP_CASE(5) XATTN_STEP_CASE(6)
    XATTN_STEP_CASE(7) XATTN_STEP_CASE(8)
  }
#undef XATTN_STEP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, Tq, D], k and v [B, S, D], out [B, Tq, D], all bf16 when is_bf16,
// else f32, contiguous and 16-byte aligned. 1 <= Tq <= 8, dk in {64, 128},
// D % dk == 0, S >= 1; sc = dk**-0.25 as f32; R the cluster size (1..8).
// The launch carries the programmatic-stream-serialization attribute.
// Returns cudaGetLastError() of the launch. Stamped builds take the stamp
// buffer [grid blocks][9][2] u64 last.
extern "C" int xattn_step(const void* q, const void* k, const void* v,
                          void* out, int B, int Tq, int S, int D, int dk,
                          float sc, int R, int is_bf16,
                          void* stream STAMP_CPARAM) {
  if (R < 1 || R > sp::MAX_CLUSTER || S < 1 || D % dk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dk == 64)
      return launch_tq<__nv_bfloat16, 64>(Tq, q, k, v, out, B, S, D, sc, R,
                                          st STAMP_PASS);
    if (dk == 128)
      return launch_tq<__nv_bfloat16, 128>(Tq, q, k, v, out, B, S, D, sc, R,
                                           st STAMP_PASS);
  } else {
    if (dk == 64)
      return launch_tq<float, 64>(Tq, q, k, v, out, B, S, D, sc, R,
                                  st STAMP_PASS);
    if (dk == 128)
      return launch_tq<float, 128>(Tq, q, k, v, out, B, S, D, sc, R,
                                   st STAMP_PASS);
  }
  return (int)cudaErrorInvalidValue;
}
