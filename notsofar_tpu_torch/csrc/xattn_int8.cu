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
// s_valid (zero padding) are never read; their weights are exactly 0.
// Second in line once the bytes flow: widening int8 to f32. A conversion
// instruction (I2F) runs at 16 per clock per SM, about the whole bound at
// these shapes, so each byte is widened with the f32 magic-number trick
// instead (one byte permute into 0x4B0000xx and one FADD, exact for every
// int8 value).
//
// Two designs, one per kind of grid (xattn_int8_launch picks R):
//
// Few rows (R >= 2; beam 5 folds 9 streams x 5 beams into 180 (head,
// row) pairs, 1.4 blocks a SM if a pair were a block): split softmax
// (split_softmax.cuh). A (head, row) pair is a thread-block cluster of R
// <= 8 blocks along x, grid (R, H, B); block r owns the contiguous share
// of keys [r * ceil(s_valid / R), ...). Its first instructions put the
// queries, the share's key rows (one mbarrier per 32 rows) and its value
// rows (one mbarrier) in flight into shared memory as 16-byte
// asynchronous copies. Logits of bf16 queries on the tensor cores: a warp
// takes 16 keys at a time as they land, widens their int8 bytes to bf16
// (exact) and multiplies them with the queries (mma.sync m16n8k16, the
// Tq <= 8 queries as the 8 columns, f32 accumulation); the channels are
// dealt to the fragments in an order that lets each lane read 16
// contiguous bytes of a row. Logits of f32 queries (the parity model):
// one thread per key, f32 FMAs. The logits [Tq, share] stay in shared
// memory; each block pushes its share's max and sum to its peers, and
// after a cluster barrier every block combines the R pairs in rank order,
// forms p = bf16(exp(s - m) / l) from its stored logits with the global m
// and l, and its share's p.v in f32 FMAs from the value rows, which landed
// during the logits and the softmax. Each block pushes its partial [Tq,
// dk] output to the blocks that own its slices; after a second barrier
// each sums its slice over the R blocks in rank order, times the
// v-scales.
//
// Many rows (R = 1; greedy reads 48 rows, 960 pairs): one block of 256
// threads per (head, row), grid (H, B), all resident at once. A grid this
// large holds 184 MB of K/V against the card's 30 MB of shared memory, so
// staging every share takes 7 rounds of blocks whose copies, softmax and
// cluster barriers run in step; streaming a whole row per block keeps the
// loads in flight instead (measured on an H100 80GB HBM3 at 700 W: 0.116-
// 0.138 ms staged at R = 2-8, 0.088 ms streaming).
// Pass 1 streams the keys (a key's dk bytes are dk/16 lanes' 16-byte
// loads), each lane dotting its 16 widened values with the queries (f32,
// shuffles across a key's lanes); the whole logit row stays in shared
// memory; softmax one warp per query; pass 2 streams the values, 8
// channels a lane. (Putting a block's value rows in flight into L2 at its
// start made it slower: the resident blocks' values, 92 MB, overflow the
// 50 MB L2 and are read twice. A persistent grid whose
// clusters walk the pairs with two stages of bytes, the next pair's in
// flight during the current one's compute, was slower at both serving
// shapes.)
#include <type_traits>

#include "split_softmax.cuh"

namespace cg = cooperative_groups;

namespace {

namespace sp = nt::split;

// ---------------------------------------------------------------------------
// shared by both designs
// ---------------------------------------------------------------------------

// the four signed bytes of w as exact f32: each biased byte (k + 128) goes
// into the mantissa of 2^23 (0x4B0000xx), and 2^23 + 128 is subtracted
__device__ __forceinline__ void widen4(unsigned w, float* f) {
  const unsigned x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
}

// C (4, 8 or 16) int8 values at p, widened
template <int C>
__device__ __forceinline__ void load_widen(const int8_t* p, float* f) {
  if constexpr (C == 16) {
    const int4 u = *reinterpret_cast<const int4*>(p);
    widen4((unsigned)u.x, f);
    widen4((unsigned)u.y, f + 4);
    widen4((unsigned)u.z, f + 8);
    widen4((unsigned)u.w, f + 12);
  } else if constexpr (C == 8) {
    const int2 u = *reinterpret_cast<const int2*>(p);
    widen4((unsigned)u.x, f);
    widen4((unsigned)u.y, f + 4);
  } else {
    widen4(*reinterpret_cast<const unsigned*>(p), f);
  }
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }

// ---------------------------------------------------------------------------
// few rows: split softmax over a cluster
// ---------------------------------------------------------------------------

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

// byte offsets of a cluster block's shared memory: mbarriers (values,
// then one per 32 key rows), the queries [T][dk] in their dtype (qsize
// bytes), key rows [per][dk] and value rows [per][dk] int8, logits ->
// weights [T][per] f32, the warps' partial outputs [NWARPS][T][dk], the
// peers' partial outputs of this block's slice [R][ceil(T * dk / R)], the
// peers' stats [R][T], global stats [T]
struct Layout {
  int bars, qrows, ks, vs, lg, red, recv, peer, gstat, bytes;
};

__host__ __device__ inline Layout layout(int per, int dk, int qsize, int T,
                                         int R) {
  Layout L;
  int o = 0;
  L.bars = o;
  o += sp::align_up(8 * (1 + (per + sp::CH - 1) / sp::CH), 128);
  L.qrows = o;
  o += T * dk * qsize;
  L.ks = o;
  o += per * dk;
  L.vs = o;
  o += per * dk;
  L.lg = o;
  o += T * per * 4;
  L.red = o;
  o += NWARPS * T * dk * 4;
  L.recv = o;
  o += sp::align_up(R * ((T * dk + R - 1) / R) * 4, 16);
  L.peer = o;
  o += 8 * R * T;
  L.gstat = o;
  o += 8 * T;
  L.bytes = o;
  return L;
}

// channels per thread in the p.v pass: Tq x C f32 sums stay <= 32
// registers
template <int TQ>
struct PV {
  static constexpr int C = TQ <= 2 ? 16 : TQ <= 4 ? 8 : 4;
};

template <typename T, int DK, int TQ>
__global__ void __launch_bounds__(NTHREADS, 8)
xattn_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ v8, const float* __restrict__ vsc,
                  float* __restrict__ out, int S_pad, int D, int s_valid,
                  int per) {
  constexpr int PPR = DK / 16;           // 16-byte pieces of a row
  constexpr int KS = DK / 16;            // mma k-steps over the channels
  constexpr int QB = DK * (int)sizeof(T);   // bytes of a query row
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;   // mma fragment coordinates
  const sp::Share sh = sp::share_of(s_valid, R, rank);
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

  // the queries, the share's key rows and its value rows in flight before
  // anything else; each key chunk's barrier also covers the queries
  if (tid == 0) {
    for (int i = 0; i <= nck; ++i) sp::mbar_init(bar(i), NTHREADS);
    sp::fence_mbar_init();
  }
  __syncthreads();
  sp::cluster_arrive();
  const size_t mem = ((size_t)b * S_pad + sh.c0) * D + (size_t)h * DK;
  if (len > 0)
    sp::stage_rows<NTHREADS, false>(smem + L.qrows, QB, 0, TQ, [&](int t) {
      return q + ((size_t)b * TQ + t) * D + h * DK;
    });
  for (int c = 0; c < nck; ++c) {
    sp::stage_rows<NTHREADS, true>(ks, DK, c * sp::CH,
                                   min(len, (c + 1) * sp::CH), [&](int r) {
                                     return k8 + mem + (size_t)r * D;
                                   });
    sp::cp_async_arrive(bar(1 + c));
  }
  sp::stage_rows<NTHREADS, true>(vsm, DK, 0, len, [&](int r) {
    return v8 + mem + (size_t)r * D;
  });
  sp::cp_async_arrive(bar(0));

  if constexpr (TC) {
    if (len > 0) {
      sp::mbar_wait(bar(1), 0);
      // the queries as B fragments: lane (g, c4) holds query g's channels
      // c4 * DK/4 + 4s .. + 3 for k-step s
      uint32_t qb[KS][2];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint2 u = make_uint2(0u, 0u);
        if (g < TQ)
          u = *reinterpret_cast<const uint2*>(sq + g * QB +
                                              (c4 * (DK / 4) + 4 * s) * 2);
        qb[s][0] = u.x;
        qb[s][1] = u.y;
      }
      // a warp takes 16 keys (rows g and g + 8 of the tile) at a time;
      // lane c4 reads its DK/4 contiguous bytes of each: word s holds
      // channels c4 * DK/4 + 4s .. + 3
      for (int mt = warp; mt * 16 < len; mt += NWARPS) {
        sp::mbar_wait(bar(1 + mt * 16 / sp::CH), 0);
        const int i0 = mt * 16 + g, i1 = i0 + 8;
        uint32_t w0[KS], w1[KS];
#pragma unroll
        for (int pc = 0; pc < KS / 4; ++pc) {
          const int k = c4 * (KS / 4) + pc;
          uint4 u0 = make_uint4(0u, 0u, 0u, 0u), u1 = u0;
          if (i0 < len)
            u0 = *reinterpret_cast<const uint4*>(
                ks + i0 * DK + sp::slot(i0, k, PPR) * 16);
          if (i1 < len)
            u1 = *reinterpret_cast<const uint4*>(
                ks + i1 * DK + sp::slot(i1, k, PPR) * 16);
          w0[4 * pc] = u0.x, w0[4 * pc + 1] = u0.y, w0[4 * pc + 2] = u0.z,
          w0[4 * pc + 3] = u0.w;
          w1[4 * pc] = u1.x, w1[4 * pc + 1] = u1.y, w1[4 * pc + 2] = u1.z,
          w1[4 * pc + 3] = u1.w;
        }
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          float f0[4], f1[4];
          widen4(w0[s], f0);
          widen4(w1[s], f1);
          sp::mma_bf16(d, sp::pack_exact(f0[0], f0[1]),
                       sp::pack_exact(f1[0], f1[1]),
                       sp::pack_exact(f0[2], f0[3]),
                       sp::pack_exact(f1[2], f1[3]), qb[s][0], qb[s][1]);
        }
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
    // one thread per key, its chunk of 32 rows waited for first
    for (int i = tid; i < len; i += NTHREADS) {
      sp::mbar_wait(bar(1 + i / sp::CH), 0);
      float acc[TQ];
#pragma unroll
      for (int t = 0; t < TQ; ++t) acc[t] = 0.f;
#pragma unroll
      for (int k = 0; k < PPR; ++k) {
        float kf[16];
        load_widen<16>(reinterpret_cast<const int8_t*>(ks) + i * DK +
                           sp::slot(i, k, PPR) * 16,
                       kf);
#pragma unroll
        for (int t = 0; t < TQ; ++t) {
          const float4* qk =
              reinterpret_cast<const float4*>(qs + t * DK + 16 * k);
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const float4 qv = qk[e4];   // the same address in every lane
            acc[t] = fmaf(qv.x, kf[4 * e4], acc[t]);
            acc[t] = fmaf(qv.y, kf[4 * e4 + 1], acc[t]);
            acc[t] = fmaf(qv.z, kf[4 * e4 + 2], acc[t]);
            acc[t] = fmaf(qv.w, kf[4 * e4 + 3], acc[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < TQ; ++t) lg[t * per + i] = acc[t];
    }
  }
  __syncthreads();

  sp::cluster_wait();   // every peer has started: pushes may begin
  sp::push_stats<NTHREADS>(cluster, lg, per, len, TQ, peer, R, rank);
  cluster.sync();
  sp::combine_stats<NTHREADS>(peer, gstat, TQ, R);
  // p = bf16(exp(s - m) / l) from the stored logits and the global m, l
  for (int t = 0; t < TQ; ++t) {
    const float2 gs = gstat[t];
    for (int i = tid; i < len; i += NTHREADS)
      lg[t * per + i] = __bfloat162float(
          __float2bfloat16(expf(lg[t * per + i] - gs.x) / gs.y));
  }
  __syncthreads();

  // p.v over the share: C channels of a value row per thread, rows strided
  // over the block's row groups
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
  for (int i = grp; i < len; i += NGR) {
    float vf[C];
    load_widen<C>(reinterpret_cast<const int8_t*>(vsm) + i * DK +
                      sp::slot(i, ch * C / 16, PPR) * 16 + ch * C % 16,
                  vf);
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
  for (int idx = tid; idx < nout; idx += NTHREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += red[w * nout + idx];
    sp::push_partial(cluster, recv, idx, o, slice, rank);
  }
  cluster.sync();

  sp::sum_received<NTHREADS>(recv, nout, slice, R, rank, [&](int idx,
                                                             float o) {
    const int t = idx / DK, d = idx % DK;
    out[((size_t)b * TQ + t) * D + h * DK + d] =
        o * vsc[(size_t)b * D + h * DK + d];
  });
}

// ---------------------------------------------------------------------------
// many rows: one block streams a whole row
// ---------------------------------------------------------------------------

constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int CPL = 8;                   // channels per lane in pass 2

// shared memory of a row block in floats: queries [T][dk], logits ->
// weights [T][n] (n >= s_valid), the warps' partial outputs
// [ROW_WARPS][T][dk]
__host__ __device__ inline int row_floats(int dk, int T, int n) {
  return T * dk + T * n + ROW_WARPS * T * dk;
}

// at Tq <= 2 the grid is the greedy one: 8 blocks a SM (<= 32 registers)
// keep all of its 960 blocks resident at once
template <typename T, int DK, int TQ>
__global__ void __launch_bounds__(ROW_THREADS, TQ <= 2 ? 8 : 1)
xattn_int8_row_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                      const int8_t* __restrict__ v8,
                      const float* __restrict__ vsc, float* __restrict__ out,
                      int S_pad, int D, int s_valid) {
  constexpr int LPK = DK / 16;           // lanes per key in pass 1
  constexpr int KPW = 32 / LPK;          // keys per warp load in pass 1
  constexpr int LPV = DK / CPL;          // lanes per key in pass 2
  constexpr int VPW = 32 / LPV;          // keys per warp load in pass 2
  extern __shared__ float fsmem[];
  float* qs = fsmem;                     // [TQ][DK] queries in f32
  float* lg = qs + TQ * DK;              // [TQ][s_valid] logits -> weights
  float* red = lg + TQ * s_valid;        // [ROW_WARPS][TQ][DK]

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t mem = (size_t)b * S_pad * D + (size_t)h * DK;

  for (int e = threadIdx.x; e < TQ * DK; e += ROW_THREADS)
    qs[e] = to_f32(q[((size_t)b * TQ + e / DK) * D + h * DK + e % DK]);
  __syncthreads();

  // pass 1: logits of the s_valid keys
  {
    const int sub = lane / LPK, c = lane % LPK;
    for (int s0 = warp * KPW; s0 < s_valid; s0 += ROW_WARPS * KPW) {
      const int s = s0 + sub;
      float acc[TQ];
#pragma unroll
      for (int t = 0; t < TQ; ++t) acc[t] = 0.f;
      if (s < s_valid) {
        const int4 u = *reinterpret_cast<const int4*>(
            k8 + mem + (size_t)s * D + c * 16);
        const unsigned w[4] = {(unsigned)u.x, (unsigned)u.y, (unsigned)u.z,
                               (unsigned)u.w};
        // a word at a time, so that few widened values are live
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float kf[4];
          widen4(w[j], kf);
#pragma unroll
          for (int t = 0; t < TQ; ++t) {
            const float4 qv =
                reinterpret_cast<const float4*>(qs + t * DK + c * 16)[j];
            acc[t] = fmaf(qv.x, kf[0], acc[t]);
            acc[t] = fmaf(qv.y, kf[1], acc[t]);
            acc[t] = fmaf(qv.z, kf[2], acc[t]);
            acc[t] = fmaf(qv.w, kf[3], acc[t]);
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
        for (int t = 0; t < TQ; ++t) lg[t * s_valid + s] = acc[t];
      }
    }
  }
  __syncthreads();

  // softmax, one warp per query row: max, exp, sum, then p = bf16(e / sum)
  if (warp < TQ) {
    float* row = lg + warp * s_valid;
    float m = -INFINITY;
    for (int s = lane; s < s_valid; s += 32) m = fmaxf(m, row[s]);
    m = nt::warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < s_valid; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    sum = nt::warp_sum(sum);
    for (int s = lane; s < s_valid; s += 32)
      row[s] = __bfloat162float(__float2bfloat16(row[s] / sum));
  }
  __syncthreads();

  // pass 2: p.v over the s_valid keys
  {
    const int sub = lane / LPV, c = lane % LPV;
    float acc[TQ][CPL];
#pragma unroll
    for (int t = 0; t < TQ; ++t)
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[t][i] = 0.f;
    for (int s0 = warp * VPW; s0 < s_valid; s0 += ROW_WARPS * VPW) {
      const int s = s0 + sub;
      if (s < s_valid) {
        float vv[CPL];
        load_widen<CPL>(v8 + mem + (size_t)s * D + c * CPL, vv);
#pragma unroll
        for (int t = 0; t < TQ; ++t) {
          const float p = lg[t * s_valid + s];
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
  for (int e = threadIdx.x; e < TQ * DK; e += ROW_THREADS) {
    const int t = e / DK, d = e % DK;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) o += red[(w * TQ + t) * DK + d];
    out[((size_t)b * TQ + t) * D + h * DK + d] =
        o * vsc[(size_t)b * D + h * DK + d];
  }
}

template <typename T, int DK, int TQ>
int launch(const void* q, const void* k8, const void* v8, const float* vs,
           float* out, int B, int S_pad, int D, int s_valid, int R,
           cudaStream_t st) {
  if (R > 1) {
    const int per = sp::share_rows(S_pad, R);
    const size_t smem = layout(per, DK, (int)sizeof(T), TQ, R).bytes;
    return sp::launch_cluster<xattn_int8_kernel<T, DK, TQ>>(
        R, D / DK, B, NTHREADS, smem, st, static_cast<const T*>(q),
        static_cast<const int8_t*>(k8), static_cast<const int8_t*>(v8), vs,
        out, S_pad, D, s_valid, per);
  }
  // sized by S_pad (the logit row takes s_valid of it), so that the
  // opt-in above 48 KB is set once per instance and device, and raised
  // only when a larger S_pad arrives, not on every decode-step launch
  const size_t smem = (size_t)row_floats(DK, TQ, S_pad) * sizeof(float);
  constexpr int MAX_DEVICES = 64;
  static size_t opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted_in[dev]) {
    e = cudaFuncSetAttribute(xattn_int8_row_kernel<T, DK, TQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = smem;
  }
  xattn_int8_row_kernel<T, DK, TQ><<<dim3(D / DK, B), ROW_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), vs, out, S_pad, D, s_valid);
  return (int)cudaGetLastError();
}

template <typename T, int DK>
int launch_tq(int Tq, const void* q, const void* k8, const void* v8,
              const float* vs, float* out, int B, int S_pad, int D,
              int s_valid, int R, cudaStream_t st) {
  switch (Tq) {
    case 1: return launch<T, DK, 1>(q, k8, v8, vs, out, B, S_pad, D, s_valid, R, st);
    case 2: return launch<T, DK, 2>(q, k8, v8, vs, out, B, S_pad, D, s_valid, R, st);
    case 3: return launch<T, DK, 3>(q, k8, v8, vs, out, B, S_pad, D, s_valid, R, st);
    case 4: return launch<T, DK, 4>(q, k8, v8, vs, out, B, S_pad, D, s_valid, R, st);
    case 5: return launch<T, DK, 5>(q, k8, v8, vs, out, B, S_pad, D, s_valid, R, st);
    case 6: return launch<T, DK, 6>(q, k8, v8, vs, out, B, S_pad, D, s_valid, R, st);
    case 7: return launch<T, DK, 7>(q, k8, v8, vs, out, B, S_pad, D, s_valid, R, st);
    case 8: return launch<T, DK, 8>(q, k8, v8, vs, out, B, S_pad, D, s_valid, R, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, Tq, D] (bf16 when is_bf16, else f32); k8, v8 [B, S_pad, D] int8;
// vs [B, D] f32; out [B, Tq, D] f32; all contiguous and 16-byte aligned.
// 1 <= Tq <= 8, dk in {64, 128}, D % dk == 0, 0 < s_valid <= S_pad; R the
// cluster size (2..8), or 1 for a block per row. Returns cudaGetLastError()
// of the launch.
extern "C" int xattn_int8(const void* q, const void* k8, const void* v8,
                          const float* vs, float* out, int B, int Tq,
                          int S_pad, int D, int dk, int s_valid, int R,
                          int is_bf16, void* stream) {
  if (R < 1 || R > sp::MAX_CLUSTER || s_valid < 1 || s_valid > S_pad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dk == 64)
      return launch_tq<__nv_bfloat16, 64>(Tq, q, k8, v8, vs, out, B, S_pad,
                                          D, s_valid, R, st);
    if (dk == 128)
      return launch_tq<__nv_bfloat16, 128>(Tq, q, k8, v8, vs, out, B, S_pad,
                                           D, s_valid, R, st);
  } else {
    if (dk == 64)
      return launch_tq<float, 64>(Tq, q, k8, v8, vs, out, B, S_pad, D,
                                  s_valid, R, st);
    if (dk == 128)
      return launch_tq<float, 128>(Tq, q, k8, v8, vs, out, B, S_pad, D,
                                   s_valid, R, st);
  }
  return (int)cudaErrorInvalidValue;
}
