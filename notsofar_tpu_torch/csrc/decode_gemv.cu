// decode_gemv: a few rows of activations times up to three weight matrices
// read once in their stored type (int8 or bf16), for every dense layer of
// the decode step and the output logits, with the work around them that
// the reference's XLA program fuses into its dots: the layer norm before
// the product, and the GELU, residual add, attention-query scale and
// cache write after it.
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA,
// which fuses the dtype converts, layer norms, activations and adds into
// the dots' operand reads and epilogues (notsofar_tpu/models/whisper.py
// QuantDense :76-97, ResidualBlock :346-368, the logits einsums :502-507).
// decode_gemv_plain / decode_qkv_plain (ops/kernels.py) hold the rounding
// points; each is the port's unfused sequence of PyTorch ops. For x [M, K]
// and a segment's weight w [N, K]:
//   ln (optional): x = layer_norm(x) in f32 (the statistics of each full
//     row of K, the parameters widened to f32), the raw residual stream in;
//   x is rounded to the compute dtype (bf16 or f32) on its way in;
//   acc = f32 sum_k x[m, k] * w[n, k] (w int8 or bf16, exact in bf16);
//   dense: y = dt(acc), y = dt(y * dt(scale[n])), y = dt(y + dt(bias[n])),
//     each rounded to the compute dtype dt (the scale never folded into the
//     weight, the bias never in the product; no scale for a bf16 weight,
//     flax nn.Dense's two rounding points); then optionally
//     y = dt((y * s) * post[m / post_rows, n]) (the int8 cross-attention's
//     query), y = dt(y * mul) (the self-attention's query scale),
//     y = dt(gelu(y)) (exact erf GELU in f32), y = res + y in the output
//     dtype (the residual add: f32 for the int8 decoder's stream, bf16
//     rounded for the bf16 decoder's);
//   logits: y = acc (f32), times the f32 row scale where one is given;
//   the output row m lands at out + m * row_stride (+ *slot * N where a
//   slot is given: the k and v rows written straight into the cache at
//   the decode step's slot, read from device memory), as bf16 or f32.
//
// What bounds it on an H100: bytes, and at the decode step's 3-64 rows
// the launch's fixed cost. Each weight byte meets at most 64 rows, ~128
// FLOP per int8 byte: under the bf16 tensor-core ridge (~295 per byte) but
// well above what f32 FMAs keep up with (~20), so the products run on the
// tensor cores. A 1280 x 1280 int8 weight takes 0.5 us of bytes, less than
// one launch; the step is ~11 launches a layer, so the design cuts
// launches and overlaps each with its predecessor:
// - Programmatic dependent launch. The kernel is launched with the
//   programmatic-stream-serialization attribute (launch_cluster_pdl): it
//   may start while its predecessor still runs. Before griddepcontrol.wait
//   a block reads only what no kernel of the step writes -- its first batch
//   of weight chunks, its channels' scale and bias, its share of the layer
//   norm's parameters -- so the weight stream starts during the
//   predecessor's epilogue. After the wait it reads x and writes. Once its
//   main loop has issued every load it signals
//   griddepcontrol.launch_dependents (never before its own wait, so a
//   dependent never starts while a kernel two launches back still runs),
//   and the next kernel's weights stream while this one reduces and stores.
// - Segments. Up to three weights that share x (the self-attention's q, k
//   and v) are laid out along the grid's y axis, each with its own scale,
//   bias, output and epilogue: one launch instead of three, and no
//   stacked copy of the weights.
// - The layer norm's statistics. A block stages only its share of K; the
//   statistics need the full row. Each block computes (mean, M2) of its
//   share per row (a warp per 32-item chunk of a row, chunks combined in
//   order), pushes them to every block of the cluster over distributed
//   shared memory, and every block combines the R shares in rank order
//   (Chan's parallel update), so all hold the same bits. (Each block
//   reading the whole rows itself instead, no exchange, was no faster at
//   3 rows and the cluster sizes the plan picks: chip_smoke.py phase 2.)
//
// The product. Weights are read straight from device memory into
// registers (each element is used by one warp only): a warp owns 16 output
// channels (the m16 rows of mma.sync m16n8k16) and walks its block's share
// of K in chunks of 64 bytes per row, each lane loading 16 contiguous
// bytes of rows g and g + 8 -- int8 widened to bf16 in registers (exact:
// byte permutes into an f32 magic number, no I2F) -- with the next chunks'
// loads in flight while the current ones compute. x is staged once per
// block in shared memory as bf16 planes: one plane for bf16 compute, three
// for f32 x in f32 compute (x = hi + mid + lo exactly), rows padded so that
// the fragment loads hit distinct banks. A block is 4 warps (64 channels);
// a cluster of R <= 8 blocks along x splits K into R contiguous shares so
// that enough blocks fill the card when N is small, and the R partial
// [rows, 64] sums are pushed over distributed shared memory to the block
// that owns each slice and summed there in rank order (deterministic, no
// atomics, no workspace), then finished by the epilogue above. The ragged
// N edge (51 866 = 810 * 64 + 26) loads clamped rows and masks their
// outputs. The grid (R, sum of ceil(N_s / 64)) comes from the shapes alone.
#include <type_traits>

#include "split_softmax.cuh"

namespace cg = cooperative_groups;

// one weight of a launch and what its epilogue does (ops/kernels.py
// _GemvSeg mirrors the layout)
struct GemvSeg {
  const void* w;          // [n, K] int8 or bf16
  const float* scale;     // [n] f32 or null
  const void* bias;       // [n] (f32 when b_f32, else bf16) or null
  void* out;              // output row m at out + m * row_stride (+ slot)
  const void* residual;   // [M, n] in the output's dtype, or null
  const float* post;      // [M / post_rows, n] f32 or null
  const int* slot;        // device slot or null: rows land at *slot * n
  long long row_stride;   // elements between output rows
  int n;                  // output channels
  int b_f32;              // bias dtype
  int out_bf16;           // output stored as bf16 (else f32)
  int logits;             // f32 product (times the scale), no rounding
  int gelu;               // exact GELU after the bias
  int post_rows;          // rows per post row
  float mul;              // != 0: y = dt(y * mul) after the bias
  float post_s;           // post's scalar
};

namespace {

namespace sp = nt::split;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BN = 16 * NWARPS;          // output channels of a block
constexpr int CHUNK_BYTES = 64;          // bytes of a weight row per chunk
constexpr int MAX_SEGS = 3;
constexpr int LN_ITEMS = 32;             // 8-element items of a stats chunk
constexpr int LN_UNROLL = 4;             // stats chunks in flight per warp

struct Segs {
  GemvSeg s[MAX_SEGS];
  int tile0[MAX_SEGS + 1];   // first blockIdx.y of each segment, then end
  int nseg;
};

// the four signed bytes of w as exact f32: each biased byte (k + 128) goes
// into the mantissa of 2^23 (0x4B0000xx), and 2^23 + 128 is subtracted
__device__ __forceinline__ void widen4(unsigned w, float* f) {
  const unsigned x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float gelu_erf(float y) {
  return y * 0.5f * (1.f + erff(y * 0.70710678118654752440f));
}

// Chan's parallel update: (n, mean, m2) += (nb, mb, m2b)
__device__ __forceinline__ void chan_add(float& n, float& mean, float& m2,
                                         float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb, d = mb - mean;
  mean += d * (nb / nn);
  m2 += m2b + d * d * (n * nb / nn);
  n = nn;
}

// 8 elements (f32 or bf16) from element offset `off`
__device__ __forceinline__ void load8(const void* xv, bool x_f32, size_t off,
                                      float* f) {
  if (x_f32) {
    nt::load16(static_cast<const float*>(xv) + off, f);
    nt::load16(static_cast<const float*>(xv) + off + 4, f + 4);
  } else {
    nt::load16(static_cast<const __nv_bfloat16*>(xv) + off, f);
  }
}

// x row stride in shared memory (elements): the block's k range rounded
// up to 64, plus a pad that puts row g + 1's fragment loads on other banks
// than row g's (int8 chunks: 32 bytes a lane, rows 16 bytes apart mod
// 128; bf16 chunks: 16 bytes a lane, rows 64 bytes apart)
__host__ __device__ inline int x_stride(int klen, bool w_int8) {
  return sp::align_up(klen, 64) + (w_int8 ? 8 : 32);
}

// the stats chunks of a row over slen columns
__host__ __device__ inline int ln_chunks(int slen) {
  return (slen / 8 + LN_ITEMS - 1) / LN_ITEMS;
}

// byte offsets of a block's shared memory: x's planes, the peers' partial
// sums of its slice, its channels' scale and bias; with the layer norm,
// its share of the norm's parameters (f32), the stats chunks [M][Q], the
// peers' share stats [R][M] and each row's (mean, rstd)
struct Layout {
  int recv, sc, bi, lnw, lnb, part, srecv, rowstat, bytes;
};

__host__ __device__ inline Layout layout(int rows_pad, int klen, bool w_int8,
                                         int planes, int M, int R, int ln) {
  Layout L;
  const int nout = M * BN;
  int o = planes * rows_pad * x_stride(klen, w_int8) * 2;
  L.recv = o;
  o += sp::align_up(R * ((nout + R - 1) / R) * 4, 16);
  L.sc = o;
  o += BN * 4;
  L.bi = o;
  o += BN * 4;
  L.lnw = L.lnb = L.part = L.srecv = L.rowstat = o;
  if (ln) {
    L.lnw = o;
    o += klen * 4;
    L.lnb = o;
    o += klen * 4;
    L.part = o;
    o += M * ln_chunks(klen) * 8;
    L.srecv = o;
    o += R * M * 8;
    L.rowstat = o;
    o += M * 8;
  }
  L.bytes = o;
  return L;
}

// (mean, M2) of each row m < M of x over columns [s0, s0 + slen) into
// st[m]: a warp per chunk of LN_ITEMS 8-element items of a row (LN_UNROLL
// chunks' loads in flight), the chunks of a row combined in order by one
// thread. Ends with the block synchronized.
__device__ void range_stats(const void* xv, bool x_f32, int M, int K, int s0,
                            int slen, float2* part, float2* st) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nitem = slen / 8, Q = ln_chunks(slen), units = M * Q;
  for (int u0 = warp; u0 < units; u0 += LN_UNROLL * NWARPS) {
    float f[LN_UNROLL][8];
    bool ok[LN_UNROLL];
#pragma unroll
    for (int j = 0; j < LN_UNROLL; ++j) {
      const int u = u0 + j * NWARPS, m = u / Q, it = (u % Q) * LN_ITEMS + lane;
      ok[j] = u < units && it < nitem;
      if (ok[j])
        load8(xv, x_f32, (size_t)m * K + s0 + it * 8, f[j]);
    }
#pragma unroll
    for (int j = 0; j < LN_UNROLL; ++j) {
      const int u = u0 + j * NWARPS;
      if (u >= units) break;                 // warp-uniform
      const int c = min(LN_ITEMS, nitem - (u % Q) * LN_ITEMS) * 8;
      float s = 0.f;
      if (ok[j])
#pragma unroll
        for (int e = 0; e < 8; ++e) s += f[j][e];
      const float mean = nt::warp_sum(s) / (float)c;
      float d2 = 0.f;
      if (ok[j])
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = f[j][e] - mean;
          d2 = fmaf(d, d, d2);
        }
      d2 = nt::warp_sum(d2);
      if (lane == 0) part[u] = make_float2(mean, d2);
    }
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += NTHREADS) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int q = 0; q < Q; ++q) {
      const float2 p = part[m * Q + q];
      chan_add(n, mean, m2, (float)(min(LN_ITEMS, nitem - q * LN_ITEMS) * 8),
               p.x, p.y);
    }
    st[m] = make_float2(mean, m2);
  }
  __syncthreads();
}

// NT tiles of 8 rows; U chunks a batch in flight per warp beside the batch
// computing
template <typename W, int NT, int PLANES>
__global__ void __launch_bounds__(NTHREADS)
decode_gemv_kernel(const void* __restrict__ xv, const Segs segs, int M, int K,
                   int x_f32, int dt_bf16, const void* __restrict__ ln_w,
                   const void* __restrict__ ln_b, float ln_eps, int ln_f32,
                   int ln) {
  constexpr bool W8 = std::is_same<W, int8_t>::value;
  constexpr int CK = CHUNK_BYTES / (int)sizeof(W);   // k of a chunk
  constexpr int KSC = CK / 16;                       // mma k-steps a chunk
  constexpr int U = NT <= 4 ? 4 : 2;                 // chunks a batch
  constexpr int ROWS = 8 * NT;
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;
  // the block's segment (selected field by field: no dynamic index into
  // the parameters)
  const int by = (int)blockIdx.y;
  const int si = (segs.nseg > 1 && by >= segs.tile0[1]) +
                 (segs.nseg > 2 && by >= segs.tile0[2]);
  GemvSeg seg = segs.s[0];
  if (si == 1) seg = segs.s[1];
  if (si == 2) seg = segs.s[2];
  const int N = seg.n;
  const int n0 = (by - (si == 0   ? segs.tile0[0]
                        : si == 1 ? segs.tile0[1]
                                  : segs.tile0[2])) * BN;
  const int nck_all = K / CK;
  const sp::Share sh = sp::share_of(nck_all, R, rank);
  const int klen_max = ((nck_all + R - 1) / R) * CK;
  const int XS = x_stride(klen_max, W8);
  const int PS = ROWS * XS;                          // elements of a plane
  const int nout = M * BN, slice = (nout + R - 1) / R;
  const int k0 = sh.c0 * CK, klen = sh.len * CK;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(ROWS, klen_max, W8, PLANES, M, R, ln);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  // the block's channels' scale and bias, read at the start so that the
  // epilogue waits on no device memory
  float* sc_s = reinterpret_cast<float*>(smem + L.sc);
  float* bi_s = reinterpret_cast<float*>(smem + L.bi);
  float* lnw_s = reinterpret_cast<float*>(smem + L.lnw);
  float* lnb_s = reinterpret_cast<float*>(smem + L.lnb);
  float2* part = reinterpret_cast<float2*>(smem + L.part);
  float2* srecv = reinterpret_cast<float2*>(smem + L.srecv);
  float2* rowstat = reinterpret_cast<float2*>(smem + L.rowstat);

  sp::cluster_arrive();

  // --- before the wait: only what no kernel of the step writes ---------
  // this warp's two weight rows (clamped at the ragged edge; their outputs
  // are masked), from the share's first chunk; lane c4's 16 bytes of each
  const W* w = static_cast<const W*>(seg.w);
  const int r0 = min(n0 + 16 * warp + g, N - 1);
  const int r1 = min(n0 + 16 * warp + g + 8, N - 1);
  const size_t c_first = (size_t)sh.c0 * CHUNK_BYTES + c4 * 16;
  const unsigned char* p0 = reinterpret_cast<const unsigned char*>(w) +
                            (size_t)r0 * K * sizeof(W) + c_first;
  const unsigned char* p1 = reinterpret_cast<const unsigned char*>(w) +
                            (size_t)r1 * K * sizeof(W) + c_first;
  uint4 a0[U], a1[U];
  auto load_batch = [&](int c, uint4* b0, uint4* b1) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c + u < sh.len) {
        b0[u] = __ldg(reinterpret_cast<const uint4*>(p0 + (size_t)(c + u) *
                                                               CHUNK_BYTES));
        b1[u] = __ldg(reinterpret_cast<const uint4*>(p1 + (size_t)(c + u) *
                                                               CHUNK_BYTES));
      }
    }
  };
  load_batch(0, a0, a1);
  if (tid < BN) {
    const int n = min(n0 + tid, N - 1);
    sc_s[tid] = seg.scale ? seg.scale[n] : 1.f;
    bi_s[tid] = !seg.bias ? 0.f
                : seg.b_f32 ? static_cast<const float*>(seg.bias)[n]
                            : __bfloat162float(
                                  static_cast<const __nv_bfloat16*>(
                                      seg.bias)[n]);
  }
  if (ln) {
    // the share's norm parameters as f32, 8 elements a thread per pass (16
    // or 32 bytes of each, all loads in flight before any store)
    for (int i = tid * 8; i < klen; i += NTHREADS * 8) {
      float fw[8], fb[8];
      load8(ln_w, ln_f32, k0 + i, fw);
      load8(ln_b, ln_f32, k0 + i, fb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        lnw_s[i + j] = fw[j];
        lnb_s[i + j] = fb[j];
      }
    }
  }

  // --- after the wait: x, and every write ------------------------------
  sp::pdl_wait();
  bool waited = false;   // on the cluster barrier of the start
  if (ln) {
    // each row's (mean, rstd) over all K columns into rowstat: the share's
    // (mean, M2) per row, pushed to every block of the cluster and
    // combined in rank order
    range_stats(xv, x_f32, M, K, k0, klen, part, rowstat);
    if (R > 1) {
      sp::cluster_wait();   // every peer has started: pushes may begin
      waited = true;
      for (int i = tid; i < M * R; i += NTHREADS) {
        const int m = i % M, k = i / M;
        cluster.map_shared_rank(srecv, k)[rank * M + m] = rowstat[m];
      }
      cluster.sync();
    } else {
      for (int m = tid; m < M; m += NTHREADS) srecv[m] = rowstat[m];
      __syncthreads();
    }
    for (int m = tid; m < M; m += NTHREADS) {
      float n = 0.f, mean = 0.f, m2 = 0.f;
      for (int k = 0; k < R; ++k) {
        const float2 p = srecv[k * M + m];
        chan_add(n, mean, m2, (float)(sp::share_of(nck_all, R, k).len * CK),
                 p.x, p.y);
      }
      rowstat[m] = make_float2(mean, rsqrtf(m2 / (float)K + ln_eps));
    }
    __syncthreads();
  }

  // x's share of K as bf16 planes [PLANES][ROWS][XS]; rows past M zero.
  // 8 elements an item; a thread's items loaded 4 at a time before any is
  // stored, so that their L2 round trips overlap
  {
    const int per_row = klen / 8, n_items = ROWS * per_row;
    for (int i0 = tid; i0 < n_items; i0 += 4 * NTHREADS) {
      float f[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NTHREADS;
        const int m = i / per_row, e = (i % per_row) * 8;
        if (i < n_items && m < M) {
          load8(xv, x_f32, (size_t)m * K + k0 + e, f[u]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) f[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NTHREADS;
        if (i >= n_items) break;
        const int m = i / per_row, e = (i % per_row) * 8;
        if (ln && m < M) {
          const float2 rs = rowstat[m];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            f[u][j] = lnw_s[e + j] * (rs.y * (f[u][j] - rs.x)) + lnb_s[e + j];
        }
#pragma unroll
        for (int p = 0; p < PLANES; ++p) {
          __align__(16) __nv_bfloat16 hv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            hv[j] = __float2bfloat16_rn(f[u][j]);
            f[u][j] -= __bfloat162float(hv[j]);      // exact remainder
          }
          *reinterpret_cast<uint4*>(xs + p * PS + m * XS + e) =
              *reinterpret_cast<const uint4*>(hv);
        }
      }
    }
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (sh.len == 0) sp::pdl_launch_dependents();
  for (int c = 0; c < sh.len; c += U) {
    uint4 n0v[U], n1v[U];
    load_batch(c + U, n0v, n1v);
    // every load of the main loop issued: the next kernel may start
    if (c + U >= sh.len) sp::pdl_launch_dependents();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c + u >= sh.len) break;
      const uint32_t u0[4] = {a0[u].x, a0[u].y, a0[u].z, a0[u].w};
      const uint32_t u1[4] = {a1[u].x, a1[u].y, a1[u].z, a1[u].w};
      // A fragments of the chunk's KSC k-steps: k-step s covers the
      // lane's elements 4s .. 4s + 3 of each row
      uint32_t af[KSC][4];
#pragma unroll
      for (int s = 0; s < KSC; ++s) {
        if constexpr (W8) {
          float f0[4], f1[4];
          widen4(u0[s], f0);
          widen4(u1[s], f1);
          af[s][0] = sp::pack_exact(f0[0], f0[1]);
          af[s][1] = sp::pack_exact(f1[0], f1[1]);
          af[s][2] = sp::pack_exact(f0[2], f0[3]);
          af[s][3] = sp::pack_exact(f1[2], f1[3]);
        } else {
          af[s][0] = u0[2 * s];
          af[s][1] = u1[2 * s];
          af[s][2] = u0[2 * s + 1];
          af[s][3] = u1[2 * s + 1];
        }
      }
      // B fragments: x row 8j + g at the same k (the lane's 4 * KSC
      // elements of the chunk, contiguous in the plane)
      const int kk = (c + u) * CK + c4 * (CK / 4);
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* xr = xs + p * PS + (8 * j + g) * XS + kk;
          uint32_t xb[2 * KSC];
#pragma unroll
          for (int hq = 0; hq < KSC / 2; ++hq) {
            const uint4 v4 = reinterpret_cast<const uint4*>(xr)[hq];
            xb[4 * hq] = v4.x, xb[4 * hq + 1] = v4.y, xb[4 * hq + 2] = v4.z,
            xb[4 * hq + 3] = v4.w;
          }
#pragma unroll
          for (int s = 0; s < KSC; ++s)
            sp::mma_bf16(acc[j], af[s][0], af[s][1], af[s][2], af[s][3],
                         xb[2 * s], xb[2 * s + 1]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a0[u] = n0v[u];
      a1[u] = n1v[u];
    }
  }

  // acc[j]: (channel 16w + g, row 8j + 2c4), (16w + g, 8j + 2c4 + 1),
  // (16w + g + 8, 8j + 2c4), (16w + g + 8, 8j + 2c4 + 1); output index
  // row * BN + channel, pushed to the block owning its slice
  if (!waited) sp::cluster_wait();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 8 * j + 2 * c4 + (e & 1);
      const int chn = 16 * warp + g + 8 * (e >> 1);
      if (m < M) sp::push_partial(cluster, recv, m * BN + chn, acc[j][e],
                                  slice, rank);
    }
  cluster.sync();

  const size_t slot_off = seg.slot ? (size_t)(*seg.slot) * N : 0;
  sp::sum_received<NTHREADS>(recv, nout, slice, R, rank, [&](int idx,
                                                             float y) {
    const int m = idx / BN, c = idx % BN, n = n0 + c;
    if (n >= N) return;
    const size_t o = (size_t)m * seg.row_stride + slot_off + n;
    if (seg.logits) {
      if (seg.scale) y = __fmul_rn(y, sc_s[c]);
      static_cast<float*>(seg.out)[o] = y;
      return;
    }
    if (dt_bf16) {
      y = bf16r(y);
      if (seg.scale) y = bf16r(__fmul_rn(y, bf16r(sc_s[c])));
      if (seg.bias) y = bf16r(__fadd_rn(y, bf16r(bi_s[c])));
      if (seg.post)
        y = bf16r(__fmul_rn(__fmul_rn(y, seg.post_s),
                            seg.post[(size_t)(m / seg.post_rows) * N + n]));
      if (seg.mul != 0.f) y = bf16r(__fmul_rn(y, seg.mul));
      if (seg.gelu) y = bf16r(gelu_erf(y));
    } else {
      if (seg.scale) y = __fmul_rn(y, sc_s[c]);
      if (seg.bias) y = __fadd_rn(y, bi_s[c]);
      if (seg.post)
        y = __fmul_rn(__fmul_rn(y, seg.post_s),
                      seg.post[(size_t)(m / seg.post_rows) * N + n]);
      if (seg.mul != 0.f) y = __fmul_rn(y, seg.mul);
      if (seg.gelu) y = gelu_erf(y);
    }
    if (seg.out_bf16) {
      if (seg.residual)
        y = __fadd_rn(__bfloat162float(static_cast<const __nv_bfloat16*>(
                          seg.residual)[(size_t)m * N + n]),
                      y);
      static_cast<__nv_bfloat16*>(seg.out)[o] = __float2bfloat16_rn(y);
    } else {
      if (seg.residual)
        y = __fadd_rn(
            static_cast<const float*>(seg.residual)[(size_t)m * N + n], y);
      static_cast<float*>(seg.out)[o] = y;
    }
  });
}

template <typename W, int NT, int PLANES>
int launch(const void* x, const Segs& segs, int M, int K, int x_f32,
           int dt_bf16, const void* ln_w, const void* ln_b, float ln_eps,
           int ln_f32, int ln, int R, cudaStream_t st) {
  constexpr bool W8 = std::is_same<W, int8_t>::value;
  constexpr int CK = CHUNK_BYTES / (int)sizeof(W);
  const int nck = K / CK;
  const int klen = ((nck + R - 1) / R) * CK;
  const size_t smem = layout(8 * NT, klen, W8, PLANES, M, R, ln).bytes;
  return sp::launch_cluster_pdl<decode_gemv_kernel<W, NT, PLANES>>(
      R, segs.tile0[segs.nseg], 1, NTHREADS, smem, st, x, segs, M, K, x_f32,
      dt_bf16, ln_w, ln_b, ln_eps, ln_f32, ln);
}

template <typename W, int PLANES>
int launch_nt(int NT, const void* x, const Segs& segs, int M, int K,
              int x_f32, int dt_bf16, const void* ln_w, const void* ln_b,
              float ln_eps, int ln_f32, int ln, int R, cudaStream_t st) {
  switch (NT) {
#define NT_GEMV_CASE(T)                                                    \
  case T:                                                                  \
    return launch<W, T, PLANES>(x, segs, M, K, x_f32, dt_bf16, ln_w, ln_b, \
                                ln_eps, ln_f32, ln, R, st);
    NT_GEMV_CASE(1) NT_GEMV_CASE(2) NT_GEMV_CASE(4) NT_GEMV_CASE(6)
    NT_GEMV_CASE(8)
#undef NT_GEMV_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [M, K] (f32 when x_f32, else bf16), the raw residual stream when ln;
// segs[0 .. nseg) the weights (int8 when w_int8, else bf16; all [n_s, K])
// with their epilogues (GemvSeg); ln_w, ln_b [K] (f32 when ln_f32, else
// bf16) the layer norm applied to x when ln, its row statistics exchanged
// over the cluster. Every pointer 16-byte aligned and every
// tensor contiguous; K % 64 == 0; NT in {1, 2, 4, 6, 8} with 8 * NT >= M;
// planes 3 (f32 x in f32 compute) or 1; R the cluster size (1..8). The
// launch carries the programmatic-stream-serialization attribute. Returns
// cudaGetLastError() of the launch.
extern "C" int decode_gemv(const void* x, int M, int K, int nseg,
                           const GemvSeg* segs_in, const void* ln_w,
                           const void* ln_b, float ln_eps, int ln_f32,
                           int ln, int NT, int planes, int R, int x_f32,
                           int w_int8, int dt_bf16, void* stream) {
  if (M < 1 || 8 * NT < M || K < 64 || K % 64 || R < 1 ||
      R > sp::MAX_CLUSTER || (planes != 1 && planes != 3) || nseg < 1 ||
      nseg > MAX_SEGS || (ln && (!ln_w || !ln_b)))
    return (int)cudaErrorInvalidValue;
  Segs segs = {};
  segs.nseg = nseg;
  segs.tile0[0] = 0;
  for (int i = 0; i < nseg; ++i) {
    const GemvSeg& s = segs_in[i];
    if (s.n < 1 || !s.w || !s.out ||
        (s.post && (s.post_rows < 1 || M % s.post_rows)))
      return (int)cudaErrorInvalidValue;
    segs.s[i] = s;
    segs.tile0[i + 1] = segs.tile0[i] + (s.n + BN - 1) / BN;
  }
  if (segs.tile0[nseg] > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_int8)
    return planes == 3
               ? launch_nt<int8_t, 3>(NT, x, segs, M, K, x_f32, dt_bf16, ln_w,
                                      ln_b, ln_eps, ln_f32, ln, R, st)
               : launch_nt<int8_t, 1>(NT, x, segs, M, K, x_f32, dt_bf16, ln_w,
                                      ln_b, ln_eps, ln_f32, ln, R, st);
  return planes == 3
             ? launch_nt<__nv_bfloat16, 3>(NT, x, segs, M, K, x_f32, dt_bf16,
                                           ln_w, ln_b, ln_eps, ln_f32, ln, R,
                                           st)
             : launch_nt<__nv_bfloat16, 1>(NT, x, segs, M, K, x_f32, dt_bf16,
                                           ln_w, ln_b, ln_eps, ln_f32, ln, R,
                                           st);
}
