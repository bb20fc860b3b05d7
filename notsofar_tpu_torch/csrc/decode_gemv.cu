// decode_gemv: a few rows of activations times a weight matrix read once
// in its stored type (int8 or bf16), for the decode step's dense layers
// and output logits.
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA,
// whose convert fuses into the dot's operand read (notsofar_tpu/models/
// whisper.py QuantDense :76-97, the logits einsums :502-507). The port's
// matmul path widened the whole int8 weight to bf16 (QuantDense) or the
// embedding to f32 (logits) in device memory on every call instead
// (decode_gemv_plain holds the rounding points). Same function, y [M, N]
// from x [M, K] and weight w [N, K]:
//   x is rounded to the compute dtype (bf16 or f32) on its way in;
//   acc = f32 sum_k x[m, k] * w[n, k] (w int8 or bf16, exact in bf16);
//   dense (QuantDense): y = dt(acc), y = dt(y * dt(scale[n])),
//     y = dt(y + dt(bias[n])), each rounded to the compute dtype dt, the
//     scale never folded into the weight, the bias never in the product;
//     optionally then y = dt((y * s) * post[m / post_rows, n]) in f32 (the
//     int8 cross-attention's query: q_eff = ((q * s) * (k_scale * s))
//     rounded, the reference's fusion of it into the query's dot);
//   logits: y = acc (f32), times the f32 row scale where one is given.
//
// What bounds it on an H100: bytes. At the decode step's 3-64 rows each
// weight byte meets at most 64 rows, ~128 FLOP per int8 byte: under the
// bf16 tensor-core ridge (~295 per byte) but well above what f32 FMAs
// keep up with (~20), so the products run on the tensor cores.
//
// Design. Weights are read straight from device memory into registers
// (each element is used by one warp only): a warp owns 16 output channels
// (the m16 rows of mma.sync m16n8k16) and walks its block's share of K in
// chunks of 64 bytes per row, each lane loading 16 contiguous bytes of
// rows g and g + 8 -- int8 widened to bf16 in registers (exact: byte
// permutes into an f32 magic number, no I2F) -- with the next chunks'
// loads in flight while the current ones compute. The chunk's elements are
// dealt to the fragments in the order the lane loaded them (a product's
// k order is free), and the x rows are the mma's n8 columns (up to 8 tiles
// of 8 rows). x is staged once per block in shared memory as bf16 planes:
// one plane for bf16 compute (or bf16 x in f32 compute), three for f32 x
// in f32 compute (x = hi + mid + lo exactly, each plane's products exact,
// summed in the same f32 accumulators), rows padded so that the fragment
// loads hit distinct banks. A block is 4 warps (64 channels, so that x is
// staged once for 64 channels; 4 warps splitting one 16-channel tile's K
// were no faster at 3 rows and up to 2x slower at 15-48, as each warp
// then reads x's fragments for 16 channels only); a cluster of R <= 8
// blocks along x splits K into R contiguous shares so that enough blocks
// fill the card when N is small (N = 1280), and the R partial [rows, 64]
// sums are pushed over distributed shared memory to the block that owns
// each slice and summed there in rank order (deterministic, no atomics,
// no workspace), then rounded, scaled and biased as above; where the
// caller adds the result to an f32 stream, the rounded result is stored
// as f32. The ragged N edge (51 866 = 810 * 64 + 26) loads clamped rows
// and masks their outputs. The grid (R, ceil(N / 64)) comes from the
// shapes alone.
#include <type_traits>

#include "split_softmax.cuh"

namespace cg = cooperative_groups;

namespace {

namespace sp = nt::split;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BN = 16 * NWARPS;          // output channels of a block
constexpr int CHUNK_BYTES = 64;          // bytes of a weight row per chunk

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

// x row stride in shared memory (elements): the block's k range rounded
// up to 64, plus a pad that puts row g + 1's fragment loads on other banks
// than row g's (int8 chunks: 32 bytes a lane, rows 16 bytes apart mod
// 128; bf16 chunks: 16 bytes a lane, rows 64 bytes apart)
__host__ __device__ inline int x_stride(int klen, bool w_int8) {
  return sp::align_up(klen, 64) + (w_int8 ? 8 : 32);
}

// bytes of a block's shared memory: x's planes, the peers' partial sums
// of its slice, its channels' scale and bias
__host__ __device__ inline int smem_bytes(int rows_pad, int klen,
                                          bool w_int8, int planes, int M,
                                          int R) {
  const int nout = M * BN;
  return planes * rows_pad * x_stride(klen, w_int8) * 2 +
         sp::align_up(R * ((nout + R - 1) / R) * 4, 16) + 2 * BN * 4;
}

// NT tiles of 8 rows; U chunks a batch in flight per warp beside the batch
// computing
template <typename W, int NT, int PLANES>
__global__ void __launch_bounds__(NTHREADS)
decode_gemv_kernel(const void* __restrict__ xv, const W* __restrict__ w,
                   const float* __restrict__ scale,
                   const void* __restrict__ bias, void* __restrict__ out,
                   int M, int N, int K, int x_f32, int dt_bf16, int b_f32,
                   int logits, int out_f32, const float* __restrict__ post,
                   float post_s, int post_rows) {
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
  const int n0 = blockIdx.y * BN;
  const int nck_all = K / CK;
  const sp::Share sh = sp::share_of(nck_all, R, rank);
  const int klen_max = ((nck_all + R - 1) / R) * CK;
  const int XS = x_stride(klen_max, W8);
  const int PS = ROWS * XS;                          // elements of a plane
  const int nout = M * BN, slice = (nout + R - 1) / R;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* recv = reinterpret_cast<float*>(smem + PLANES * PS * 2);
  // the block's channels' scale and bias, read at the start so that the
  // epilogue waits on no device memory
  float* sc_s = recv + sp::align_up(R * slice, 4);
  float* bi_s = sc_s + BN;

  sp::cluster_arrive();

  // this warp's two weight rows (clamped at the ragged edge; their outputs
  // are masked), from the share's first chunk; lane c4's 16 bytes of each
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
    sc_s[tid] = scale ? scale[n] : 1.f;
    bi_s[tid] = !bias ? 0.f
                : b_f32 ? static_cast<const float*>(bias)[n]
                        : __bfloat162float(
                              static_cast<const __nv_bfloat16*>(bias)[n]);
  }

  // x's share of K as bf16 planes [PLANES][ROWS][XS]; rows past M zero.
  // 8 elements an item; a thread's items loaded 4 at a time before any is
  // stored, so that their L2 round trips overlap
  {
    const int k0 = sh.c0 * CK, klen = sh.len * CK;
    const int per_row = klen / 8, n_items = ROWS * per_row;
    for (int i0 = tid; i0 < n_items; i0 += 4 * NTHREADS) {
      float f[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NTHREADS;
        const int m = i / per_row, e = (i % per_row) * 8;
        if (i < n_items && m < M) {
          const size_t off = (size_t)m * K + k0 + e;
          if (x_f32) {
            nt::load16(static_cast<const float*>(xv) + off, f[u]);
            nt::load16(static_cast<const float*>(xv) + off + 4, f[u] + 4);
          } else {
            nt::load16(static_cast<const __nv_bfloat16*>(xv) + off, f[u]);
          }
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

  for (int c = 0; c < sh.len; c += U) {
    uint4 n0v[U], n1v[U];
    load_batch(c + U, n0v, n1v);
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
  sp::cluster_wait();
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

  sp::sum_received<NTHREADS>(recv, nout, slice, R, rank, [&](int idx,
                                                             float y) {
    const int m = idx / BN, c = idx % BN, n = n0 + c;
    if (n >= N) return;
    const size_t o = (size_t)m * N + n;
    if (logits) {
      if (scale) y = __fmul_rn(y, sc_s[c]);
      static_cast<float*>(out)[o] = y;
      return;
    }
    if (dt_bf16) {
      y = bf16r(y);
      if (scale) y = bf16r(__fmul_rn(y, bf16r(sc_s[c])));
      if (bias) y = bf16r(__fadd_rn(y, bf16r(bi_s[c])));
      if (post)
        y = bf16r(__fmul_rn(__fmul_rn(y, post_s),
                            post[(size_t)(m / post_rows) * N + n]));
      if (out_f32)
        static_cast<float*>(out)[o] = y;
      else
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    } else {
      if (scale) y = __fmul_rn(y, sc_s[c]);
      if (bias) y = __fadd_rn(y, bi_s[c]);
      if (post)
        y = __fmul_rn(__fmul_rn(y, post_s),
                      post[(size_t)(m / post_rows) * N + n]);
      static_cast<float*>(out)[o] = y;
    }
  });
}

template <typename W, int NT, int PLANES>
int launch(const void* x, const void* w, const float* scale,
           const void* bias, void* out, int M, int N, int K, int x_f32,
           int dt_bf16, int b_f32, int logits, int out_f32,
           const float* post, float post_s, int post_rows, int R,
           cudaStream_t st) {
  constexpr bool W8 = std::is_same<W, int8_t>::value;
  constexpr int CK = CHUNK_BYTES / (int)sizeof(W);
  const int nck = K / CK;
  const int klen = ((nck + R - 1) / R) * CK;
  const size_t smem = smem_bytes(8 * NT, klen, W8, PLANES, M, R);
  return sp::launch_cluster<decode_gemv_kernel<W, NT, PLANES>>(
      R, (N + BN - 1) / BN, 1, NTHREADS, smem, st, x,
      static_cast<const W*>(w), scale, bias, out, M, N, K, x_f32, dt_bf16,
      b_f32, logits, out_f32, post, post_s, post_rows);
}

template <typename W, int PLANES>
int launch_nt(int NT, const void* x, const void* w, const float* scale,
              const void* bias, void* out, int M, int N, int K, int x_f32,
              int dt_bf16, int b_f32, int logits, int out_f32,
              const float* post, float post_s, int post_rows, int R,
              cudaStream_t st) {
  switch (NT) {
#define NT_GEMV_CASE(T)                                                    \
  case T:                                                                  \
    return launch<W, T, PLANES>(x, w, scale, bias, out, M, N, K, x_f32,    \
                                dt_bf16, b_f32, logits, out_f32, post,     \
                                post_s, post_rows, R, st);
    NT_GEMV_CASE(1) NT_GEMV_CASE(2) NT_GEMV_CASE(4) NT_GEMV_CASE(6)
    NT_GEMV_CASE(8)
#undef NT_GEMV_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [M, K] (f32 when x_f32, else bf16); w [N, K] int8 (w_int8) or bf16;
// scale [N] f32 or null; bias [N] (f32 when b_f32, else bf16) or null;
// out [M, N]: f32 for logits, else the compute dtype (bf16 when dt_bf16,
// else f32), or f32 holding the rounded values when out_f32; post null or
// [M / post_rows, N] f32 (dense only). All contiguous and 16-byte
// aligned; K % 64 == 0; NT in {1, 2, 4, 6, 8} with 8 * NT >= M; planes 3
// (f32 x in f32 compute) or 1; R the cluster size (1..8, at most K / 64
// for int8, K / 32 for bf16). Returns cudaGetLastError() of the launch.
extern "C" int decode_gemv(const void* x, const void* w, const float* scale,
                           const void* bias, void* out, int M, int N, int K,
                           int NT, int planes, int R, int x_f32, int w_int8,
                           int dt_bf16, int b_f32, int logits, int out_f32,
                           const float* post, float post_s, int post_rows,
                           void* stream) {
  if (M < 1 || 8 * NT < M || N < 1 || K % 64 || R < 1 ||
      R > sp::MAX_CLUSTER || (planes != 1 && planes != 3) ||
      (post && (post_rows < 1 || M % post_rows)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_int8)
    return planes == 3
               ? launch_nt<int8_t, 3>(NT, x, w, scale, bias, out, M, N, K,
                                      x_f32, dt_bf16, b_f32, logits, out_f32,
                                      post, post_s, post_rows, R, st)
               : launch_nt<int8_t, 1>(NT, x, w, scale, bias, out, M, N, K,
                                      x_f32, dt_bf16, b_f32, logits, out_f32,
                                      post, post_s, post_rows, R, st);
  return planes == 3
             ? launch_nt<__nv_bfloat16, 3>(NT, x, w, scale, bias, out, M, N,
                                           K, x_f32, dt_bf16, b_f32, logits,
                                           out_f32, post, post_s, post_rows,
                                           R, st)
             : launch_nt<__nv_bfloat16, 1>(NT, x, w, scale, bias, out, M, N,
                                           K, x_f32, dt_bf16, b_f32, logits,
                                           out_f32, post, post_s, post_rows,
                                           R, st);
}
