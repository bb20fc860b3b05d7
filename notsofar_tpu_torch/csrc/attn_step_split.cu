// attn_step_split: one beam-search decode step of Whisper self-attention
// over a split KV cache.
//
// Replaces notsofar_tpu/ops/pallas_kernels.py::attn_step_split (wrapper
// :334, pallas_call :395, body :270). Same function: stream b's K beam
// queries (q [B*K, 1, D], dk**-0.5 folded, cache dtype) attend over the
// stream's prompt segment kp/vp [B, Pp, D] — shared by its K beams — and
// over the per-beam generated segments kg/vg [B*K, G, D]. Prompt column c
// is visible iff c >= pad[b]; generated column (j', s) is visible to beam
// j iff s <= gslot and j' == anc[b, j, s] (j' == j without anc). Masked
// logits are -1e30; f32 softmax; weights normalized and then rounded to the
// cache dtype; p.v in f32; f32 output [B*K, 1, D]. Any K.
//
// What bounds it on an H100: bytes. Every prompt key/value row is read
// ONCE per stream for all K beams and every generated row once, with
// ~4*dk*K FLOP per row. Generated slots past gslot have weight exactly 0
// for every beam, so only slots 0..gslot are read, and a generated row that
// no beam sees (ancestry) is not read at all.
//
// Design. A (head, stream) pair is a thread-block cluster of R blocks
// along z (grid (H, B, R), R <= 8, chosen by the wrapper from Pp + K*G).
// The n = Pp + K*(gslot+1) in-use columns are cut into R contiguous
// shares; block r reads its share's key rows once, one thread per column,
// and forms the logits of all K beams with plain f32 FMAs against the
// queries in shared memory (no per-beam shuffle chain; beams go 8 at a
// time through registers). Each block keeps the per-beam max and sum of
// exp of its share; after a cluster barrier every block reads all R
// peers' (max, sum) through distributed shared memory and combines them in
// rank order, so every block holds bit-identical global statistics. Each
// block then forms p = round(exp(s - m) / l) for its share, at the TPU
// kernel's rounding point, and its share of p.v in f32. After a second
// cluster barrier the blocks sum the R partial [K, dk] outputs in rank
// order over distributed shared memory, each block a 1/R slice of the
// outputs, and a last barrier keeps every block alive until its peers
// have read its shared memory. A block whose share is empty still takes
// part in every barrier. Per-beam state lives in shared memory sized by K
// (no beam limit; the wrapper raises where a block would pass 227 KB).
// gslot comes by value or, when gslot_ptr is not NULL, from device memory
// (the grid depends on G only, so the launch can be captured in a CUDA
// graph while gslot advances).
#include <cooperative_groups.h>

#include "kernel_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int JG = 8;             // beams per register group
constexpr int MAX_CLUSTER = 8;    // portable cluster size

// shared memory of one block, in 4-byte words: queries [K][DK], partial-sum
// scratch [NWARPS][JG][DK], partial output [K][DK], local stats [K][2],
// peers' stats [R][K][2], global stats [K][2], ancestry owners [K][G],
// logits -> weights [K][per], column-seen flags [per]
__host__ __device__ inline size_t smem_words(int K, int G, int per, int dk,
                                             int R) {
  return (size_t)K * dk + (size_t)K * G + (size_t)K * per + per +
         (size_t)NWARPS * JG * dk + (size_t)K * dk + (4 + 2 * (size_t)R) * K;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// bring a dk-wide row into L2 ahead of its load (128-byte lines)
template <typename T, int DK>
__device__ __forceinline__ void prefetch_row(const T* row) {
#pragma unroll
  for (int b = 0; b < DK * (int)sizeof(T); b += 128)
    prefetch_l2(reinterpret_cast<const char*>(row) + b);
}

// three blocks per SM: the 320 blocks of a 2-stream beam-5 step then run
// in one wave (at most 85 registers a thread; a few spill at dk = 128)
template <typename T, int DK>
__global__ void __launch_bounds__(NTHREADS, 3)
attn_step_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const T* __restrict__ kg,
                       const T* __restrict__ vg, const int* __restrict__ pads,
                       const int* __restrict__ anc,
                       const int* __restrict__ gslot_ptr,
                       float* __restrict__ out, int K, int Pp, int G, int D,
                       int gslot, int per) {
  constexpr int VEC = nt::Vec<T>::N;
  constexpr int NCH = DK / VEC;            // 16-byte chunks per row
  constexpr int NGV = NTHREADS / NCH;      // column groups of the p.v pass
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // gslot outside [0, G) would read outside the cache: clamp
  const int gs = min(max(gslot_ptr ? *gslot_ptr : gslot, 0), G - 1);
  const int ng = gs + 1;                   // generated slots in use
  const int n = Pp + K * ng;               // prompt cols, then (j', s)
  const int share = (n + R - 1) / R;
  const int c0 = min(rank * share, n), len = min(c0 + share, n) - c0;

  // the arrays read as float4 / float2 first, so that they stay aligned
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                    // [K][DK]
  float* red = qs + K * DK;                            // [NWARPS][JG][DK]
  float* part = red + NWARPS * JG * DK;                // [K][DK]
  float* stats = part + K * DK;                        // [K][2] local
  float* peer = stats + 2 * K;                         // [R][K][2]
  float* gstat = peer + 2 * R * K;                     // [K][2] global
  int* owner = reinterpret_cast<int*>(gstat + 2 * K);  // [K][G]
  float* lg = reinterpret_cast<float*>(owner + K * G); // [K][per]
  int* seen = reinterpret_cast<int*>(lg + K * per);    // [per]

  // row of share column i (prompt, or generated (jp, s)); jp = -1 for the
  // prompt
  auto locate = [&](const T* prompt, const T* gen, int i, int& jp,
                    int& s) -> const T* {
    const int col = c0 + i;
    if (col < Pp) {
      jp = -1;
      s = col;
      return prompt + ((size_t)b * Pp + col) * D + h * DK;
    }
    const int r = col - Pp;
    jp = r / ng;
    s = r - jp * ng;
    return gen + ((size_t)(b * K + jp) * G + s) * D + h * DK;
  };

  // start every key row of the share on its way from device memory before
  // the queries and ancestry are staged (value rows follow once a column
  // is known to be seen), so the block waits for one round trip, not three
  for (int i = tid; i < len; i += NTHREADS) {
    int jp, s;
    prefetch_row<T, DK>(locate(kp, kg, i, jp, s));
  }

  const int pad = pads[b];
  for (int i = tid; i < K * DK; i += NTHREADS) {
    const int j = i / DK, d = i % DK;
    qs[i] = static_cast<float>(q[(size_t)(b * K + j) * D + h * DK + d]);
  }
  // owner[j][s]: the physical beam row whose slot-s K/V is in beam j's
  // history
  if (anc != nullptr)
    for (int i = tid; i < K * ng; i += NTHREADS) {
      const int j = i / ng, s = i % ng;
      owner[j * G + s] = anc[((size_t)b * K + j) * G + s];
    }
  __syncthreads();

  auto visible = [&](int j, int jp, int s) -> bool {
    if (jp < 0) return s >= pad;
    return (anc != nullptr ? owner[j * G + s] : j) == jp;
  };

  // logits: one thread per column, its key row read once for all beams
  for (int i = tid; i < len; i += NTHREADS) {
    int jp, s;
    const T* krow = locate(kp, kg, i, jp, s);
    bool any = false;
    for (int j = 0; j < K; ++j) any |= visible(j, jp, s);
    seen[i] = any;
    if (any) prefetch_row<T, DK>(locate(vp, vg, i, jp, s));
    for (int j0 = 0; j0 < K; j0 += JG) {
      float acc[JG];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) acc[jj] = 0.f;
      if (any) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          float kv[VEC];
          nt::load16(krow + c * VEC, kv);
#pragma unroll
          for (int jj = 0; jj < JG; ++jj) {
            if (j0 + jj < K) {
              const float4* qj = reinterpret_cast<const float4*>(
                  qs + (j0 + jj) * DK + c * VEC);
#pragma unroll
              for (int e4 = 0; e4 < VEC / 4; ++e4) {
                const float4 qv = qj[e4];   // one broadcast read of 4
                acc[jj] = fmaf(qv.x, kv[4 * e4], acc[jj]);
                acc[jj] = fmaf(qv.y, kv[4 * e4 + 1], acc[jj]);
                acc[jj] = fmaf(qv.z, kv[4 * e4 + 2], acc[jj]);
                acc[jj] = fmaf(qv.w, kv[4 * e4 + 3], acc[jj]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) {
        const int j = j0 + jj;
        if (j < K)
          lg[j * per + i] = any && visible(j, jp, s) ? acc[jj] : nt::MASKED;
      }
    }
  }
  __syncthreads();

  // this share's max and sum of exp per beam, one warp per beam
  for (int j = warp; j < K; j += NWARPS) {
    const float* row = lg + j * per;
    float m = -INFINITY;
    for (int i = lane; i < len; i += 32) m = fmaxf(m, row[i]);
    m = nt::warp_max(m);
    float l = 0.f;
    for (int i = lane; i < len; i += 32) l += expf(row[i] - m);
    l = nt::warp_sum(l);
    if (lane == 0) {
      stats[2 * j] = m;
      stats[2 * j + 1] = l;
    }
  }
  cluster.sync();

  // global max and sum per beam from all shares, in rank order: the R
  // peers' (max, sum) pairs are read at once over distributed shared
  // memory, then combined locally
  for (int i = tid; i < R * K; i += NTHREADS) {
    const int r = i / K, j = i % K;
    const float2 st =
        reinterpret_cast<const float2*>(cluster.map_shared_rank(stats, r))[j];
    reinterpret_cast<float2*>(peer)[i] = st;
  }
  __syncthreads();
  for (int j = tid; j < K; j += NTHREADS) {
    float m = -INFINITY;
    for (int r = 0; r < R; ++r) m = fmaxf(m, peer[2 * (r * K + j)]);
    float l = 0.f;
    for (int r = 0; r < R; ++r) {
      const float* st = peer + 2 * (r * K + j);
      if (st[1] > 0.f) l += st[1] * expf(st[0] - m);
    }
    gstat[2 * j] = m;
    gstat[2 * j + 1] = l;
  }
  __syncthreads();

  // weights, normalized and then rounded to the cache dtype
  for (int idx = tid; idx < K * len; idx += NTHREADS) {
    const int j = idx / len, i = idx % len;
    float* w = lg + j * per + i;
    *w = nt::round_as(expf(*w - gstat[2 * j]) / gstat[2 * j + 1], vp);
  }
  __syncthreads();

  // this share's p.v: each value row read once for all K beams (JG at a
  // time); columns no beam sees have weight 0 and are skipped
  const int ch = tid % NCH, grp = tid / NCH;
  for (int j0 = 0; j0 < K; j0 += JG) {
    float acc[JG][VEC];
#pragma unroll
    for (int jj = 0; jj < JG; ++jj)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[jj][e] = 0.f;
    for (int i = grp; i < len; i += NGV) {
      if (!seen[i]) continue;
      int jp, s;
      const T* vrow = locate(vp, vg, i, jp, s);
      float vv[VEC];
      nt::load16(vrow + ch * VEC, vv);
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) {
        if (j0 + jj < K) {
          const float p = lg[(j0 + jj) * per + i];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[jj][e] = fmaf(p, vv[e], acc[jj][e]);
        }
      }
    }
    // sum the column groups: first a warp's groups by shuffles,
    // then the warps through shared memory
#pragma unroll
    for (int jj = 0; jj < JG; ++jj)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int off = NCH; off < 32; off *= 2)
          acc[jj][e] += __shfl_xor_sync(nt::FULL_MASK, acc[jj][e], off);
    if (lane < NCH) {
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int e4 = 0; e4 < VEC / 4; ++e4)
          reinterpret_cast<float4*>(red + (warp * JG + jj) * DK + ch * VEC)
              [e4] = make_float4(acc[jj][4 * e4], acc[jj][4 * e4 + 1],
                                 acc[jj][4 * e4 + 2], acc[jj][4 * e4 + 3]);
    }
    __syncthreads();
    for (int idx = tid; idx < JG * DK; idx += NTHREADS) {
      const int jj = idx / DK, d = idx % DK;
      if (j0 + jj < K) {
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) o += red[(w * JG + jj) * DK + d];
        part[(j0 + jj) * DK + d] = o;
      }
    }
    __syncthreads();
  }
  cluster.sync();

  // outputs: block r sums its 1/R slice of [K, dk] over the R shares, in
  // rank order
  const int nout = K * DK, slice = (nout + R - 1) / R;
  for (int idx = rank * slice + tid; idx < min(nout, (rank + 1) * slice);
       idx += NTHREADS) {
    float v[MAX_CLUSTER];   // the R loads in flight at once
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      v[r] = r < R ? cluster.map_shared_rank(part, r)[idx] : 0.f;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < R) o += v[r];
    const int j = idx / DK, d = idx % DK;
    out[(size_t)(b * K + j) * D + h * DK + d] = o;
  }
  cluster.sync();   // peers may still read this block's part[]
}

template <typename T, int DK>
int launch(const void* q, const void* kp, const void* vp, const void* kg,
           const void* vg, const int* pads, const int* anc,
           const int* gslot_ptr, float* out, int B, int K, int Pp, int G,
           int D, int gslot, int R, cudaStream_t st) {
  const int per = (Pp + K * G + R - 1) / R;
  const size_t smem = smem_words(K, G, per, DK, R) * 4;
  auto kern = attn_step_split_kernel<T, DK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D / DK, B, R);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = R;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const T*>(kg),
      static_cast<const T*>(vg), pads, anc, gslot_ptr, out, K, Pp, G, D,
      gslot, per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q [B*K, 1, D]; kp, vp [B, Pp, D]; kg, vg [B*K, G, D] (bf16 when is_bf16,
// else f32), contiguous; pads [B] int32; anc [B, K, G] int32 or NULL;
// gslot_ptr a device int32 or NULL (then `gslot` is used), 0 <= gslot < G;
// out [B*K, 1, D] f32; R the cluster size (1..8). Returns
// cudaGetLastError() of the launch.
extern "C" int attn_step_split(const void* q, const void* kp, const void* vp,
                               const void* kg, const void* vg, const int* pads,
                               const int* anc, const int* gslot_ptr,
                               float* out, int B, int K, int Pp, int G, int D,
                               int dk, int gslot, int R, int is_bf16,
                               void* stream) {
  if (K < 1 || G < 1 || R < 1 || R > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dk == 64)
      return launch<__nv_bfloat16, 64>(q, kp, vp, kg, vg, pads, anc, gslot_ptr, out, B, K, Pp, G, D, gslot, R, st);
    if (dk == 128)
      return launch<__nv_bfloat16, 128>(q, kp, vp, kg, vg, pads, anc, gslot_ptr, out, B, K, Pp, G, D, gslot, R, st);
  } else {
    if (dk == 64)
      return launch<float, 64>(q, kp, vp, kg, vg, pads, anc, gslot_ptr, out, B, K, Pp, G, D, gslot, R, st);
    if (dk == 128)
      return launch<float, 128>(q, kp, vp, kg, vg, pads, anc, gslot_ptr, out, B, K, Pp, G, D, gslot, R, st);
  }
  return (int)cudaErrorInvalidValue;
}
