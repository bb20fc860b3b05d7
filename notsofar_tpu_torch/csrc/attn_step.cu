// attn_step: single-token self-attention against a KV cache (one greedy
// or sampled Whisper decode step).
//
// Replaces notsofar_tpu/ops/pallas_kernels.py::attn_step (wrapper :224,
// pallas_call :262). Same function: q [B, 1, D] in the cache dtype with
// the full dk**-0.5 folded in; key s of row b is visible iff
// s <= pos and (s >= pad[b] or s == pos), others get -1e30; f32 softmax
// over the whole visible row; weights normalized, then rounded to the
// cache dtype; p.v accumulated in f32; f32 output.
//
// What bounds it on an H100: bytes. Each (row, head) reads its visible
// keys and values once and does 4*dk FLOP per key: ~1 FLOP per byte, far
// below the ridge. Keys outside [min(pad, pos), pos] have weight exactly 0
// (exp(-1e30 - m) is 0 in f32, and key pos is always visible), so the
// kernel reads only the keys this step needs, not the cache's width.
//
// Design: bytes in flight across many resident blocks (the first design,
// one block of 256 threads per (head, row), ran 240 blocks at the greedy
// shape, at most 2 a SM, in three serial phases with one 16-byte load in
// flight per lane). A (head, row) pair is a thread-block cluster of R
// blocks along x (grid (R, H, B), split_softmax.cuh), each block owning a
// contiguous share of the row's visible keys; 128 threads and <= 64
// registers a thread let 8 blocks share a SM (at the greedy shape, 12 rows
// x 20 heads x R = 4 is 960 blocks, all resident at once). A block's first
// instructions put its share's value rows in flight into shared memory
// (16-byte cp.async copies completing on one mbarrier), so the values land
// while the keys stream and the statistics are exchanged. The keys stream
// straight into registers: a key's dk channels are dk/VEC lanes' 16-byte
// loads (neighbouring lanes, neighbouring addresses), each lane with UNROLL
// independent loads in flight, reduced with warp shuffles; the share's
// logits stay in shared memory. The shares' (max, sum) pairs are combined
// across the cluster over distributed shared memory in rank order, so
// every block normalizes with the same f32 statistics and rounds the
// normalized weight (the TPU kernel's rounding point, so no online
// softmax); the R partial p.v outputs are summed in rank order.
//
// pos comes by value or, when pos_ptr is not NULL, from device memory,
// clamped to [0, ctx). The grid depends on B, ctx, D and dk only, so one
// captured launch serves every step of a CUDA graph while pos advances; a
// block whose share is empty loads nothing but still arrives on every
// barrier. No tensor cores (1 FLOP per byte) and no TMA tensor map (the
// cache pointers change with every layer).
#include "split_softmax.cuh"

namespace cg = cooperative_groups;

namespace {

namespace sp = nt::split;

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int UNROLL = 4;   // keys a lane has in flight in the logit pass

// the VEC values of a 16-byte register word as f32
__device__ __forceinline__ void widen(const uint4& u, float* out,
                                      const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& u, float* out,
                                      const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}

// shared memory of one block in bytes: the value barrier, the share's value
// rows [per][dk], its logits -> weights [per], the warps' partial outputs
// [NWARPS][dk], the peers' partial outputs of its slice [R][ceil(dk / R)],
// the peers' stats [R] and the global stats (ops/kernels.py
// attn_step_smem mirrors it)
struct Layout {
  int vs, lg, red, recv, peer, gstat, bytes;
};
__host__ __device__ inline Layout layout(int per, int dk, int esize, int R) {
  Layout L;
  int o = 16;                       // the mbarrier
  L.vs = o;
  o += per * dk * esize;
  L.lg = o;
  o += sp::align_up(per * 4, 16);
  L.red = o;
  o += NWARPS * dk * 4;
  L.recv = o;
  o += sp::align_up(R * ((dk + R - 1) / R) * 4, 16);
  L.peer = o;
  o += 8 * R;
  L.gstat = o;
  o += 8;
  L.bytes = o;
  return L;
}

template <typename T, int DK>
__global__ void __launch_bounds__(NTHREADS, 8)
attn_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pads,
                 const int* __restrict__ pos_ptr, float* __restrict__ out,
                 int ctx, int D, int pos_arg, int per) {
  constexpr int VEC = nt::Vec<T>::N;     // elements per 16-byte load
  constexpr int LPK = DK / VEC;          // lanes per key
  constexpr int KPW = 32 / LPK;          // keys per warp and unrolled load
  constexpr int NG = NTHREADS / LPK;     // key groups in the p.v pass
  constexpr int RB = DK * (int)sizeof(T);   // bytes of a value row
  cg::cluster_group cluster = cg::this_cluster();
  const int R = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // every visible key lies in [lo, pos]; key pos always does
  const int pos = min(max(pos_ptr != nullptr ? *pos_ptr : pos_arg, 0),
                      ctx - 1);
  const int lo = max(0, min(pads[b], pos));
  const sp::Share sh = sp::share_of(pos - lo + 1, R, rank);
  const int c0 = lo + sh.c0, len = sh.len;
  const int slice = (DK + R - 1) / R;

  const Layout L = layout(per, DK, (int)sizeof(T), R);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* vbar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* vsm = smem + L.vs;
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  float2* peer = reinterpret_cast<float2*>(smem + L.peer);
  float2* gstat = reinterpret_cast<float2*>(smem + L.gstat);
  const uint32_t bar = sp::smem_u32(vbar);

  // the share's value rows in flight before anything else
  if (tid == 0) {
    sp::mbar_init(bar, NTHREADS);
    sp::fence_mbar_init();
  }
  __syncthreads();
  sp::cluster_arrive();
  const size_t row = ((size_t)b * ctx + c0) * D + (size_t)h * DK;
  sp::stage_rows<NTHREADS, false>(vsm, RB, 0, len, [&](int r) {
    return v + row + (size_t)r * D;
  });
  sp::cp_async_arrive(bar);

  // logits: LPK lanes per key, UNROLL loads in flight per lane
  {
    const int sub = lane / LPK, c = lane % LPK;
    float qv[VEC];
    nt::load16(q + (size_t)b * D + h * DK + c * VEC, qv);
    for (int i0 = warp * UNROLL * KPW; i0 < len;
         i0 += NWARPS * UNROLL * KPW) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * KPW + sub;
        raw[u] = i < len ? *reinterpret_cast<const uint4*>(
                               k + row + (size_t)i * D + c * VEC)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float kv[VEC];
        widen(raw[u], kv, k);
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc = fmaf(qv[e], kv[e], acc);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(nt::FULL_MASK, acc, off);
        const int i = i0 + u * KPW + sub;
        if (c == 0 && i < len) lg[i] = acc;
      }
    }
  }
  __syncthreads();

  // the share's (max, sum) to every peer; the global pair in rank order
  sp::cluster_wait();   // every peer has started: pushes may begin
  sp::push_stats<NTHREADS>(cluster, lg, per, len, 1, peer, R, rank);
  cluster.sync();
  sp::combine_stats<NTHREADS>(peer, gstat, 1, R);
  const float2 gs = gstat[0];
  for (int i = tid; i < len; i += NTHREADS)
    lg[i] = nt::round_as(expf(lg[i] - gs.x) / gs.y, v);
  __syncthreads();

  // p.v over the share: a thread owns one 16-byte channel slice of a
  // strided subset of the value rows, which landed during the logits
  {
    const int c = tid % LPK, grp = tid / LPK;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if (len > 0) sp::mbar_wait(bar, 0);
    for (int i = grp; i < len; i += NG) {
      float vv[VEC];
      nt::load16(reinterpret_cast<const T*>(vsm + i * RB + c * 16), vv);
      const float p = lg[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
    }
    // a warp's key groups by shuffles, then the warps through shared memory
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        acc[e] += __shfl_xor_sync(nt::FULL_MASK, acc[e], o);
    if (lane < LPK) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[warp * DK + c * VEC + e] = acc[e];
    }
  }
  __syncthreads();
  for (int d = tid; d < DK; d += NTHREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += red[w * DK + d];
    sp::push_partial(cluster, recv, d, o, slice, rank);
  }
  cluster.sync();

  sp::sum_received<NTHREADS>(recv, DK, slice, R, rank, [&](int d, float o) {
    out[(size_t)b * D + h * DK + d] = o;
  });
}

template <typename T, int DK>
int launch(const void* q, const void* k, const void* v, const int* pads,
           const int* pos_ptr, float* out, int B, int ctx, int D, int pos,
           int R, cudaStream_t st) {
  const int per = sp::share_rows(ctx, R);
  const size_t smem = layout(per, DK, (int)sizeof(T), R).bytes;
  return sp::launch_cluster<attn_step_kernel<T, DK>>(
      R, D / DK, B, NTHREADS, smem, st, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), pads, pos_ptr, out,
      ctx, D, pos, per);
}

}  // namespace

// q [B, 1, D]; k, v [B, ctx, D] (bf16 when is_bf16, else f32), contiguous;
// pads [B] int32; out [B, 1, D] f32. pos by value (0 <= pos < ctx) when
// pos_ptr is NULL, else read from the int32 at pos_ptr on the device
// (clamped). R the cluster size (1..8). Returns cudaGetLastError() of the
// launch.
extern "C" int attn_step(const void* q, const void* k, const void* v,
                         const int* pads, const int* pos_ptr, float* out,
                         int B, int ctx, int D, int dk, int pos, int R,
                         int is_bf16, void* stream) {
  if (R < 1 || R > sp::MAX_CLUSTER || ctx < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dk == 64) return launch<__nv_bfloat16, 64>(q, k, v, pads, pos_ptr, out, B, ctx, D, pos, R, st);
    if (dk == 128) return launch<__nv_bfloat16, 128>(q, k, v, pads, pos_ptr, out, B, ctx, D, pos, R, st);
  } else {
    if (dk == 64) return launch<float, 64>(q, k, v, pads, pos_ptr, out, B, ctx, D, pos, R, st);
    if (dk == 128) return launch<float, 128>(q, k, v, pads, pos_ptr, out, B, ctx, D, pos, R, st);
  }
  return (int)cudaErrorInvalidValue;
}
