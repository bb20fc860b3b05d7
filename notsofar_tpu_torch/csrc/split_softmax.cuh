// The skeleton that xattn_int8.cu and attn_step_split_bias.cu share: a
// (head, row) pair's keys cut into R contiguous shares, one per block of a
// thread-block cluster; each block's share of key rows, value rows (and
// bias) put in flight into shared memory by its first instructions, as
// asynchronous copies that complete on mbarriers; a softmax whose
// statistics are combined across the cluster over distributed shared
// memory in rank order, so that every block normalizes with the same f32
// max and sum and rounds the normalized weight (the TPU kernels' rounding
// point); and the R partial p.v outputs summed in rank order.
//
// Copies: 16-byte cp.async.cg copies, every thread a few, each thread
// arriving on a row chunk's mbarrier once its copies of the chunk have
// landed (the key rows on one barrier per CH rows, so the logits of the
// first rows start while later rows are on their way; the value rows on
// one barrier). No TMA: 2-D boxes of 32 rows through a tensor map, one
// thread issuing them, were slower than these copies in xattn_step.cu at
// Tq 1 and 5, on L2-resident and on cold memory (PERF.md), and 1-D
// cp.async.bulk copies of one row each were slower at every cluster size
// and shape tried (rows are only 64-512 bytes). A row's 16-byte pieces
// land XOR-swizzled (slot), so that the lanes of a quarter-warp that read
// one piece of eight neighbouring rows hit distinct banks.
#pragma once

#include <cooperative_groups.h>

#include "kernel_common.cuh"

namespace nt {
namespace split {

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 8;   // portable thread-block cluster size
constexpr int CH = 32;           // key rows per mbarrier

// the capacity of a share: ceil(n / R) rows rounded up to a multiple of 16
// (a tensor-core tile of keys; every array after it stays 16-byte aligned)
__host__ __device__ inline int share_rows(int n, int R) {
  return ((n + R - 1) / R + 15) / 16 * 16;
}

// block `rank`'s share [c0, c0 + len) of n columns cut into R shares of
// ceil(n / R); the last shares may be short or empty
struct Share {
  int c0, len;
};
__device__ inline Share share_of(int n, int R, int rank) {
  const int s = (n + R - 1) / R;
  const int c0 = min(rank * s, n);
  return {c0, min(c0 + s, n) - c0};
}

__host__ __device__ inline int align_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// ---------------------------------------------------------------------------
// mbarriers and asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// make the initialized barriers visible to the asynchronous copies
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// spin until the phase of parity `parity` has completed; a phase that never
// completes (a lost copy) traps after ~2^35 cycles instead of holding the
// card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// 16 bytes (4 bytes) from device memory into shared memory, both aligned;
// completion is reported by cp_async_arrive
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// arrive on `bar` once all of this thread's earlier copies have landed (the
// arrival counts against the barrier's expected count: every thread of the
// block arrives once on each barrier)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// the slot of 16-byte piece k of row r in a row of ppr pieces (a power of
// two)
__device__ __forceinline__ int slot(int r, int k, int ppr) {
  return k ^ (r & ((ppr < 8 ? ppr : 8) - 1));
}

// rows [r0, r1) of rb bytes each (a multiple of 16), src(r) the device
// address of row r, into dst (row r at r * rb, pieces swizzled when SWZ),
// 16-byte copies spread over the block's NT threads
template <int NT, bool SWZ, typename Src>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int rb, int r0,
                                           int r1, Src src) {
  const int ppr = rb / 16;
  for (int p = threadIdx.x; p < (r1 - r0) * ppr; p += NT) {
    const int r = r0 + p / ppr, k = p % ppr;
    cp_async16(dst + r * rb + (SWZ ? slot(r, k, ppr) : k) * 16,
               reinterpret_cast<const unsigned char*>(src(r)) + k * 16);
  }
}

// ---------------------------------------------------------------------------
// tensor cores (bf16 in, f32 accumulation; products of bf16 values are
// exact in f32)
// ---------------------------------------------------------------------------

// d += A (16 x 16, row-major fragments a0..a3) * B (16 x 8, b0, b1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two f32 values that are exact in bf16 as one bf16x2 word (lo, hi)
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// ---------------------------------------------------------------------------
// the split softmax
// ---------------------------------------------------------------------------

// The cluster's exchanges are pushes: a block stores what its peers need
// into their shared memory (distributed shared memory stores, which do not
// wait for a round trip), and a cluster barrier orders the stores before
// the peers read them locally. Two barriers per pair: after the stats,
// after the partial outputs. A block must not store into a peer that has
// not started: every block arrives on a cluster barrier as it starts
// (cluster_arrive) and waits on it (cluster_wait) before its first store,
// by which time its peers have long started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// per row r < n of the [n][per] logit block: this share's max and sum of
// exp over its len columns (-inf and 0 for an empty share), one warp per
// row, pushed as (max, sum) into peer[rank * n + r] of every block of the
// cluster
template <int NT>
__device__ __forceinline__ void push_stats(cg::cluster_group& cluster,
                                           const float* lg, int per, int len,
                                           int n, float2* peer, int R,
                                           int rank) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += NT / 32) {
    const float* row = lg + r * per;
    float m = -INFINITY;
    for (int i = lane; i < len; i += 32) m = fmaxf(m, row[i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < len; i += 32) l += expf(row[i] - m);
    l = warp_sum(l);   // every lane holds m and l
    if (lane < R)
      cluster.map_shared_rank(peer, lane)[rank * n + r] = make_float2(m, l);
  }
}

// after the cluster barrier that follows push_stats: the global (max, sum)
// of each of the n rows, the R blocks' pairs combined in rank order, so
// every block of the cluster holds the same bits. Ends with the block
// synchronized.
template <int NT>
__device__ __forceinline__ void combine_stats(const float2* peer,
                                              float2* gstat, int n, int R) {
  for (int r = threadIdx.x; r < n; r += NT) {
    float m = -INFINITY;
    for (int k = 0; k < R; ++k) m = fmaxf(m, peer[k * n + r].x);
    float l = 0.f;
    for (int k = 0; k < R; ++k) {
      const float2 st = peer[k * n + r];
      if (st.y > 0.f) l += st.y * expf(st.x - m);
    }
    gstat[r] = make_float2(m, l);
  }
  __syncthreads();
}

// block `rank`'s partial output `o` at idx < nout pushed to the block that
// owns idx (block k sums the slice [k * slice, (k + 1) * slice)), into its
// recv[rank][idx - k * slice]
__device__ __forceinline__ void push_partial(cg::cluster_group& cluster,
                                             float* recv, int idx, float o,
                                             int slice, int rank) {
  const int k = idx / slice;
  cluster.map_shared_rank(recv, k)[rank * slice + idx - k * slice] = o;
}

// after the cluster barrier that follows the pushes: block `rank` sums its
// slice of the R partial outputs in rank order and hands each sum to
// emit(idx, value)
template <int NT, typename Emit>
__device__ __forceinline__ void sum_received(const float* recv, int nout,
                                             int slice, int R, int rank,
                                             Emit emit) {
  const int n = min(slice, nout - rank * slice);
  for (int j = threadIdx.x; j < n; j += NT) {
    float o = 0.f;
    for (int k = 0; k < R; ++k) o += recv[k * slice + j];
    emit(rank * slice + j, o);
  }
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

// programmatic dependent launch (PTX griddepcontrol, sm_90): wait until
// the grids this one depends on have completed and their writes are
// visible (a no-op in a launch without the attribute), and let the
// dependent grid start once every block has signalled or exited
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// the opt-in to `smem` bytes of dynamic shared memory above 48 KB, once per
// kernel and device, and raised only when a larger launch arrives (not on
// every decode-step launch)
template <auto Kern>
cudaError_t opt_in_smem(size_t smem) {
  constexpr int MAX_DEVICES = 64;
  static size_t opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted_in[dev]) {
    e = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    opted_in[dev] = smem;
  }
  return cudaSuccess;
}

// grid (R, gy, gz) in clusters of R blocks along x, `smem` bytes of
// dynamic shared memory; with pdl, also the programmatic-stream-
// serialization attribute: the kernel may start before its predecessor on
// the stream ends, and must itself wait (griddepcontrol.wait) before it
// reads anything an earlier kernel writes
template <auto Kern, typename... Args>
int launch_cluster_attrs(bool pdl, int R, int gy, int gz, int threads,
                         size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = opt_in_smem<Kern>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, gy, gz);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, Kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// a cluster launch without programmatic dependence (every kernel that does
// not wait on griddepcontrol)
template <auto Kern, typename... Args>
int launch_cluster(int R, int gy, int gz, int threads, size_t smem,
                   cudaStream_t st, Args... args) {
  return launch_cluster_attrs<Kern>(false, R, gy, gz, threads, smem, st,
                                    args...);
}

// a cluster launch with programmatic dependence, for the kernels that wait
// on griddepcontrol before their first read of an earlier kernel's output
// (decode_gemv.cu, xattn_step.cu)
template <auto Kern, typename... Args>
int launch_cluster_pdl(int R, int gy, int gz, int threads, size_t smem,
                       cudaStream_t st, Args... args) {
  return launch_cluster_attrs<Kern>(true, R, gy, gz, threads, smem, st,
                                    args...);
}

}  // namespace split
}  // namespace nt
