// encoder_mha: unmasked bidirectional attention for the Whisper encoder.
//
// Replaces notsofar_tpu/ops/pallas_kernels.py::encoder_mha (wrapper :573,
// pallas_call :603, body :539). Same function: q and k arrive pre-scaled
// by dk**-0.25 in the model dtype (bf16 when serving), logits and softmax
// are f32, the weights are normalized by the full row sum and THEN rounded
// to the value dtype (p.astype(v.dtype)), p.v accumulates in f32 and the
// output is rounded to the value dtype. Keys at or past S are masked with
// -1e30. bf16 runs on the tensor cores (below); f32 models, used for parity
// runs, take a plain f32 FMA kernel (encoder_mha_f32_kernel).
//
// What bounds it on an H100: operations. 4*S^2*dk FLOP per (batch, head)
// (two products) against 2*3*S*dk*2 bytes moved, i.e. ~S/3 = 500 FLOP per
// byte at S=1500, above the card's ~295 FLOP/byte bf16 ridge, so the
// tensor cores, not HBM, are the limit (large-v3 encode, 3 windows:
// 34.6 GFLOP per layer, ~35 us at 989 TFLOP/s). Next come the exponentials:
// two per logit (one per pass, below), 2 x 141 M at the encode shape, which
// the SFUs (16 per SM per clock) take ~0.07 ms for at full rate.
//
// Design (bf16). Two passes over the keys, because the TPU kernel rounds p
// to bf16 only after dividing by the full row sum (the JAX docstring: a
// deferred normalization "perturbs numerics -- not taken"): pass 1 computes
// each row's max and sum of exp (online over key tiles), pass 2 recomputes
// the logits, forms p = bf16(exp(s - m) * (1/l)) and accumulates p.v in
// f32. That is 3 products' worth of tensor-core work instead of 2.
//   * A block of 3 warpgroups covers 128 query rows of one (batch, head):
//     warpgroup 0 is the producer (one thread issues TMA loads; setmaxnreg
//     hands its registers to the others), warpgroups 1 and 2 each own 64
//     query rows. Grid (ceil(S/128), BH): 720 blocks at the encode shape.
//   * Tiles come in by TMA (cp.async.bulk.tensor, 3-D maps over [BH, S,
//     dk], so a tile never crosses into the next head) as 128-byte rows
//     with the 128B swizzle that wgmma's descriptors read: the q tile once,
//     then 128-key K tiles (pass 1) and K and V tiles (pass 2) through
//     rings of stages with full and empty mbarriers. Keys and query rows at
//     or past S arrive as zeros (TMA's out-of-bounds fill); the logits of
//     such keys are masked before the max, such rows are not stored.
//   * QK^T: wgmma m64n128k16 with q and K both from shared memory
//     (K-major); dk = 128 rows are two 64-column swizzle atoms.
//   * p.v: the bf16 p goes from the logit accumulators straight into
//     wgmma's register A operand (the accumulator and A fragment layouts
//     line up as in mma.sync); V is the MN-major B operand through the
//     descriptor's transpose bit, so it is never transposed by hand;
//     m64n64k16 per 64 output columns.
//   * Each weight is exp2(s*log2e - m*log2e) times __frcp_rn(l) instead of
//     an IEEE division by l: that moves p by at most an f32 ulp or two
//     before its bf16 rounding (the phase-2 gate of chip_smoke.py holds it
//     to the plain version at two bf16 ulps of the output).
//   * The two consumers ping-pong: named barriers give them alternate turns
//     to issue wgmma, so one warpgroup's softmax runs while the other's
//     products run. In pass 2 a turn issues the p.v of tile t-1 together
//     with the logits of tile t.
// Measured on an H100 (PERF.md, PR 6): ~0.18 ms at the encode shape, 3.5x
// the two-pass design's tensor-core floor. Taking out parts of it puts
// ~0.08 ms in the tile feed, barriers and softmax FMAs, and ~0.04-0.06 ms
// each in the exponentials, the pass-1 softmax, the pass-2 weights and
// the p.v products; ring depth (2-6 stages) and the ping-pong change
// nothing measurable.
#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched
                    // with cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                // query rows per block
constexpr int BN = 128;                // keys per tile
constexpr int NTHREADS = 3 * 128;      // producer + 2 consumer warpgroups
constexpr int ROW_BYTES = 128;         // one swizzle atom row: 64 bf16
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DK>
struct Smem {
  static constexpr int NSUB = DK / 64;             // 64-column atoms per row
  static constexpr int STAGES = DK == 64 ? 4 : 2;  // K and V ring depth
  static constexpr int Q_SUB = BM * ROW_BYTES;     // one atom column of q
  static constexpr int KV_SUB = BN * ROW_BYTES;
  static constexpr int Q_BYTES = NSUB * Q_SUB;
  static constexpr int KV_BYTES = NSUB * KV_SUB;   // one K or V tile
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // q_full, then k_full, k_empty, v_full, v_empty per stage
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 4 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;       // room to align to 1 KB
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
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
// completes (a lost load, a wrong parity) traps after ~2^35 cycles instead
// of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand whose 8-row
// core matrices lie 1024 bytes apart (SBO); the leading offset is unused
// for these layouts (K-major within one atom, MN-major with N = 64)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// named barriers 1 and 2 order the two consumer warpgroups' wgmma turns:
// one warpgroup waits on its barrier, the other arrives on it (256 threads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[0..63] (+)= A[64 x 16] . B[16 x 128]: A (q) and B (keys, K-major)
// from 128B-swizzled shared memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..31] += A[64 x 16] . B[16 x 64]: A (bf16 weights) from registers in
// the mma fragment layout, B (values, MN-major) from 128B-swizzled shared
// memory through the descriptor's transpose bit
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> packed bf16x2, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// issue (without waiting) the logits of a consumer's 64 query rows against
// one 128-key tile: s[4i + 0..1] -> row g, keys 8i + 2t, +1; s[4i + 2..3]
// -> row g + 8
template <int DK>
__device__ __forceinline__ void qk_issue(float (&s)[64], uint32_t q_rows,
                                         uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t sub = kk / 4, off = (kk % 4) * 32;   // atom, 32-byte step
    wgmma_ss_m64n128(s, sw128_desc(q_rows + sub * Smem<DK>::Q_SUB + off),
                     sw128_desc(k_tile + sub * Smem<DK>::KV_SUB + off),
                     kk > 0);
  }
  wgmma_commit();
}

// keys at or past S get the masked logit (only the last tile has any)
__device__ __forceinline__ void mask_tail(float (&s)[64], int k0, int S,
                                          int tq) {
  if (k0 + BN <= S) return;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int key = k0 + 8 * i + 2 * tq;
    if (key >= S) s[4 * i] = s[4 * i + 2] = MASKED;
    if (key + 1 >= S) s[4 * i + 1] = s[4 * i + 3] = MASKED;
  }
}

template <int DK>
__global__ void __launch_bounds__(NTHREADS, 1)
encoder_mha_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int S) {
  using L = Smem<DK>;
  constexpr int ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 128B swizzle atoms must start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sk = base + L::OFF_K, sv = base + L::OFF_V;
  const uint32_t bar = base + L::OFF_BAR;
  auto q_full = [&]() { return bar; };
  auto k_full = [&](int st) { return bar + 8 * (1 + st); };
  auto k_empty = [&](int st) { return bar + 8 * (1 + ST + st); };
  auto v_full = [&](int st) { return bar + 8 * (1 + 2 * ST + st); };
  auto v_empty = [&](int st) { return bar + 8 * (1 + 3 * ST + st); };

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int ntiles = (S + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full(), 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 8);   // one arrival per consumer warp
      mbar_init(v_empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full(), L::Q_BYTES);
#pragma unroll
      for (int sub = 0; sub < L::NSUB; ++sub)
        tma_load(sq + sub * L::Q_SUB, &tm_q, q_full(), sub * 64, q0, bh);
      // K tiles of pass 1 then pass 2 in one sequence; V tiles in pass 2
      for (int it = 0; it < 2 * ntiles; ++it) {
        const int t = it < ntiles ? it : it - ntiles;
        const int st = it % ST;
        mbar_wait(k_empty(st), ((it / ST) & 1) ^ 1);
        mbar_expect_tx(k_full(st), L::KV_BYTES);
#pragma unroll
        for (int sub = 0; sub < L::NSUB; ++sub)
          tma_load(sk + st * L::KV_BYTES + sub * L::KV_SUB, &tm_k,
                   k_full(st), sub * 64, t * BN, bh);
        if (it >= ntiles) {
          const int vst = t % ST;
          mbar_wait(v_empty(vst), ((t / ST) & 1) ^ 1);
          mbar_expect_tx(v_full(vst), L::KV_BYTES);
#pragma unroll
          for (int sub = 0; sub < L::NSUB; ++sub)
            tma_load(sv + vst * L::KV_BYTES + sub * L::KV_SUB, &tm_v,
                     v_full(vst), sub * 64, t * BN, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 takes rows q0..q0+63, warpgroup 2 the next 64
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const uint32_t q_rows = sq + (wg - 1) * 64 * ROW_BYTES;
  mbar_wait(q_full(), 0);
  float s[64];

  // Ping-pong between the two consumers: a warpgroup issues its wgmma
  // only in its turn (named barrier 1 + its index), then hands the turn to
  // the other, so one warpgroup's softmax (SFUs) runs while the other's
  // products run on the tensor cores. Each warpgroup takes nt + (nt + 1)
  // turns; warpgroup 1 goes first.
  const int me = wg - 1;
  auto turn_wait = [&]() { named_sync(1 + me); };
  auto turn_pass = [&]() { named_arrive(2 - me); };
  if (me == 1) turn_pass();
  auto k_issue = [&](int it) {   // it: index in the K sequence
    const int st = it % ST;
    mbar_wait(k_full(st), (it / ST) & 1);
    qk_issue<DK>(s, q_rows, sk + st * L::KV_BYTES);
  };
  auto k_release = [&](int it) {
    if (lane == 0) mbar_arrive(k_empty(it % ST));
  };

  // pass 1: row max and sum of exp, online over key tiles
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    turn_wait();
    k_issue(t);
    turn_pass();
    wgmma_wait_all();
    fence_regs(s);
    k_release(t);
    mask_tail(s, t * BN, S, tq);
    float t0 = MASKED, t1 = MASKED;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      t0 = fmaxf(t0, fmaxf(s[4 * i], s[4 * i + 1]));
      t1 = fmaxf(t1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
    const float c0 = n0 * LOG2E, c1 = n1 * LOG2E;
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      e0 += ex2(fmaf(s[4 * i], LOG2E, -c0)) + ex2(fmaf(s[4 * i + 1], LOG2E, -c0));
      e1 += ex2(fmaf(s[4 * i + 2], LOG2E, -c1)) + ex2(fmaf(s[4 * i + 3], LOG2E, -c1));
    }
    l0 = l0 * ex2((m0 - n0) * LOG2E) + e0;
    l1 = l1 * ex2((m1 - n1) * LOG2E) + e1;
    m0 = n0;
    m1 = n1;
  }
  const float r0 = __frcp_rn(quad_sum(l0)), r1 = __frcp_rn(quad_sum(l1));
  const float c0 = m0 * LOG2E, c1 = m1 * LOG2E;

  // pass 2: normalized p, rounded to bf16, times V. A turn issues the p.v
  // of tile t-1 (weights from the turn before) with the logits of tile t.
  float acc[L::NSUB][32];
#pragma unroll
  for (int sub = 0; sub < L::NSUB; ++sub)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[sub][i] = 0.f;
  uint32_t pa[8][4];
  auto pv_issue = [&](int t) {
    const int vst = t % ST;
    mbar_wait(v_full(vst), (t / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 8; ++kc)
#pragma unroll
      for (int sub = 0; sub < L::NSUB; ++sub)
        wgmma_rs_m64n64(acc[sub], pa[kc],
                        sw128_desc(sv + vst * L::KV_BYTES + sub * L::KV_SUB +
                                   kc * 16 * ROW_BYTES));
    wgmma_commit();
  };
  auto v_release = [&](int t) {
    if (lane == 0) mbar_arrive(v_empty(t % ST));
  };
  for (int t = 0; t <= ntiles; ++t) {
    turn_wait();
    if (t > 0) pv_issue(t - 1);
    if (t < ntiles) k_issue(ntiles + t);
    turn_pass();
    wgmma_wait_all();
#pragma unroll
    for (int sub = 0; sub < L::NSUB; ++sub) fence_regs(acc[sub]);
    if (t > 0) v_release(t - 1);
    if (t == ntiles) break;
    fence_regs(s);
    k_release(ntiles + t);
    mask_tail(s, t * BN, S, tq);
    // accumulator n-tiles 2kc, 2kc+1 are the A fragment of keys
    // 16kc..16kc+15 (row g: a0, a2; row g+8: a1, a3)
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      const float* lo = s + 8 * kc;
      const float* hi = s + 8 * kc + 4;
      pa[kc][0] = pack_bf16(ex2(fmaf(lo[0], LOG2E, -c0)) * r0,
                            ex2(fmaf(lo[1], LOG2E, -c0)) * r0);
      pa[kc][1] = pack_bf16(ex2(fmaf(lo[2], LOG2E, -c1)) * r1,
                            ex2(fmaf(lo[3], LOG2E, -c1)) * r1);
      pa[kc][2] = pack_bf16(ex2(fmaf(hi[0], LOG2E, -c0)) * r0,
                            ex2(fmaf(hi[1], LOG2E, -c0)) * r0);
      pa[kc][3] = pack_bf16(ex2(fmaf(hi[2], LOG2E, -c1)) * r1,
                            ex2(fmaf(hi[3], LOG2E, -c1)) * r1);
    }
  }
  // the last turn passed by warpgroup 2 is taken here, so both named
  // barriers end complete
  if (me == 0) turn_wait();

  // acc[sub][4i + 0..1] -> row g, dims sub*64 + 8i + 2t, +1; [4i + 2..3]
  // -> row g + 8
  const int row0 = q0 + (wg - 1) * 64 + warp * 16 + g, row1 = row0 + 8;
  __nv_bfloat16* obh = o + (size_t)bh * S * DK;
#pragma unroll
  for (int sub = 0; sub < L::NSUB; ++sub)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = sub * 64 + 8 * i + 2 * tq;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(obh + (size_t)row0 * DK + c) =
            pack_bf16(acc[sub][4 * i], acc[sub][4 * i + 1]);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(obh + (size_t)row1 * DK + c) =
            pack_bf16(acc[sub][4 * i + 2], acc[sub][4 * i + 3]);
    }
}

// f32 models (parity runs): the same two passes in plain f32 FMAs, one
// query row per thread, keys and values staged through shared memory in
// tiles every thread of the block reads (broadcast). Softmax weights stay
// f32 (p.astype(v.dtype) is exact), as do the products and the output.
constexpr int F32_ROWS = 128;          // query rows (threads) per block
constexpr int F32_TILE = 32;           // keys per shared-memory tile

// rows k0.. of a [S, DK] f32 head -> tile (rows >= S zero-filled)
template <int DK>
__device__ __forceinline__ void load_f32_tile(const float* src, int k0, int S,
                                              float (*tile)[DK]) {
  for (int i = threadIdx.x; i < F32_TILE * DK; i += F32_ROWS) {
    const int r = i / DK, d = i % DK;
    tile[r][d] = k0 + r < S ? src[(size_t)(k0 + r) * DK + d] : 0.f;
  }
}

template <int DK>
__device__ __forceinline__ float dot_f32(const float (&a)[DK],
                                         const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DK; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

template <int DK>
__global__ void __launch_bounds__(F32_ROWS)
encoder_mha_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S) {
  __shared__ float Ks[F32_TILE][DK];
  __shared__ float Vs[F32_TILE][DK];
  const size_t base = (size_t)blockIdx.y * S * DK;
  const int row = blockIdx.x * F32_ROWS + threadIdx.x;
  const bool valid = row < S;
  float qr[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d)
    qr[d] = valid ? q[base + (size_t)row * DK + d] : 0.f;

  // pass 1: row max and sum of exp
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < S; k0 += F32_TILE) {
    __syncthreads();
    load_f32_tile<DK>(k + base, k0, S, Ks);
    __syncthreads();
    const int n = min(F32_TILE, S - k0);
    for (int r = 0; r < n; ++r) {
      const float s = dot_f32<DK>(qr, Ks[r]);
      const float mn = fmaxf(m, s);
      l = l * expf(m - mn) + expf(s - mn);
      m = mn;
    }
  }
  // pass 2: normalized p times V
  float acc[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < S; k0 += F32_TILE) {
    __syncthreads();
    load_f32_tile<DK>(k + base, k0, S, Ks);
    load_f32_tile<DK>(v + base, k0, S, Vs);
    __syncthreads();
    const int n = min(F32_TILE, S - k0);
    for (int r = 0; r < n; ++r) {
      const float p = expf(dot_f32<DK>(qr, Ks[r]) - m) / l;
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] = fmaf(p, Vs[r][d], acc[d]);
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < DK; ++d) o[base + (size_t)row * DK + d] = acc[d];
  }
}

}  // namespace

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA map of a contiguous bf16 [BH, S, dk] tensor, boxes of 128 rows x 64
// columns of one head, 128B swizzle, zeros past S
static bool make_map(CUtensorMap* map, const void* ptr, int BH, int S,
                     int dk) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dk, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)dk * 2,
                                 (cuuint64_t)S * dk * 2};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK>
static int launch_bf16(const void* q, const void* k, const void* v, void* o,
                       int BH, int S, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, BH, S, DK) || !make_map(&tk, k, BH, S, DK) ||
      !make_map(&tv, v, BH, S, DK))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Smem<DK>::ALLOC;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        encoder_mha_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((S + BM - 1) / BM, BH);
  encoder_mha_kernel<DK><<<grid, NTHREADS, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S);
  return (int)cudaGetLastError();
}

// q, k, v, o: [BH, S, dk], all bf16 when is_bf16 else all f32, contiguous
// and 16-byte aligned; dk 64 or 128. Launches on `stream` and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue when the TMA
// maps cannot be made).
extern "C" int encoder_mha(const void* q, const void* k, const void* v,
                           void* o, int BH, int S, int dk, int is_bf16,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dk == 64) return launch_bf16<64>(q, k, v, o, BH, S, st);
    if (dk == 128) return launch_bf16<128>(q, k, v, o, BH, S, st);
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((S + F32_ROWS - 1) / F32_ROWS, BH);
  auto qp = static_cast<const float*>(q);
  auto kp = static_cast<const float*>(k);
  auto vp = static_cast<const float*>(v);
  auto op = static_cast<float*>(o);
  if (dk == 64)
    encoder_mha_f32_kernel<64><<<grid, F32_ROWS, 0, st>>>(qp, kp, vp, op, S);
  else if (dk == 128)
    encoder_mha_f32_kernel<128><<<grid, F32_ROWS, 0, st>>>(qp, kp, vp, op, S);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
