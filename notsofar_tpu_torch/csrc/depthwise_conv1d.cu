// depthwise_conv1d: "same"-padded depthwise convolution over time, the
// TitaNet mega-blocks' channels-as-groups conv.
//
// Replaces notsofar_tpu/ops/pallas_kernels.py::depthwise_conv1d (wrapper
// :435, pallas_call :452). Same function:
//   out[b, t, c] = sum_{i < k} xpad[b, t + i, c] * w[i, c]
// with xpad = x zero-padded by pad = (k-1)/2 rows before and k-1-pad
// after; x [B, T, C] bf16 or f32, w [k, C] f32, out [B, T, C] f32; the k
// taps are summed in f32 in the order i = 0..k-1.
//
// What bounds it on an H100: bytes. Each output element costs 2k FLOP
// against 2 bytes of bf16 input and 4 bytes of f32 output, under one
// FLOP per byte for the k <= 15 of TitaNet. The padding is done by bounds
// checks while the tile is staged, so x is read once, with no padded copy
// (the JAX wrapper's jnp.pad is a whole extra pass over x).
//
// Design. One block of 256 threads per (channel tile of 128, time tile of
// 64, batch row). The block stages its [64 + k - 1, 128] halo tile of x
// in shared memory with 16-byte loads along the contiguous C axis (rows
// outside [0, T) are zeros: the "same" padding). Each thread then owns two
// adjacent channels and 16 output rows, taken 8 at a time: it reads the
// 8 + k - 1 input rows of its channel pair into registers once, keeps the
// pair's k taps in registers, and does k FMAs per output. Neighbouring
// threads hold neighbouring channels, so the f32 stores are coalesced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int CC = 128;                  // channels per block
constexpr int TT = 64;                   // output rows per block
constexpr int PAIRS = CC / 2;            // channel pairs per block
constexpr int GROUPS = NTHREADS / PAIRS; // time groups (4)
constexpr int ROWS_PER_GROUP = TT / GROUPS;
constexpr int R = 8;                     // output rows per register pass

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T, int K>
__global__ void __launch_bounds__(NTHREADS)
dwconv1d_kernel(const T* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int T_len, int C) {
  constexpr int PAD = (K - 1) / 2;
  constexpr int ROWS = TT + K - 1;
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int VPR = CC / VEC;          // 16-byte vectors per tile row
  __shared__ __align__(16) T tile[ROWS * CC];

  const int c0 = blockIdx.x * CC;
  const int t0 = blockIdx.y * TT;
  const int b = blockIdx.z;
  const size_t row0 = (size_t)b * T_len;

  // stage the halo tile: tile row r holds x[b, t0 - PAD + r, c0:c0+CC]
#pragma unroll
  for (int v = threadIdx.x; v < ROWS * VPR; v += NTHREADS) {
    const int r = v / VPR, cv = v % VPR;
    const int tg = t0 - PAD + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (tg >= 0 && tg < T_len)
      u = *reinterpret_cast<const uint4*>(x + (row0 + tg) * C + c0 + cv * VEC);
    *reinterpret_cast<uint4*>(tile + r * CC + cv * VEC) = u;
  }

  const int cp = threadIdx.x % PAIRS, g = threadIdx.x / PAIRS;
  const int c = c0 + 2 * cp;
  float2 wv[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    wv[i] = *reinterpret_cast<const float2*>(w + (size_t)i * C + c);
  __syncthreads();

#pragma unroll
  for (int p = 0; p < ROWS_PER_GROUP / R; ++p) {
    const int r0 = g * ROWS_PER_GROUP + p * R;   // first output row (tile)
    float2 xv[R + K - 1];
#pragma unroll
    for (int m = 0; m < R + K - 1; ++m)
      xv[m] = load_pair(tile + (r0 + m) * CC + 2 * cp);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float ax = 0.f, ay = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        ax = fmaf(xv[q + i].x, wv[i].x, ax);
        ay = fmaf(xv[q + i].y, wv[i].y, ay);
      }
      const int t = t0 + r0 + q;
      if (t < T_len)
        *reinterpret_cast<float2*>(out + (row0 + t) * C + c) =
            make_float2(ax, ay);
    }
  }
}

template <typename T, int K>
int launch(const void* x, const float* w, float* out, int B, int T_len,
           int C, cudaStream_t st) {
  dim3 grid(C / CC, (T_len + TT - 1) / TT, B);
  dwconv1d_kernel<T, K><<<grid, NTHREADS, 0, st>>>(
      static_cast<const T*>(x), w, out, T_len, C);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* w, float* out, int B, int T_len,
             int C, int k, cudaStream_t st) {
  switch (k) {
#define NT_DW_CASE(KK) \
  case KK:             \
    return launch<T, KK>(x, w, out, B, T_len, C, st);
    NT_DW_CASE(2) NT_DW_CASE(3) NT_DW_CASE(4) NT_DW_CASE(5) NT_DW_CASE(6)
    NT_DW_CASE(7) NT_DW_CASE(8) NT_DW_CASE(9) NT_DW_CASE(10) NT_DW_CASE(11)
    NT_DW_CASE(12) NT_DW_CASE(13) NT_DW_CASE(14) NT_DW_CASE(15)
    NT_DW_CASE(16) NT_DW_CASE(17) NT_DW_CASE(18) NT_DW_CASE(19)
    NT_DW_CASE(20) NT_DW_CASE(21) NT_DW_CASE(22) NT_DW_CASE(23)
    NT_DW_CASE(24) NT_DW_CASE(25) NT_DW_CASE(26) NT_DW_CASE(27)
    NT_DW_CASE(28) NT_DW_CASE(29) NT_DW_CASE(30) NT_DW_CASE(31)
    NT_DW_CASE(32) NT_DW_CASE(33)
#undef NT_DW_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [B, T, C] (bf16 when is_bf16, else f32), w [k, C] f32, out [B, T, C]
// f32, all contiguous and 16-byte aligned; C % 128 == 0; 2 <= k <= 33
// (the f32 halo tile of k = 33 fills the 48 KB of static shared memory).
// Returns cudaGetLastError() of the launch.
extern "C" int depthwise_conv1d(const void* x, const float* w, float* out,
                                int B, int T_len, int C, int k, int is_bf16,
                                void* stream) {
  if (C % CC != 0 || B <= 0 || T_len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, w, out, B, T_len, C, k, st);
  return dispatch<float>(x, w, out, B, T_len, C, k, st);
}
