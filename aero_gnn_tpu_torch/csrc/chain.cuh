// Shared pieces of the fused MLP-chain kernels (the row kernels of
// rows_bwd.cuh): a row chunk of 128 rows, 8 warps of 16 rows each, every
// h x h product as warp-level tiles whose accumulator layout is that of
// mma.sync m16n8k16 (thread (g = lane/4, t = lane%4) holds rows g and g+8,
// columns 8j+2t and 8j+2t+1 for j < H/8), so one epilogue (bias, ReLU,
// rounding, LayerNorm) serves both number types: bf16 products on mma.sync
// with fp32 accumulation, fp32 ones on plain FFMA (no TF32). Rows are
// padded in shared memory (8 bf16 / 4 fp32) so the fragment loads are free
// of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chain {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // rows per chunk
constexpr float kLnEps = 1e-5f;     // torch.nn.LayerNorm default

template <typename T>
struct Num;

template <>
struct Num<float> {
  static constexpr int kPad = 4;
  __device__ __forceinline__ static float rnd(float v) { return v; }
  __device__ __forceinline__ static float load1(const float* p) { return *p; }
  __device__ __forceinline__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ static void store1(float* p, float v) { *p = v; }
  __device__ __forceinline__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Num<__nv_bfloat16> {
  static constexpr int kPad = 8;
  // round to the nearest bf16, as every bf16 PyTorch op does on its output
  __device__ __forceinline__ static float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ __forceinline__ static float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ __forceinline__ static void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
  __device__ __forceinline__ static void store2(__nv_bfloat16* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <typename T, int H>
struct Layout {
  static constexpr int kLd = H + Num<T>::kPad;  // padded row, elements
  static constexpr size_t kMatBytes = size_t(H) * kLd * sizeof(T);
  static constexpr size_t kActBytes = size_t(kRows) * kLd * sizeof(T);
};

// Copy the warp's 16 rows of a row-major [*, H] tensor into its slice of the
// activation buffer, 16 bytes per thread and load.
template <typename T, int H>
__device__ __forceinline__ void load_rows(T* act, const T* __restrict__ src) {
  constexpr int LD = Layout<T, H>::kLd;
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = H / V;
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * PER_ROW; i += 32) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    *reinterpret_cast<uint4*>(act + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + size_t(r) * H + c);
  }
}

// Rows ra / rb of a row-major [*, H] tensor (the thread's rows g and g + 8)
// to or from registers in the accumulator layout.
template <typename T, int H>
__device__ __forceinline__ void load_acc(float (&acc)[H / 8][4],
                                         const T* row_a, const T* row_b) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const float2 a = Num<T>::load2(row_a + 8 * j + 2 * t);
    const float2 b = Num<T>::load2(row_b + 8 * j + 2 * t);
    acc[j][0] = a.x;
    acc[j][1] = a.y;
    acc[j][2] = b.x;
    acc[j][3] = b.y;
  }
}

template <typename T, int H>
__device__ __forceinline__ void store_acc(const float (&acc)[H / 8][4],
                                          T* row_a, T* row_b) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    Num<T>::store2(row_a + 8 * j + 2 * t, acc[j][0], acc[j][1]);
    Num<T>::store2(row_b + 8 * j + 2 * t, acc[j][2], acc[j][3]);
  }
}

template <int H>
__device__ __forceinline__ void zero(float (&acc)[H / 8][4]) {
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
}

// acc += act[16 rows, H] @ W[H, H] in fp32 FFMA, in the accumulator
// layout: act a warp's [16][LD] rows, W an [H][LD] [k][n] tile.
template <int H>
__device__ __forceinline__ void mm(const float* __restrict__ act,
                                   const float* __restrict__ w,
                                   float (&acc)[H / 8][4]) {
  constexpr int LD = Layout<float, H>::kLd;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float a0 = act[g * LD + k], a1 = act[(g + 8) * LD + k];
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(w + k * LD + 8 * j + 2 * t);
      acc[j][0] = fmaf(a0, b.x, acc[j][0]);
      acc[j][1] = fmaf(a0, b.y, acc[j][1]);
      acc[j][2] = fmaf(a1, b.x, acc[j][2]);
      acc[j][3] = fmaf(a1, b.y, acc[j][3]);
    }
  }
}

// Mean and 1/sqrt(var + eps) of row g (half 0) or g+8 (half 1), two-pass in
// fp32 over the 4 threads of a quad.
template <int H>
__device__ __forceinline__ void row_stats(const float (&acc)[H / 8][4],
                                          int half, float& mu, float& inv) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) s += acc[j][2 * half] + acc[j][2 * half + 1];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  mu = s * (1.f / H);
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const float d0 = acc[j][2 * half] - mu, d1 = acc[j][2 * half + 1] - mu;
    q += d0 * d0 + d1 * d1;
  }
  q += __shfl_xor_sync(0xffffffffu, q, 1);
  q += __shfl_xor_sync(0xffffffffu, q, 2);
  inv = rsqrtf(q * (1.f / H) + kLnEps);
}

// acc = rnd(rnd(acc) + b): the output linear's bias.
template <typename T, int H>
__device__ __forceinline__ void bias_round(float (&acc)[H / 8][4],
                                           const T* __restrict__ b) {
  using N = Num<T>;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const float2 bo = N::load2(b + 8 * j + 2 * t);
    acc[j][0] = N::rnd(N::rnd(acc[j][0]) + bo.x);
    acc[j][1] = N::rnd(N::rnd(acc[j][1]) + bo.y);
    acc[j][2] = N::rnd(N::rnd(acc[j][2]) + bo.x);
    acc[j][3] = N::rnd(N::rnd(acc[j][3]) + bo.y);
  }
}

// LayerNorm of each row in place with the rows' statistics (mu, inv of row
// g, then of row g + 8): acc = rnd((acc - mu) * inv * scale + bias).
template <typename T, int H>
__device__ __forceinline__ void layer_norm_rows(float (&acc)[H / 8][4],
                                                const float (&mu)[2],
                                                const float (&inv)[2],
                                                const T* __restrict__ scale,
                                                const T* __restrict__ shift) {
  using N = Num<T>;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 sc = N::load2(scale + col), sh = N::load2(shift + col);
    acc[j][0] = N::rnd((acc[j][0] - mu[0]) * inv[0] * sc.x + sh.x);
    acc[j][1] = N::rnd((acc[j][1] - mu[0]) * inv[0] * sc.y + sh.y);
    acc[j][2] = N::rnd((acc[j][2] - mu[1]) * inv[1] * sc.x + sh.x);
    acc[j][3] = N::rnd((acc[j][3] - mu[1]) * inv[1] * sc.y + sh.y);
  }
}

// Pad tiles. In the aligned layout (graph/padded.py _align_edge_blocks) a
// node block's real rows come first and its alignment rows (masked) last,
// so a tile whose first row is masked holds pad rows only: the alignment
// tile of a block without an edge, and the tiles of the pad-sink tail the
// Loader's edge budget leaves after the stream (all keyed by the last pad
// node, so all in the last block). A block's tiles with a real first row
// therefore come before its pad tiles. The edge kernels skip the chunks of
// pad tiles and write those rows across the whole grid (e' = e, d_e =
// ct_e, d_sg = 0), so no CTA walks the tail alone.

}  // namespace chain
