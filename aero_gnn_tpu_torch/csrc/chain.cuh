// Shared pieces of the fused MLP-chain kernels (the row kernels of
// rows_bwd.cuh and, through chain_bwd.cuh, the single-kernel backward
// schedules of K8 and K9-bwd): a row chunk of 128 rows per CTA step, 8
// warps of 16 rows each, every h x h product as warp-level tiles whose accumulator
// layout is that of mma.sync m16n8k16 (thread (g = lane/4, t = lane%4) holds
// rows g and g+8, columns 8j+2t and 8j+2t+1 for j < H/8), so one epilogue
// (bias, ReLU, rounding, LayerNorm) serves both number types:
//
//   * bf16: mma.sync.m16n8k16 with bf16 inputs and fp32 accumulation;
//     weights in shared memory transposed ([n][k]) so a B fragment is one
//     32-bit load.
//   * fp32: plain FFMA in the same register layout (no TF32), weights in
//     shared memory as [k][n].
//
// Rows are padded in shared memory (8 bf16 / 4 fp32) so the fragment loads
// are free of bank conflicts. Each warp reads and writes only its own 16
// rows of an activation buffer, so a chain needs only __syncwarp between
// products apart from the barriers of weights streamed through shared
// memory.
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

// The warp's 16 rows of an activation buffer back to a row-major [*, H]
// tensor, 16 bytes per thread and store.
template <typename T, int H>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const T* act) {
  constexpr int LD = Layout<T, H>::kLd;
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = H / V;
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * PER_ROW; i += 32) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    *reinterpret_cast<uint4*>(dst + size_t(r) * H + c) =
        *reinterpret_cast<const uint4*>(act + r * LD + c);
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += act[16 rows, H] @ W[H, H]; W transposed in shared memory.
template <int H>
__device__ __forceinline__ void mm(const __nv_bfloat16* __restrict__ act,
                                   const __nv_bfloat16* __restrict__ wt,
                                   float (&acc)[H / 8][4]) {
  constexpr int LD = Layout<__nv_bfloat16, H>::kLd;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < H; kk += 16) {
    const __nv_bfloat16* a = act + g * LD + kk + 2 * t;
    const uint32_t a0 = ld32(a), a1 = ld32(a + 8 * LD);
    const uint32_t a2 = ld32(a + 8), a3 = ld32(a + 8 * LD + 8);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const __nv_bfloat16* b = wt + (8 * j + g) * LD + kk + 2 * t;
      const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

// acc += act[16 rows, H] @ W[H, H] in fp32 FFMA, same register layout.
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

// acc = relu(rnd(rnd(acc) + bias)), written to the warp's activation rows.
template <typename T, int H>
__device__ __forceinline__ void bias_relu_store(float (&acc)[H / 8][4],
                                                const T* __restrict__ bias,
                                                T* act) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 bb = N::load2(bias + col);
    const float v0 = fmaxf(N::rnd(N::rnd(acc[j][0]) + bb.x), 0.f);
    const float v1 = fmaxf(N::rnd(N::rnd(acc[j][1]) + bb.y), 0.f);
    const float v2 = fmaxf(N::rnd(N::rnd(acc[j][2]) + bb.x), 0.f);
    const float v3 = fmaxf(N::rnd(N::rnd(acc[j][3]) + bb.y), 0.f);
    N::store2(act + g * LD + col, v0, v1);
    N::store2(act + (g + 8) * LD + col, v2, v3);
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

// First edge tile of node block `block` in a block-aligned receiver stream:
// a tile's block is recv[first row] / node_block (graph/padded.py
// derive_tiles), found by binary search over the tiles.
__device__ inline int first_tile(const int* __restrict__ recv, int n_tiles,
                                 int edge_tile, int node_block, int block) {
  int lo = 0, hi = n_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (recv[int64_t(mid) * edge_tile] / node_block < block)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Pad tiles. In the aligned layout (graph/padded.py _align_edge_blocks) a
// node block's real rows come first and its alignment rows (masked) last,
// so a tile whose first row is masked holds pad rows only: the alignment
// tile of a block without an edge, and the tiles of the pad-sink tail the
// Loader's edge budget leaves after the stream (all keyed by the last pad
// node, so all in the last block). A block's tiles with a real first row
// therefore come before its pad tiles. The edge kernels walk only the
// former, so no CTA walks the tail, and fill_pad_tiles writes the rows of
// the latter across the whole grid.

// First pad tile in a block's tiles [lo, hi), by binary search.
template <typename T>
__device__ inline int first_pad_tile(const T* __restrict__ mask, int lo,
                                     int hi, int edge_tile) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (Num<T>::load1(mask + int64_t(mid) * edge_tile) != 0.f)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Every pad tile's rows of dst0 = those of src0 and of dst1 = those of
// src1 (zeros where a source is null; dst1 may be null): one CTA per tile,
// grid-stride, 16 bytes per thread and store.
template <typename T>
__global__ void __launch_bounds__(256)
fill_pad_tiles(const T* __restrict__ mask, int n_tiles, int edge_tile,
               int h, T* __restrict__ dst0, const T* __restrict__ src0,
               T* __restrict__ dst1, const T* __restrict__ src1) {
  const int64_t vecs = int64_t(edge_tile) * h * sizeof(T) / 16;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if (Num<T>::load1(mask + int64_t(tile) * edge_tile) != 0.f) continue;
    const int64_t off = int64_t(tile) * edge_tile * h;
    uint4* d0 = reinterpret_cast<uint4*>(dst0 + off);
    uint4* d1 = dst1 ? reinterpret_cast<uint4*>(dst1 + off) : nullptr;
    const uint4* s0 = src0 ? reinterpret_cast<const uint4*>(src0 + off)
                           : nullptr;
    const uint4* s1 = src1 ? reinterpret_cast<const uint4*>(src1 + off)
                           : nullptr;
    for (int64_t i = threadIdx.x; i < vecs; i += blockDim.x) {
      d0[i] = s0 ? s0[i] : zero4;
      if (d1) d1[i] = s1 ? s1[i] : zero4;
    }
  }
}

__host__ inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <typename T>
__host__ inline cudaError_t launch_fill_pad_tiles(
    const T* mask, int n_tiles, int edge_tile, int h, T* dst0, const T* src0,
    T* dst1, const T* src1, cudaStream_t stream) {
  const int grid = n_tiles < 4 * sm_count() ? n_tiles : 4 * sm_count();
  if (grid == 0) return cudaSuccess;
  fill_pad_tiles<T><<<grid, 256, 0, stream>>>(mask, n_tiles, edge_tile, h,
                                              dst0, src0, dst1, src1);
  return cudaGetLastError();
}

}  // namespace chain
