// Shared pieces of the fused MLP-chain kernels (fused_edge_fwd.cu,
// fused_node_fwd.cu): a row chunk of 128 rows per CTA step, 8 warps of 16
// rows each, every h x h product as warp-level tiles whose accumulator
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
// rows of the activation buffer, so the chain needs only __syncwarp; when
// the weights do not all fit in shared memory at once ("resident"), they are
// streamed one matrix per stage and the whole CTA synchronises per stage.
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
  static constexpr bool kTransposeW = false;
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
  static constexpr bool kTransposeW = true;
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

// Copy one [H, H] weight ([in][out] in device memory) into shared memory in
// the layout the product wants. All threads of the CTA take part.
template <typename T, int H>
__device__ __forceinline__ void load_weight(T* dst, const T* __restrict__ src) {
  constexpr int LD = Layout<T, H>::kLd;
  if constexpr (Num<T>::kTransposeW) {
    for (int i = threadIdx.x; i < H * H; i += kThreads) {
      const int k = i / H, n = i % H;
      dst[n * LD + k] = src[i];
    }
  } else {
    for (int i = threadIdx.x; i < H * H / 4; i += kThreads) {
      const int k = (4 * i) / H, n = (4 * i) % H;
      *reinterpret_cast<float4*>(dst + k * LD + n) =
          reinterpret_cast<const float4*>(src)[i];
    }
  }
}

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

// acc = rnd(rnd(acc) + b_out); then LayerNorm of each row in place:
// acc = rnd((acc - mu) * inv * scale + bias), statistics in fp32.
template <typename T, int H>
__device__ __forceinline__ void bias_layer_norm(float (&acc)[H / 8][4],
                                                const T* __restrict__ b_out,
                                                const T* __restrict__ scale,
                                                const T* __restrict__ shift) {
  using N = Num<T>;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const float2 bo = N::load2(b_out + 8 * j + 2 * t);
    acc[j][0] = N::rnd(N::rnd(acc[j][0]) + bo.x);
    acc[j][1] = N::rnd(N::rnd(acc[j][1]) + bo.y);
    acc[j][2] = N::rnd(N::rnd(acc[j][2]) + bo.x);
    acc[j][3] = N::rnd(N::rnd(acc[j][3]) + bo.y);
  }
  float mu0, inv0, mu1, inv1;
  row_stats<H>(acc, 0, mu0, inv0);
  row_stats<H>(acc, 1, mu1, inv1);
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 sc = N::load2(scale + col), sh = N::load2(shift + col);
    acc[j][0] = N::rnd((acc[j][0] - mu0) * inv0 * sc.x + sh.x);
    acc[j][1] = N::rnd((acc[j][1] - mu0) * inv0 * sc.y + sh.y);
    acc[j][2] = N::rnd((acc[j][2] - mu1) * inv1 * sc.x + sh.x);
    acc[j][3] = N::rnd((acc[j][3] - mu1) * inv1 * sc.y + sh.y);
  }
}

// Shared memory the kernel needs: all n_mats weights resident when they fit
// (with the activation buffer and `extra` bytes), else one weight slot.
template <typename T, int H>
__host__ inline cudaError_t plan_smem(int n_mats, size_t extra, int* resident,
                                      size_t* bytes) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t budget = size_t(max_smem) - 256;  // room for static smem
  const size_t base = Layout<T, H>::kActBytes + extra;
  const size_t all = size_t(n_mats) * Layout<T, H>::kMatBytes + base;
  *resident = all <= budget;
  *bytes = *resident ? all : Layout<T, H>::kMatBytes + base;
  return *bytes <= budget ? cudaSuccess : cudaErrorInvalidValue;
}

__host__ inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace chain
