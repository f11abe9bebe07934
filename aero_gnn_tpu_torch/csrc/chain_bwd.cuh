// Shared pieces of the fused backward kernels' row machinery
// (rows_bwd.cuh, for K2 and K8 in edge_bwd_rows.cuh, K4 in
// node_bwd_rows.cuh and K9-bwd in fused_mgn_bwd.cu), on top of chain.cuh:
// the mma.sync and ldmatrix.trans primitives, the warps' tile of an [H, H]
// weight gradient (TnTile), the LayerNorm backward of a warp's rows in
// registers, and reduce_partials, which sums the weight-gradient kernels'
// per-split fp32 partials in split order (no float atomics: two launches
// on the same inputs give the same bits).
#pragma once

#include "chain.cuh"

namespace chain {

// Output tile of a warp in the [H, H] weight-gradient product.
template <int H>
struct TnTile {
  static constexpr int MT = H / 16;         // 16-row tiles of the output
  static constexpr int WPM = kWarps / MT;   // warps sharing one row tile
  static constexpr int NT = H / 8 / WPM;    // 8-column tiles per warp
  static_assert(MT <= kWarps && kWarps % MT == 0, "unsupported width");
  __device__ __forceinline__ static int m0() {
    return 16 * ((threadIdx.x >> 5) % MT);
  }
  __device__ __forceinline__ static int n0() {
    return 8 * NT * ((threadIdx.x >> 5) / MT);
  }
};

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8q..8q+7
// give the row addresses of matrix q; lane (g, t) receives its elements
// [2t][g] and [2t+1][g] in register q.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sum of x over the 8 row pairs (lanes with the same t) of a warp.
__device__ __forceinline__ float sum_rows(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

// LayerNorm backward of the warp's rows, in registers. On entry acc holds
// the rounded pre-LayerNorm d, ct the (rounded) cotangent of the LN output
// as fp32, mu / inv the fp32 statistics of d (rows g, g + 8). On exit acc
// holds d_d = rnd((g - mean(g) - xn mean(g xn)) inv), g = ct * scale, and
// warp_part[warp][c] / warp_part[kWarps + warp][c] hold the warp's column
// sums of ct * xn (scale grad) and ct (bias grad).
template <typename T, int H>
__device__ __forceinline__ void ln_backward(float (&acc)[H / 8][4],
                                            const float (&ct)[H / 8][4],
                                            const T* __restrict__ scale,
                                            float* warp_part,
                                            const float (&mu)[2],
                                            const float (&inv)[2]) {
  using N = Num<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float sg[2] = {0.f, 0.f}, sgx[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const float2 sc = N::load2(scale + 8 * j + 2 * t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int half = q >> 1;
      const float xn = (acc[j][q] - mu[half]) * inv[half];
      acc[j][q] = xn;
      const float gg = ct[j][q] * ((q & 1) ? sc.y : sc.x);
      sg[half] += gg;
      sgx[half] += gg * xn;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    sg[half] += __shfl_xor_sync(0xffffffffu, sg[half], 1);
    sg[half] += __shfl_xor_sync(0xffffffffu, sg[half], 2);
    sgx[half] += __shfl_xor_sync(0xffffffffu, sgx[half], 1);
    sgx[half] += __shfl_xor_sync(0xffffffffu, sgx[half], 2);
    sg[half] *= 1.f / H;
    sgx[half] *= 1.f / H;
  }
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 sc = N::load2(scale + col);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float s_x = sum_rows(ct[j][q] * acc[j][q] +
                                 ct[j][q + 2] * acc[j][q + 2]);
      const float s_c = sum_rows(ct[j][q] + ct[j][q + 2]);
      if (g == 0) {
        warp_part[warp * H + col + q] = s_x;
        warp_part[(kWarps + warp) * H + col + q] = s_c;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int half = q >> 1;
      const float gg = ct[j][q] * ((q & 1) ? sc.y : sc.x);
      acc[j][q] = N::rnd((gg - sg[half] - acc[j][q] * sgx[half]) * inv[half]);
    }
  }
}

// The same, with the statistics of d computed here (two-pass, as the
// forward).
template <typename T, int H>
__device__ __forceinline__ void ln_backward(float (&acc)[H / 8][4],
                                            const float (&ct)[H / 8][4],
                                            const T* __restrict__ scale,
                                            float* warp_part) {
  float mu[2], inv[2];
  row_stats<H>(acc, 0, mu[0], inv[0]);
  row_stats<H>(acc, 1, mu[1], inv[1]);
  ln_backward<T, H>(acc, ct, scale, warp_part, mu, inv);
}

// out[i] = sum over splits c = 0, 1, ... of part[c][i], in that order.
static __global__ void reduce_partials(const float* __restrict__ part,
                                       int n_parts, int64_t len,
                                       float* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int c = 0; c < n_parts; ++c) s += part[int64_t(c) * len + i];
  out[i] = s;
}

__host__ inline cudaError_t launch_reduce(const float* part, int n_parts,
                                          int64_t len, float* out,
                                          cudaStream_t stream) {
  const int threads = 256;
  reduce_partials<<<unsigned((len + threads - 1) / threads), threads, 0,
                    stream>>>(part, n_parts, len, out);
  return cudaGetLastError();
}

}  // namespace chain
