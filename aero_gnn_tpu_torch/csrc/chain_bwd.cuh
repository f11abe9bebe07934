// Shared pieces of the fused backward kernels (edge_bwd.cuh: K8 and the
// edge half of K9-bwd; node_bwd.cuh: the node half of K9-bwd; some of them
// K2's and K4's row kernels too, through rows_bwd.cuh), on top of
// chain.cuh.
//
// A CTA walks row chunks of 128 rows, recomputes the forward chain of a
// chunk (or, in K8, reads the activations the forward saved) and runs its
// backward. Per chunk it keeps in "buffers" (each
// [128][LD] of T) the activations the backward needs: the chain's inputs,
// every post-ReLU activation and the running cotangent dz. One weight slot
// in shared memory is reloaded per stage, in the orientation the product
// needs (B = W forward, B = W^T backward, both laid out by the wrapper:
// `wb` holds [n_mats][2][H][H]). Buffers live in shared memory as
// far as it goes and in a per-CTA slice of a device scratch area past that
// (fp32 at h = 128): the same generic-pointer code reads both.
//
// Weight gradients. The products act^T dz contract over the chunk's rows
// (mma.sync on fragments that ldmatrix.trans loads): warp w owns a tile
// of the [H, H] result (TnTile) and adds it into its CTA's private fp32
// partial in device memory (each element read and written by one thread
// only). Bias and LayerNorm gradients are column sums
// kept per CTA in shared memory, each column owned by one thread. A second
// kernel (reduce_partials) sums the CTAs' partials in CTA order. No float
// atomics: two launches on the same inputs give the same bits.
#pragma once

#include "chain.cuh"

namespace chain {

// One B operand into the weight slot: `src` is an [H, H] matrix already in
// the order mm<H> reads (bf16 [n][k], fp32 [k][n]; the wrapper lays out
// each weight twice, for the forward product act @ W and the backward
// product dz @ W^T), copied row by row into the padded slot, 16 bytes per
// thread and load.
template <typename T, int H>
__device__ __forceinline__ void load_b(T* dst, const T* __restrict__ src) {
  constexpr int LD = Layout<T, H>::kLd;
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = H / V;
  for (int i = threadIdx.x; i < H * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + size_t(r) * H + c);
  }
}

// out = rnd(acc) where act > 0, else 0: the ReLU's backward, written to
// the warp's rows of `out` (which may be the buffer acc was read from,
// after a __syncwarp).
template <typename T, int H>
__device__ __forceinline__ void relu_grad_store(const float (&acc)[H / 8][4],
                                                const T* act, T* out) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 a0 = N::load2(act + g * LD + col);
    const float2 a1 = N::load2(act + (g + 8) * LD + col);
    N::store2(out + g * LD + col, a0.x > 0.f ? N::rnd(acc[j][0]) : 0.f,
              a0.y > 0.f ? N::rnd(acc[j][1]) : 0.f);
    N::store2(out + (g + 8) * LD + col, a1.x > 0.f ? N::rnd(acc[j][2]) : 0.f,
              a1.y > 0.f ? N::rnd(acc[j][3]) : 0.f);
  }
}

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

__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* lo,
                                          const __nv_bfloat16* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

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

// acc (the warp's TnTile) += A^T D over the chunk's kRows rows; A, D are
// [kRows][LD] buffers; the fragments of A'[m][r] = A[r][m] and
// B'[r][n] = D[r][n] are the buffers' 8x8 blocks transposed. In shared
// memory ldmatrix.trans loads them (one instruction for A', one per two
// column tiles of B'); a buffer in device scratch takes 16-bit loads.
template <int H>
__device__ __forceinline__ void mm_tn(const __nv_bfloat16* a,
                                      const __nv_bfloat16* d,
                                      float (&acc)[TnTile<H>::NT][4]) {
  constexpr int LD = Layout<__nv_bfloat16, H>::kLd;
  constexpr int NT = TnTile<H>::NT;
  static_assert(NT % 2 == 0, "column tiles go in pairs");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = TnTile<H>::m0(), n0 = TnTile<H>::n0();
  if (__isShared(a) && __isShared(d)) {
    const int q = lane >> 3, r8 = lane & 7;
    for (int kk = 0; kk < kRows; kk += 16) {
      uint32_t af[4];  // blocks (rows +0/+8, cols m0 +0/+8) -> a0..a3
      ldsm_x4_trans(af, a + (kk + r8 + (q >> 1) * 8) * LD + m0 + (q & 1) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bf[4];  // b0, b1 of column tile j, then of tile j + 1
        ldsm_x4_trans(bf, d + (kk + r8 + (q & 1) * 8) * LD + n0 + 8 * j +
                              (q >> 1) * 8);
        mma_bf16(acc[j], af, bf[0], bf[1]);
        mma_bf16(acc[j + 1], af, bf[2], bf[3]);
      }
    }
    return;
  }
  for (int kk = 0; kk < kRows; kk += 16) {
    const __nv_bfloat16* p = a + (kk + 2 * t) * LD + m0 + g;
    const uint32_t af[4] = {pack2(p, p + LD), pack2(p + 8, p + LD + 8),
                            pack2(p + 8 * LD, p + 9 * LD),
                            pack2(p + 8 * LD + 8, p + 9 * LD + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* q = d + (kk + 2 * t) * LD + n0 + 8 * j + g;
      mma_bf16(acc[j], af, pack2(q, q + LD), pack2(q + 8 * LD, q + 9 * LD));
    }
  }
}

// fp32: FFMA in the same register layout.
template <int H>
__device__ __forceinline__ void mm_tn(const float* a, const float* d,
                                      float (&acc)[TnTile<H>::NT][4]) {
  constexpr int LD = Layout<float, H>::kLd;
  constexpr int NT = TnTile<H>::NT;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = TnTile<H>::m0(), n0 = TnTile<H>::n0();
#pragma unroll 2
  for (int r = 0; r < kRows; ++r) {
    const float x0 = a[r * LD + m0 + g], x1 = a[r * LD + m0 + g + 8];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b =
          *reinterpret_cast<const float2*>(d + r * LD + n0 + 8 * j + 2 * t);
      acc[j][0] = fmaf(x0, b.x, acc[j][0]);
      acc[j][1] = fmaf(x0, b.y, acc[j][1]);
      acc[j][2] = fmaf(x1, b.x, acc[j][2]);
      acc[j][3] = fmaf(x1, b.y, acc[j][3]);
    }
  }
}

// part[H][H] (this CTA's fp32 partial of one weight gradient) += A^T D.
template <typename T, int H>
__device__ __forceinline__ void weight_grad(const T* a, const T* d,
                                            float* __restrict__ part) {
  constexpr int NT = TnTile<H>::NT;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  mm_tn<H>(a, d, acc);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = TnTile<H>::m0(), n0 = TnTile<H>::n0();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    float2* p0 = reinterpret_cast<float2*>(part + (m0 + g) * H + col);
    float2* p1 = reinterpret_cast<float2*>(part + (m0 + g + 8) * H + col);
    float2 v0 = *p0, v1 = *p1;
    v0.x += acc[j][0];
    v0.y += acc[j][1];
    v1.x += acc[j][2];
    v1.y += acc[j][3];
    *p0 = v0;
    *p1 = v1;
  }
}

// vec[c] += sum over the chunk's rows of buf[r][c], thread c < H.
template <typename T, int H>
__device__ __forceinline__ void column_sum(const T* buf, float* vec) {
  constexpr int LD = Layout<T, H>::kLd;
  const int c = threadIdx.x;
  if (c < H) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += Num<T>::load1(buf + r * LD + c);
    vec[c] += s;
  }
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

// After a __syncthreads: vec[c] += sum over warps (in order) of
// warp_part[w][c], thread c < H.
template <int H>
__device__ __forceinline__ void add_warp_parts(const float* warp_part,
                                               float* vec) {
  const int c = threadIdx.x;
  if (c < H) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_part[w * H + c];
    vec[c] += s;
  }
}

// How a backward launch uses memory: one CTA per SM at most (persistent
// over `n_work` units), the weight slot plus `n_smem` of the `n_bufs`
// buffers in shared memory, the rest in a device scratch slice per CTA;
// each CTA's fp32 partial of the `n_mats` [H, H] and `n_vecs` [H] weight
// gradients sits at the front of the workspace.
struct BwdPlan {
  int grid = 0;
  int n_smem = 0;
  size_t smem = 0;
  int64_t part_len = 0;       // floats per CTA partial (= result length)
  int64_t ws_bytes = 0;       // partials + scratch buffers
};

template <typename T, int H>
__host__ inline cudaError_t plan_bwd(int n_bufs, int n_mats, int n_vecs,
                                     int64_t n_work, BwdPlan* p) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t budget = size_t(max_smem) - 256;  // room for static smem
  const size_t fixed = Layout<T, H>::kMatBytes +
                       kRows * (sizeof(int) + sizeof(float)) +
                       (2 * kWarps + size_t(n_vecs)) * H * sizeof(float);
  if (fixed > budget) return cudaErrorInvalidValue;
  const size_t fit = (budget - fixed) / Layout<T, H>::kActBytes;
  p->n_smem = int(fit < size_t(n_bufs) ? fit : size_t(n_bufs));
  p->smem = fixed + size_t(p->n_smem) * Layout<T, H>::kActBytes;
  p->grid = int(n_work < sm_count() ? n_work : sm_count());
  p->part_len = int64_t(n_mats) * H * H + int64_t(n_vecs) * H;
  p->ws_bytes = int64_t(p->grid) * p->part_len * int64_t(sizeof(float)) +
                int64_t(p->grid) * (n_bufs - p->n_smem) *
                    int64_t(Layout<T, H>::kActBytes);
  return cudaSuccess;
}

// A backward CTA's memory as plan_bwd lays it out: in shared memory the
// weight slot, the first n_smem buffers, the chunk's receivers and mask,
// the warps' LayerNorm column partials ([2][kWarps][H]) and the CTA's
// vector gradients; past n_smem, the buffers in the CTA's slice of the
// device scratch.
template <typename T, int H>
struct BwdCta {
  static constexpr int LD = Layout<T, H>::kLd;
  T *slot, *sbuf, *gbuf;
  int n_smem;
  int* recv_s;
  float *mask_s, *warp_part, *vec_s;

  __device__ BwdCta(unsigned char* smem_raw, T* scratch, int n_bufs,
                    int n_smem_bufs)
      : slot(reinterpret_cast<T*>(smem_raw)),
        sbuf(slot + H * LD),
        gbuf(scratch + size_t(blockIdx.x) * (n_bufs - n_smem_bufs) * kRows *
                           LD),
        n_smem(n_smem_bufs),
        recv_s(reinterpret_cast<int*>(sbuf + size_t(n_smem_bufs) * kRows *
                                                 LD)),
        mask_s(reinterpret_cast<float*>(recv_s + kRows)),
        warp_part(mask_s + kRows),
        vec_s(warp_part + 2 * kWarps * H) {}

  __device__ T* buf(int b) const {
    return b < n_smem ? sbuf + size_t(b) * kRows * LD
                      : gbuf + size_t(b - n_smem) * kRows * LD;
  }
  // B operand m of `wb` ([n][2][H][H]: [m][0] for the forward product
  // act @ W, [m][1] for the backward product dz @ W^T) into the slot; the
  // whole CTA takes part.
  __device__ void stage(const T* wb, int m, bool transpose) const {
    __syncthreads();
    load_b<T, H>(slot, wb + (size_t(m) * 2 + transpose) * H * H);
    __syncthreads();
  }
};

// Zero a CTA's weight-gradient partial (n_mats [H, H]) and its vector
// gradients in shared memory (n_vecs [H]).
template <int H>
__device__ inline void zero_grads(float* part, int n_mats, float* vec_s,
                                  int n_vecs) {
  for (int64_t i = threadIdx.x; i < int64_t(n_mats) * H * H; i += kThreads)
    part[i] = 0.f;
  for (int i = threadIdx.x; i < n_vecs * H; i += kThreads) vec_s[i] = 0.f;
}

// out[i] = sum over CTAs c = 0, 1, ... of part[c][i], in that order.
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
