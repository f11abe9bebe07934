// Kernel K3 of the port: the fused node block + residual's forward as a row
// kernel, and its chunk body, which K9-fwd (fused_mgn_fwd.cu) runs on each
// node block. Per node row
//
//   z  = relu(x @ W1x + agg @ W1a + b1)     (concat first linear, split)
//   z  = relu(z @ ws[i] + bs[i])            (i < n_hidden)
//   d  = z @ W_out + b_out
//   x' = x + LayerNorm(d)                   (fp32 stats, eps 1e-5)
//
// As in the TPU kernel (pallas_node.py:79-81), x @ W1x and agg @ W1a go
// into one fp32 accumulator before the single rounding to the compute
// type; every later rounding point matches the plain version, and the
// products, their k order and the LayerNorm sums are those of the
// shared-memory chain this kernel replaced, so x' keeps its bits.
//
// node_fwd_rows_kernel: each warp owns 16 rows of a 128-row chunk and runs
// the whole chain for them with no CTA barrier between products (the
// forward half of K4's row kernel, node_bwd_rows.cuh, laid out as K1's,
// edge_fwd_rows.cuh, on rows_bwd.cuh's machinery). In bf16 the activation
// never leaves registers (the mma accumulator of one product, rounded and
// packed in pairs, is the A fragment of the next), x's fragments are kept
// for the residual, agg's are loaded during x's product, and the n_hidden +
// 3 weights stay resident in shared memory for the CTA's life where they
// fit, read by ldmatrix.trans as they lie ([in][out]). fp32 (FFMA, no TF32)
// runs its products on RowTile over each warp's A operand slice and streams
// the weights through the two-slot ring (one CTA barrier a product), the
// last product moved to the accumulator layout through the slice so the
// LayerNorm statistics sum in the same order. The CTAs walk the chunks
// round robin. No reduction crosses rows: the result is deterministic.
//
// The plan (grid, resident weights or the ring, shared memory) is made in
// Python (ops/hopper_node.py node_fwd_plan) and checked here.
#pragma once

#include "rows_bwd.cuh"

namespace chain {

template <typename T>
struct NodeFwdArgs {
  const T *x, *agg, *w1x, *w1a, *b1, *ws, *bs, *w_out, *b_out, *ln_scale,
      *ln_bias;
  T* out;
  int64_t n_rows;
  int n_hidden, n_chunks;
};

// The chain's weights (0 W1x, 1 W1a, 2.. ws[i], n_hidden + 2 W_out).
template <typename T, int H>
__device__ __forceinline__ FwdChain<T, H> node_chain(
    const NodeFwdArgs<T>& a) {
  return {a.w1x, a.w1a, a.ws, a.w_out, 2, a.n_hidden + 3};
}

// Rows [r0, r0 + kRows) of x'. get(m) gives product m's [in][out] weight
// tile in shared memory; stg is the warp's [16][LD] fp32 A operand slice.
// Every thread of the CTA calls it.
template <typename T, int H, typename Get>
__device__ __forceinline__ void node_rows_chunk(const NodeFwdArgs<T>& a,
                                                Get&& get, T* stg,
                                                int64_t r0) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  const int nh = a.n_hidden;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t rw = r0 + warp * 16;
  const int64_t ra = rw + g, rb = ra + 8;
  float acc[H / 8][4];
  // x' = x + LayerNorm(acc + b_out), acc the last product; x_at(j) gives
  // x's values at acc[j] (rows ra, rb)
  auto finish = [&](auto x_at) {
    bias_round<T, H>(acc, a.b_out);
    float mu[2], inv[2];
    row_stats<H>(acc, 0, mu[0], inv[0]);
    row_stats<H>(acc, 1, mu[1], inv[1]);
    layer_norm_rows<T, H>(acc, mu, inv, a.ln_scale, a.ln_bias);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float4 xv = x_at(j);
      N::store2(a.out + ra * H + col, N::rnd(xv.x + acc[j][0]),
                N::rnd(xv.y + acc[j][1]));
      N::store2(a.out + rb * H + col, N::rnd(xv.z + acc[j][2]),
                N::rnd(xv.w + acc[j][3]));
    }
  };
  if constexpr (sizeof(T) == 2) {
    // x's fragments (kept for the residual: they are x's rows ra / rb in
    // the accumulator layout) and agg's, in flight during x's product
    RowOperand<T, H> xo, op;
    xo.from_rows(a.x + ra * H, a.x + rb * H, stg);
    op.from_rows(a.agg + ra * H, a.agg + rb * H, stg);
    zero<H>(acc);
    xo.template mm<true>(get(0), acc, stg);
    op.template mm<true>(get(1), acc, stg);
    bias_relu<T, H>(acc, a.b1);
    for (int i = 0; i <= nh; ++i) {
      op.from_acc(acc, stg);
      zero<H>(acc);
      op.template mm<true>(get(2 + i), acc, stg);
      if (i < nh) bias_relu<T, H>(acc, a.bs + size_t(i) * H);
    }
    finish([&](int j) {
      const float2 xa = widen(xo.f[j / 2][2 * (j & 1)]);
      const float2 xb = widen(xo.f[j / 2][2 * (j & 1) + 1]);
      return make_float4(xa.x, xa.y, xb.x, xb.y);
    });
  } else {
    // fp32: x @ W1x, then agg @ W1a continuing the same fma chains
    RowTile<H> tl;
    __syncwarp();  // the chunk before has read the slice
    load_rows<float, H>(stg, a.x + rw * H);
    __syncwarp();
    tl.mm(stg, get(0));
    __syncwarp();  // the product has read the slice
    load_rows<float, H>(stg, a.agg + rw * H);
    __syncwarp();
    tl.template mm<false>(stg, get(1));
    tl.bias_relu(a.b1);
    for (int i = 0; i <= nh; ++i) {
      __syncwarp();  // the product has read the slice
      tl.store(stg, LD);
      __syncwarp();
      tl.mm(stg, get(2 + i));
      if (i < nh) tl.bias_relu(a.bs + size_t(i) * H);
    }
    tl.to_acc(acc, stg);
    finish([&](int j) {
      const int col = 8 * j + 2 * t;
      const float2 xa = N::load2(a.x + ra * H + col);
      const float2 xb = N::load2(a.x + rb * H + col);
      return make_float4(xa.x, xa.y, xb.x, xb.y);
    });
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
node_fwd_rows_kernel(NodeFwdArgs<T> a, int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  constexpr size_t kMat = FwdWeights<T, H>::kMat;
  FwdWeights<T, H> w{node_chain<T, H>(a), {reinterpret_cast<T*>(smem_raw), 0},
                     resident};
  // fp32: the warps' A operand slices ([kRows][LD] after the weights)
  T* stg = reinterpret_cast<T*>(smem_raw) +
           (resident ? a.n_hidden + 3 : 2) * kMat +
           size_t(warp) * 16 * Layout<T, H>::kLd;
  w.start();
  for (int ch = blockIdx.x; ch < a.n_chunks; ch += gridDim.x)
    node_rows_chunk<T, H>(a, [&](int m) { return w.get(m); }, stg,
                          int64_t(ch) * kRows);
  w.finish();
}

// The launch on `stream`. `grid` and `resident` are the plan's, checked
// against this side's reckoning.
template <typename T, int H>
cudaError_t launch_node_fwd_rows(NodeFwdArgs<T> a, int grid, int resident,
                                 cudaStream_t stream) {
  if (a.n_hidden < 0 || a.n_rows <= 0 || a.n_rows % kRows)
    return cudaErrorInvalidValue;
  a.n_chunks = int(a.n_rows / kRows);
  if (grid <= 0 || grid > a.n_chunks) return cudaErrorInvalidValue;
  int fits = 0;
  size_t smem = 0;
  cudaError_t err = fwd_rows_smem<T, H>(a.n_hidden + 3, &fits, &smem);
  if (err != cudaSuccess) return err;
  if (fits != resident) return cudaErrorInvalidValue;
  auto kernel = node_fwd_rows_kernel<T, H>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a, resident);
  return cudaGetLastError();
}

}  // namespace chain
