// One 128-row chunk of the fused node block's backward: the device code of
// the node half of K9-bwd (fused_mgn_bwd.cu), which K4 ran before its row
// kernel (node_bwd_rows.cuh, the same math and rounding points). The VJP
// of K3 (node_fwd_rows.cuh, whose rounding points the recompute follows)
// for the cotangent ct of x' = x + LayerNorm(MLP([x, agg])): per node row
// it recomputes
//
//   a0 = relu(x @ W1x + agg @ W1a + b1)   (the two products summed in fp32
//                                          before rounding, as K3 and the
//                                          TPU kernel, pallas_node.py:212)
//   a(i+1) = relu(a(i) @ ws[i] + bs[i]);  d = a(nh) @ W_out + b_out
//
// with the LayerNorm statistics in fp32, then (pallas_node.py:226-265)
//
//   d_d  = LayerNorm backward of ct;  dz = (d_d @ W_out^T) * (a(nh) > 0)
//   dz   = (dz @ ws[i]^T) * (a(i) > 0)           (hidden stack, reverse)
//   d_x  = ct + dz @ W1x^T   (the residual),   d_agg = dz @ W1a^T
//
// and the fp32 weight gradients dW1x = x^T dz, dW1a = agg^T dz, db1, dWs,
// dbs, dW_out, db_out, dscale, dbias, added to the CTA's partials
// (chain_bwd.cuh).
#pragma once

#include "chain_bwd.cuh"

namespace chain {

template <typename T>
struct NodeBwdArgs {
  const T *x, *agg;
  // the weights [W1x, W1a, ws[0..nh), W_out] each twice, [n][2][H][H]
  // (ops/_build.py mma_b_operands)
  const T *wb, *b1, *bs, *b_out, *ln_scale, *ct;
  T *d_x, *d_agg;
  int n_hidden;
};

constexpr int kNodeDz = 0;    // buffer: running cotangent dz (and d_d)
constexpr int kNodeX = 1;     // buffer: x rows
constexpr int kNodeAgg = 2;   // buffer: agg rows
constexpr int kNodeAct0 = 3;  // buffers: a(0) .. a(nh)

// Rows [r0, r0 + kRows). `mats` is the CTA's fp32 partial of [dW1x, dW1a,
// dWs[0..nh), dW_out] ([H, H] each), `vecs` its shared-memory [db_out,
// dscale, dbias, db1, dbs[0..nh)] ([H] each). Every thread of the CTA
// calls it; it ends with a __syncthreads.
template <typename T, int H>
__device__ void node_bwd_chunk(const NodeBwdArgs<T>& a, const BwdCta<T, H>& c,
                               float* mats, float* vecs, int64_t r0) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  const int nh = a.n_hidden;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  auto mat = [&](int m) { return mats + size_t(m) * H * H; };
  const int64_t rw = r0 + wrow;
  const int64_t ra = rw + g, rb = rw + g + 8;
  T* x_w = c.buf(kNodeX) + wrow * LD;
  T* agg_w = c.buf(kNodeAgg) + wrow * LD;
  T* dz_w = c.buf(kNodeDz) + wrow * LD;
  float acc[H / 8][4];
  load_rows<T, H>(x_w, a.x + rw * H);
  load_rows<T, H>(agg_w, a.agg + rw * H);
  __syncwarp();

  // ---- forward recompute, as K3 ----
  zero<H>(acc);
  c.stage(a.wb, 0, false);
  mm<H>(x_w, c.slot, acc);
  c.stage(a.wb, 1, false);
  mm<H>(agg_w, c.slot, acc);
  bias_relu_store<T, H>(acc, a.b1, c.buf(kNodeAct0) + wrow * LD);
  __syncwarp();
  for (int i = 0; i < nh; ++i) {
    c.stage(a.wb, 2 + i, false);
    zero<H>(acc);
    mm<H>(c.buf(kNodeAct0 + i) + wrow * LD, c.slot, acc);
    __syncwarp();
    bias_relu_store<T, H>(acc, a.bs + size_t(i) * H,
                          c.buf(kNodeAct0 + i + 1) + wrow * LD);
    __syncwarp();
  }
  c.stage(a.wb, nh + 2, false);
  zero<H>(acc);
  mm<H>(c.buf(kNodeAct0 + nh) + wrow * LD, c.slot, acc);
  bias_round<T, H>(acc, a.b_out);

  // ---- LayerNorm backward ----
  {
    float ct[H / 8][4];
    load_acc<T, H>(ct, a.ct + ra * H, a.ct + rb * H);
    ln_backward<T, H>(acc, ct, a.ln_scale, c.warp_part);
  }
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * t;
    N::store2(dz_w + g * LD + col, acc[j][0], acc[j][1]);
    N::store2(dz_w + (g + 8) * LD + col, acc[j][2], acc[j][3]);
  }
  __syncthreads();
  add_warp_parts<H>(c.warp_part, vecs + H);
  add_warp_parts<H>(c.warp_part + kWarps * H, vecs + 2 * H);
  column_sum<T, H>(c.buf(kNodeDz), vecs);
  weight_grad<T, H>(c.buf(kNodeAct0 + nh), c.buf(kNodeDz), mat(nh + 2));

  // ---- output linear and hidden stack, in reverse ----
  c.stage(a.wb, nh + 2, true);
  zero<H>(acc);
  mm<H>(dz_w, c.slot, acc);
  __syncwarp();
  relu_grad_store<T, H>(acc, c.buf(kNodeAct0 + nh) + wrow * LD, dz_w);
  __syncthreads();
  for (int i = nh - 1; i >= 0; --i) {
    column_sum<T, H>(c.buf(kNodeDz), vecs + size_t(4 + i) * H);
    weight_grad<T, H>(c.buf(kNodeAct0 + i), c.buf(kNodeDz), mat(2 + i));
    c.stage(a.wb, 2 + i, true);
    zero<H>(acc);
    mm<H>(dz_w, c.slot, acc);
    __syncwarp();
    relu_grad_store<T, H>(acc, c.buf(kNodeAct0 + i) + wrow * LD, dz_w);
    __syncthreads();
  }

  // ---- first (split) linear: dW1x, dW1a, db1, d_x, d_agg ----
  column_sum<T, H>(c.buf(kNodeDz), vecs + 3 * H);
  weight_grad<T, H>(c.buf(kNodeX), c.buf(kNodeDz), mat(0));
  weight_grad<T, H>(c.buf(kNodeAgg), c.buf(kNodeDz), mat(1));
  c.stage(a.wb, 0, true);
  zero<H>(acc);
  mm<H>(dz_w, c.slot, acc);
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 ca = N::load2(a.ct + ra * H + col);
    const float2 cb = N::load2(a.ct + rb * H + col);
    N::store2(a.d_x + ra * H + col, N::rnd(ca.x + N::rnd(acc[j][0])),
              N::rnd(ca.y + N::rnd(acc[j][1])));
    N::store2(a.d_x + rb * H + col, N::rnd(cb.x + N::rnd(acc[j][2])),
              N::rnd(cb.y + N::rnd(acc[j][3])));
  }
  c.stage(a.wb, 1, true);
  zero<H>(acc);
  mm<H>(dz_w, c.slot, acc);
  store_acc<T, H>(acc, a.d_agg + ra * H, a.d_agg + rb * H);
  __syncthreads();
}

}  // namespace chain
