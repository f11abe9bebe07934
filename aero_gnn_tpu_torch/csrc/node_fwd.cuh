// One 128-row chunk of the fused node block + residual: the device code of
// kernel K3 (fused_node_fwd.cu) and of the node half of K9-fwd
// (fused_mgn_fwd.cu). Per node row
//
//   z  = relu(x @ W1x + agg @ W1a + b1)     (concat first linear, split)
//   z  = relu(z @ ws[i] + bs[i])            (i < n_hidden)
//   d  = z @ W_out + b_out
//   x' = x + LayerNorm(d)                   (fp32 stats, eps 1e-5)
//
// As in the TPU kernel, x @ W1x + agg @ W1a is summed in fp32 before the
// first rounding to the compute type; every later rounding point matches
// the plain version. Each warp owns 16 rows of the activation buffer, so
// the chain needs only __syncwarp (and the CTA barriers of streamed
// weights).
#pragma once

#include "chain.cuh"

namespace chain {

template <typename T>
struct NodeFwdArgs {
  const T *x, *agg, *w1x, *w1a, *b1, *ws, *bs, *w_out, *b_out, *ln_scale,
      *ln_bias;
  T* out;
  int n_hidden;

  // weights in chain order: 0 W1x, 1 W1a, 2.. ws[i], n_hidden + 2 W_out
  template <int H>
  __device__ const T* weight(int m) const {
    if (m == 0) return w1x;
    if (m == 1) return w1a;
    return m <= n_hidden + 1 ? ws + size_t(m - 2) * H * H : w_out;
  }
};

// Rows [r0, r0 + kRows) of x'. `act` is the CTA's [kRows][LD] activation
// buffer. Every thread of the CTA calls it.
template <typename T, int H>
__device__ void node_fwd_chunk(const NodeFwdArgs<T>& a,
                               const WeightSlots<T, H>& w, T* act,
                               int64_t r0) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* my_act = act + warp * 16 * LD;
  const int64_t rw = r0 + warp * 16;
  const int64_t ra = rw + g, rb = rw + g + 8;
  float acc[H / 8][4];

  zero<H>(acc);
  load_rows<T, H>(my_act, a.x + rw * H);
  __syncwarp();
  mm<H>(my_act, w.use(0, a.template weight<H>(0)), acc);
  __syncwarp();
  load_rows<T, H>(my_act, a.agg + rw * H);
  __syncwarp();
  mm<H>(my_act, w.use(1, a.template weight<H>(1)), acc);
  __syncwarp();
  bias_relu_store<T, H>(acc, a.b1, my_act);
  __syncwarp();

  for (int i = 0; i < a.n_hidden; ++i) {
    zero<H>(acc);
    mm<H>(my_act, w.use(2 + i, a.template weight<H>(2 + i)), acc);
    __syncwarp();
    bias_relu_store<T, H>(acc, a.bs + size_t(i) * H, my_act);
    __syncwarp();
  }

  zero<H>(acc);
  mm<H>(my_act, w.use(a.n_hidden + 2, a.template weight<H>(a.n_hidden + 2)),
        acc);
  __syncwarp();
  bias_layer_norm<T, H>(acc, a.b_out, a.ln_scale, a.ln_bias);
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 xa = N::load2(a.x + ra * H + col);
    const float2 xb = N::load2(a.x + rb * H + col);
    N::store2(a.out + ra * H + col, N::rnd(xa.x + acc[j][0]),
              N::rnd(xa.y + acc[j][1]));
    N::store2(a.out + rb * H + col, N::rnd(xb.x + acc[j][2]),
              N::rnd(xb.y + acc[j][3]));
  }
}

}  // namespace chain
