// Fused node block + residual, backward (kernel K4 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_node.py _fnl_bwd (pallas_call of
// _make_bwd_kernel). The VJP of K3 (fused_node_fwd.cu) for the cotangent ct
// of x' = x + LayerNorm(MLP([x, agg])). The math, its rounding points and
// the schedule are node_bwd_rows.cuh's, whose chunk body K9-bwd runs too.
//
// Bound on the H100 (flagship N = 66,048, h = 128, 2 hidden): 3 x 5
// products of 2*N*h^2 = 32 GFLOP per launch; bytes: read x, agg, ct, write
// d_x, d_agg (~85 MB in bf16, 0.025 ms at 3.35 TB/s). bf16: the
// operations bound it (0.033 ms at the tensor-core peak); fp32: FFMA
// bounds it (0.49 ms). The earlier schedule (one CTA per SM over 128-row
// chunks, the weights restaged through one shared slot ten times a chunk
// between CTA barriers, the weight-gradient partials read and written in
// device memory every chunk) ran at 3 % of the bf16 bound. This one runs
// each warp's rows without a CTA barrier, the weights resident (or
// double-buffered where they do not fit), and moves the weight gradients
// to a split-K kernel over the activations it writes: ~0.29 GB more
// traffic in bf16 at two hidden layers (written once, read once).

#include "node_bwd_rows.cuh"

namespace {

template <typename T, int H>
int launch(const void* x, const void* agg, const void* wb, const void* b1,
           const void* bs, const void* b_out, const void* ln_scale,
           const void* ct, void* d_x, void* d_agg, void* dw, void* workspace,
           int64_t ws_bytes, int64_t n_rows, int n_hidden, int grid,
           int resident, cudaStream_t stream) {
  chain::NodeRowsArgs<T> a{};
  a.x = static_cast<const T*>(x);
  a.agg = static_cast<const T*>(agg);
  a.wb = static_cast<const T*>(wb);
  a.b1 = static_cast<const T*>(b1);
  a.bs = static_cast<const T*>(bs);
  a.b_out = static_cast<const T*>(b_out);
  a.ln_scale = static_cast<const T*>(ln_scale);
  a.ct = static_cast<const T*>(ct);
  a.d_x = static_cast<T*>(d_x);
  a.d_agg = static_cast<T*>(d_agg);
  a.n_rows = n_rows;
  a.n_hidden = n_hidden;
  return int(chain::launch_node_rows_bwd<T, H>(
      a, static_cast<float*>(dw), workspace, ws_bytes, grid, resident,
      stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; h 64 or 128; n_rows % 128 == 0. wb:
// the weights [W1x, W1a, ws[0..nh), W_out] as the products read them
// (ops/_build.py edge_bwd_operands: bf16 [n][h][h], fp32 [n][2][h][h]). dw
// receives the fp32 weight gradients [dW1x, dW1a, dWs[0..nh), dW_out] ([h,
// h] each) then [db_out, dscale, dbias, db1, dbs[0..nh)] ([h] each). grid
// (the CTAs of both kernels and the number of partials), resident (the
// weights kept in shared memory, else streamed) and the workspace of at
// least chain::node_rows_workspace bytes: ops/hopper_node.py
// node_bwd_plan. Returns a cudaError_t (0 = success).
extern "C" int aero_fused_node_bwd(
    const void* x, const void* agg, const void* wb, const void* b1,
    const void* bs, const void* b_out, const void* ln_scale, const void* ct,
    void* d_x, void* d_agg, void* dw, void* workspace, int64_t ws_bytes,
    int64_t n_rows, int h, int n_hidden, int grid, int resident, int dtype,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define AERO_K4(T, H)                                                       \
  launch<T, H>(x, agg, wb, b1, bs, b_out, ln_scale, ct, d_x, d_agg, dw,     \
               workspace, ws_bytes, n_rows, n_hidden, grid, resident, s)
  if (dtype == 0 && h == 128) return AERO_K4(float, 128);
  if (dtype == 0 && h == 64) return AERO_K4(float, 64);
  if (dtype == 1 && h == 128) return AERO_K4(__nv_bfloat16, 128);
  if (dtype == 1 && h == 64) return AERO_K4(__nv_bfloat16, 64);
#undef AERO_K4
  return int(cudaErrorInvalidValue);
}
