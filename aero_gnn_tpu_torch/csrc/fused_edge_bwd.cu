// Fused concat-trick edge layer, backward (kernel K2 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_fused.py _fel_bwd -> _fused_bwd
// (pallas_call of _make_bwd_kernel / _make_bwd_kernel_split). The VJP of
// K1 (fused_edge_fwd.cu) for the cotangents (ct_e of e', ct_agg of agg),
// recomputing K1's chain per row. The math, its rounding points and the
// schedule are edge_bwd_rows.cuh's, whose chunk body K8 (without the
// recompute) and K9-bwd run too.
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 3 x 4 products of 2*E*h^2 = 104 GFLOP per launch; bytes: read e, sg,
// ct_e, d_proj, ct_agg, recv, mask, write d_e, d_sg, d_dproj (~389 MB in
// bf16). bf16: bytes bound it (0.12 ms); fp32: FFMA bounds it (1.55 ms).
// The earlier schedule (one CTA per node block, the weights restaged
// through one shared slot eight times a chunk between CTA barriers, the
// weight-gradient partials read and written in device memory every chunk)
// ran at 4 % of the bf16 bound. This one keeps the weights resident (or
// double-buffered where they do not fit), runs each warp's rows without a
// CTA barrier and moves the weight gradients to a split-K kernel over the
// activations it writes: ~0.95 GB more traffic in bf16 at two hidden
// layers (written once, read once).

#include "edge_bwd_rows.cuh"

namespace {

template <typename T>
chain::RowsBwdArgs<T> rows_args(const void* e, const void* sg,
                                const void* d_proj, const void* mask,
                                const void* receivers, const void* wb,
                                const void* bs, const void* b_out,
                                const void* ln_scale, const void* ct_e,
                                const void* ct_agg, void* d_e, void* d_sg,
                                void* d_dproj, int64_t n_edges,
                                int64_t n_nodes, int n_hidden,
                                int edge_tile) {
  chain::RowsBwdArgs<T> a{};
  a.e = static_cast<const T*>(e);
  a.sg = static_cast<const T*>(sg);
  a.d_proj = static_cast<const T*>(d_proj);
  a.mask = static_cast<const T*>(mask);
  a.recv = static_cast<const int*>(receivers);
  a.wb = static_cast<const T*>(wb);
  a.bs = static_cast<const T*>(bs);
  a.b_out = static_cast<const T*>(b_out);
  a.ln_scale = static_cast<const T*>(ln_scale);
  a.ct_e = static_cast<const T*>(ct_e);
  a.ct_agg = static_cast<const T*>(ct_agg);
  a.d_e = static_cast<T*>(d_e);
  a.d_sg = static_cast<T*>(d_sg);
  a.d_dproj = static_cast<T*>(d_dproj);
  a.n_edges = n_edges;
  a.n_nodes = int(n_nodes);
  a.n_hidden = n_hidden;
  a.edge_tile = edge_tile;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; h 64 or 128. wb: the weights [W_e,
// ws[0..nh), W_out] as the products read them (ops/_build.py
// edge_bwd_operands: bf16 [n][h][h], fp32 [n][2][h][h]). dw receives the fp32 weight gradients
// [dW_e, dWs[0..nh), dW_out] ([h, h] each) then [db_out, dscale, dbias,
// dbs[0..nh)] ([h] each). grid: the CTAs of the row and weight-gradient
// kernels and the number of partials; workspace: at least
// chain::rows_bwd_workspace bytes (ops/hopper_fused.py edge_bwd_plan).
// Returns a cudaError_t (0 = success).
extern "C" int aero_fused_edge_bwd(
    const void* e, const void* sg, const void* d_proj, const void* mask,
    const void* receivers, const void* wb, const void* bs, const void* b_out,
    const void* ln_scale, const void* ct_e, const void* ct_agg, void* d_e,
    void* d_sg, void* d_dproj, void* dw, void* workspace, int64_t ws_bytes,
    int64_t n_edges, int64_t n_nodes, int h, int n_hidden, int grid,
    int edge_tile, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto out = static_cast<float*>(dw);
#define AERO_K2_ARGS(T)                                                   \
  rows_args<T>(e, sg, d_proj, mask, receivers, wb, bs, b_out, ln_scale,   \
               ct_e, ct_agg, d_e, d_sg, d_dproj, n_edges, n_nodes,        \
               n_hidden, edge_tile)
  if (dtype == 0 && h == 128)
    return int(chain::launch_rows_bwd<float, 128, false>(
        AERO_K2_ARGS(float), out, workspace, ws_bytes, grid, 0, s));
  if (dtype == 0 && h == 64)
    return int(chain::launch_rows_bwd<float, 64, false>(
        AERO_K2_ARGS(float), out, workspace, ws_bytes, grid, 0, s));
  if (dtype == 1 && h == 128)
    return int(chain::launch_rows_bwd<__nv_bfloat16, 128, false>(
        AERO_K2_ARGS(__nv_bfloat16), out, workspace, ws_bytes, grid, 0, s));
  if (dtype == 1 && h == 64)
    return int(chain::launch_rows_bwd<__nv_bfloat16, 64, false>(
        AERO_K2_ARGS(__nv_bfloat16), out, workspace, ws_bytes, grid, 0, s));
#undef AERO_K2_ARGS
  return int(cudaErrorInvalidValue);
}
