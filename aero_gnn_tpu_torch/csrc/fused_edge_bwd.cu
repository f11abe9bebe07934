// Fused concat-trick edge layer, backward (kernel K2 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_fused.py _fel_bwd -> _fused_bwd
// (pallas_call of _make_bwd_kernel / _make_bwd_kernel_split). The VJP of
// K1 (fused_edge_fwd.cu) for the cotangents (ct_e of e', ct_agg of agg),
// recomputing K1's chain per 128-row chunk; the device code, its rounding
// points and the schedule are in edge_bwd.cuh (K8 is the same code reading
// the saved activations instead).
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 3 x 4 products of 2*E*h^2 = 104 GFLOP per launch; bytes: read e, sg,
// ct_e, d_proj, ct_agg, recv, mask, write d_e, d_sg, d_dproj (~389 MB in
// bf16). bf16: bytes bound it (0.12 ms); fp32: FFMA bounds it (1.55 ms).
// This version uses mma.sync (the weight-gradient products on fragments
// that ldmatrix.trans loads), no wgmma/TMA.

#include "edge_bwd.cuh"

// Bytes of device workspace aero_fused_edge_bwd needs. Returns a
// cudaError_t (0 = success).
extern "C" int aero_fused_edge_bwd_workspace(int64_t n_nodes, int h,
                                             int n_hidden, int node_block,
                                             int dtype, int64_t* ws_bytes) {
  return int(chain::edge_bwd_workspace(n_nodes, h, n_hidden, node_block,
                                       dtype, ws_bytes));
}

// dtype: 0 = float32, 1 = bfloat16. wb: the weights [W_e, ws[0..nh),
// W_out] each twice, [n][2][h][h], laid out as the products read them
// (ops/_build.py mma_b_operands). dw receives the fp32 weight gradients
// [dW_e, dWs[0..nh), dW_out] ([h, h] each) then [db_out, dscale, dbias,
// dbs[0..nh)] ([h] each). Returns a cudaError_t (0 = success).
extern "C" int aero_fused_edge_bwd(
    const void* e, const void* sg, const void* d_proj, const void* mask,
    const void* receivers, const void* wb, const void* bs, const void* b_out,
    const void* ln_scale, const void* ct_e, const void* ct_agg, void* d_e,
    void* d_sg, void* d_dproj, void* dw, void* workspace, int64_t ws_bytes,
    int64_t n_edges, int64_t n_nodes, int h, int n_hidden, int node_block,
    int edge_tile, int dtype, void* stream) {
  const chain::EdgeBwdArgs<void> v{
      e, sg, d_proj, mask, static_cast<const int*>(receivers), wb, bs, b_out,
      ln_scale, ct_e, ct_agg, d_e, d_sg, d_dproj, nullptr, nullptr, nullptr,
      nullptr, n_edges, int(n_edges / edge_tile), int(n_nodes), n_hidden,
      node_block, edge_tile};
  return chain::dispatch_edge_bwd<false>(v, h, dtype, dw, workspace, ws_bytes,
                                         stream);
}
