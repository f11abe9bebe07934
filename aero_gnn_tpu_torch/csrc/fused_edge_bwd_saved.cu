// Fused concat-trick edge layer, backward from saved activations (kernel K8
// of the port; AERO_GNN_SAVE_ACTS).
//
// Replaces: aero_gnn_tpu/ops/pallas_fused.py _fel_bwd -> _fused_bwd_saved
// (pallas_call at :1165 of _make_bwd_kernel_saved, :1031). K2 without the
// recompute: the save variant of K1 wrote the post-ReLU activations zs,
// the rounded pre-LayerNorm output d and its fp32 statistics mu / inv, so
// each chunk starts at the LayerNorm backward. The device code, rounding
// points and schedule are K2's (edge_bwd.cuh, kSaved): one CTA per node
// block, d_dproj by a segmented row sum, weight gradients in per-CTA fp32
// partials summed in CTA order (deterministic). Pad tiles, whose saved rows
// K1 never wrote, are skipped exactly as K1 skips them (chain.cuh
// first_pad_tile), so no uninitialised row reaches a weight gradient, and
// fill_pad_tiles gives their d_e rows ct_e and their d_sg rows 0.
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 2 x 4 products of 2*E*h^2 = 69 GFLOP per launch; bytes: read e, zs
// (3 x [E, h]), d, mu, inv, ct_e, ct_agg, recv, mask, write d_e, d_sg,
// d_dproj (~579 MB in bf16). bf16: bytes bound it (0.17 ms); fp32: FFMA
// bounds it (1.03 ms). Against K2 it reads two more [E, h] streams and
// skips 4 of its 8 weight stages and 4 of its 12 products per chunk.

#include "edge_bwd.cuh"

// Bytes of device workspace aero_fused_edge_bwd_saved needs. Returns a
// cudaError_t (0 = success).
extern "C" int aero_fused_edge_bwd_saved_workspace(int64_t n_nodes, int h,
                                                   int n_hidden,
                                                   int node_block, int dtype,
                                                   int64_t* ws_bytes) {
  return int(chain::edge_bwd_workspace(n_nodes, h, n_hidden, node_block,
                                       dtype, ws_bytes));
}

// dtype: 0 = float32, 1 = bfloat16. wb as for aero_fused_edge_bwd (only
// its backward operands are read); zs [n_hidden + 1][E][h], d [E][h] of
// the dtype and mu, inv [E] fp32 as the save variant of aero_fused_edge_fwd
// wrote them. dw as for aero_fused_edge_bwd. Returns a cudaError_t (0 =
// success).
extern "C" int aero_fused_edge_bwd_saved(
    const void* e, const void* mask, const void* receivers, const void* wb,
    const void* ln_scale, const void* zs, const void* d, const void* mu,
    const void* inv, const void* ct_e, const void* ct_agg, void* d_e,
    void* d_sg, void* d_dproj, void* dw, void* workspace, int64_t ws_bytes,
    int64_t n_edges, int64_t n_nodes, int h, int n_hidden, int node_block,
    int edge_tile, int dtype, void* stream) {
  const chain::EdgeBwdArgs<void> v{
      e, nullptr, nullptr, mask, static_cast<const int*>(receivers), wb,
      nullptr, nullptr, ln_scale, ct_e, ct_agg, d_e, d_sg, d_dproj, zs, d,
      static_cast<const float*>(mu), static_cast<const float*>(inv), n_edges,
      int(n_edges / edge_tile), int(n_nodes), n_hidden, node_block,
      edge_tile};
  return chain::dispatch_edge_bwd<true>(v, h, dtype, dw, workspace, ws_bytes,
                                        stream);
}
