// Fused concat-trick edge layer, backward from saved activations (kernel K8
// of the port; AERO_GNN_SAVE_ACTS).
//
// Replaces: aero_gnn_tpu/ops/pallas_fused.py _fel_bwd -> _fused_bwd_saved
// (pallas_call at :1165 of _make_bwd_kernel_saved, :1031). K2 without the
// recompute: the save variant of K1 wrote the post-ReLU activations zs,
// the rounded pre-LayerNorm output d and its fp32 statistics mu / inv, so
// each chunk starts at the LayerNorm backward. K2's three kernels
// (edge_bwd_rows.cuh, kSaved): the row kernel runs only the nh + 2
// backward products, its ReLU masks read from zs, and writes d_e, d_sg and
// the cotangents; d_dproj is K2's segmented sum; the weight-gradient kernel
// reads zs where K2 reads the activations it wrote. On K2's grid and
// chunk-to-CTA map, all ten outputs are K2's bit for bit. Pad tiles, whose
// saved rows K1 never wrote, are skipped as K1 skips them, so no
// uninitialised row reaches a weight gradient, and fill_pad_rows gives
// their d_e rows ct_e and their d_sg rows 0.
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 2 x 4 products of 2*E*h^2 = 69 GFLOP per launch; bytes: read e, zs
// (3 x [E, h]), d, mu, inv, ct_e, ct_agg, recv, mask, write d_e, d_sg,
// d_dproj (~579 MB in bf16). bf16: bytes bound it (0.17 ms); fp32: FFMA
// bounds it (1.03 ms). Against K2 it reads two more [E, h] streams (zs's
// masks and d), runs 4 of its 8 row-kernel products a chunk and writes no
// activation (~0.2 GB less traffic in bf16 at two hidden layers).

#include "edge_bwd_rows.cuh"

namespace {

template <typename T, int H>
int launch(const void* e, const void* mask, const void* receivers,
           const void* wb, const void* ln_scale, const void* zs,
           const void* d, const void* mu, const void* inv, const void* ct_e,
           const void* ct_agg, void* d_e, void* d_sg, void* d_dproj, void* dw,
           void* workspace, int64_t ws_bytes, int64_t n_edges,
           int64_t n_nodes, int n_hidden, int grid, int resident,
           int edge_tile, cudaStream_t stream) {
  chain::RowsBwdArgs<T> a{};
  a.e = static_cast<const T*>(e);
  a.mask = static_cast<const T*>(mask);
  a.recv = static_cast<const int*>(receivers);
  a.wb = static_cast<const T*>(wb);
  a.ln_scale = static_cast<const T*>(ln_scale);
  a.ct_e = static_cast<const T*>(ct_e);
  a.ct_agg = static_cast<const T*>(ct_agg);
  a.d_e = static_cast<T*>(d_e);
  a.d_sg = static_cast<T*>(d_sg);
  a.d_dproj = static_cast<T*>(d_dproj);
  a.acts = static_cast<T*>(const_cast<void*>(zs));  // read only
  a.d = static_cast<const T*>(d);
  a.mu = static_cast<const float*>(mu);
  a.inv = static_cast<const float*>(inv);
  a.n_edges = n_edges;
  a.n_nodes = int(n_nodes);
  a.n_hidden = n_hidden;
  a.edge_tile = edge_tile;
  return int(chain::launch_rows_bwd<T, H, true>(
      a, static_cast<float*>(dw), workspace, ws_bytes, grid, resident,
      stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; h 64 or 128. wb: the weights [W_e,
// ws[0..nh), W_out] as the backward products read them, W^T of each
// ([n][h][h], ops/_build.py bwd_only_operands); zs [n_hidden + 1][E][h], d
// [E][h] of the dtype and mu, inv [E] fp32 as the save variant of
// aero_fused_edge_fwd wrote them. dw as for aero_fused_edge_bwd. grid (the
// CTAs of the row and weight-gradient kernels), resident (the weights kept
// in shared memory, else streamed) and the workspace of at least
// chain::rows_bwd_workspace bytes (no activations): ops/hopper_fused.py
// edge_bwd_saved_plan. Returns a cudaError_t (0 = success).
extern "C" int aero_fused_edge_bwd_saved(
    const void* e, const void* mask, const void* receivers, const void* wb,
    const void* ln_scale, const void* zs, const void* d, const void* mu,
    const void* inv, const void* ct_e, const void* ct_agg, void* d_e,
    void* d_sg, void* d_dproj, void* dw, void* workspace, int64_t ws_bytes,
    int64_t n_edges, int64_t n_nodes, int h, int n_hidden, int grid,
    int resident, int edge_tile, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define AERO_K8(T, H)                                                      \
  launch<T, H>(e, mask, receivers, wb, ln_scale, zs, d, mu, inv, ct_e,     \
               ct_agg, d_e, d_sg, d_dproj, dw, workspace, ws_bytes,        \
               n_edges, n_nodes, n_hidden, grid, resident, edge_tile, s)
  if (dtype == 0 && h == 128) return AERO_K8(float, 128);
  if (dtype == 0 && h == 64) return AERO_K8(float, 64);
  if (dtype == 1 && h == 128) return AERO_K8(__nv_bfloat16, 128);
  if (dtype == 1 && h == 64) return AERO_K8(__nv_bfloat16, 64);
#undef AERO_K8
  return int(cudaErrorInvalidValue);
}
