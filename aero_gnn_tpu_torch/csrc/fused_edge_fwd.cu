// Fused concat-trick edge layer, forward (kernel K1 of the port), and its
// save variant.
//
// Replaces: aero_gnn_tpu/ops/pallas_fused.py fused_edge_layer -> _fused_fwd
// (pallas_call of _make_kernel / _make_kernel_split), with save_acts=True
// (AERO_GNN_SAVE_ACTS, pallas_fused.py:215-268, outputs :427-443) the save
// variant. Computes exactly its reference composition _equiv and returns
// (e', agg); the save variant also writes zs, d, mu and inv for the
// saved-activation backward K8 (fused_edge_bwd_saved.cu). The device code
// is edge_fwd_rows.cuh's.
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 4 products of 2*E*h^2 = 34.6 GFLOP per launch. In bf16 the bytes moved
// (read e, sg, d_proj, recv, mask; write e', agg: ~239 MB; the save variant
// adds zs, d, mu, inv: ~206 MB more) bound it; in fp32 the FFMA rate bounds
// it (no TF32, to keep fp32 results). The schedule before this one (one CTA
// per node block, every activation through shared memory, the fp32
// weights restaged between CTA barriers, agg summed by half the CTA
// between two more) ran at 11.5 % of the bf16 bound and 29 % of the fp32
// one. This one runs each warp's rows without a CTA barrier, keeps the bf16
// chain in registers with the weights resident, streams the fp32 weights
// through a two-slot cp.async ring, and sums agg in a second pass (K5's
// ring over e'), at the cost of reading e' once more.

#include "edge_fwd_rows.cuh"

namespace {

template <typename T, int H>
int dispatch_save(const chain::FwdRowsArgs<T>& a, T* agg, int64_t n_nodes,
                  int grid, int resident, void* workspace, int64_t ws_bytes,
                  cudaStream_t stream) {
  const bool save = a.zs != nullptr;
  if (save && (a.d == nullptr || a.mu == nullptr || a.inv == nullptr))
    return int(cudaErrorInvalidValue);
  return int(save ? chain::launch_fwd_rows<T, H, true>(
                        a, agg, n_nodes, grid, resident, workspace, ws_bytes,
                        stream)
                  : chain::launch_fwd_rows<T, H, false>(
                        a, agg, n_nodes, grid, resident, workspace, ws_bytes,
                        stream));
}

template <typename T>
int dispatch(const void* e, const void* sg, const void* d_proj,
             const void* mask, const void* receivers, const void* w_e,
             const void* ws, const void* bs, const void* w_out,
             const void* b_out, const void* ln_scale, const void* ln_bias,
             void* e_out, void* agg, void* zs, void* d, void* mu, void* inv,
             void* workspace, int64_t ws_bytes, int64_t n_edges,
             int64_t n_nodes, int h, int n_hidden, int grid, int resident,
             int edge_tile, cudaStream_t stream) {
  chain::FwdRowsArgs<T> a{
      static_cast<const T*>(e), static_cast<const T*>(sg),
      static_cast<const T*>(d_proj), static_cast<const T*>(mask),
      static_cast<const int*>(receivers), static_cast<const T*>(w_e),
      static_cast<const T*>(ws), static_cast<const T*>(bs),
      static_cast<const T*>(w_out), static_cast<const T*>(b_out),
      static_cast<const T*>(ln_scale), static_cast<const T*>(ln_bias),
      static_cast<T*>(e_out), static_cast<T*>(zs), static_cast<T*>(d),
      static_cast<float*>(mu), static_cast<float*>(inv), n_edges, n_hidden,
      edge_tile, 0};
  auto out = static_cast<T*>(agg);
  if (h == 128)
    return dispatch_save<T, 128>(a, out, n_nodes, grid, resident, workspace,
                                 ws_bytes, stream);
  if (h == 64)
    return dispatch_save<T, 64>(a, out, n_nodes, grid, resident, workspace,
                                ws_bytes, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; h 64 or 128. The weights as they lie
// ([in][out]; ws [n_hidden][h][h]). zs, d, mu, inv: all null (K1), or the
// save variant's outputs ([n_hidden + 1][E][h] and [E][h] of the dtype,
// [E] fp32 each). grid, resident: the row kernel's CTAs and whether its
// weights stay resident in shared memory; workspace: at least (n_nodes +
// 1) * 4 bytes for the receiver stream's row pointer (ops/hopper_fused.py
// edge_fwd_plan). Returns a cudaError_t (0 = success).
extern "C" int aero_fused_edge_fwd(
    const void* e, const void* sg, const void* d_proj, const void* mask,
    const void* receivers, const void* w_e, const void* ws, const void* bs,
    const void* w_out, const void* b_out, const void* ln_scale,
    const void* ln_bias, void* e_out, void* agg, void* zs, void* d, void* mu,
    void* inv, void* workspace, int64_t ws_bytes, int64_t n_edges,
    int64_t n_nodes, int h, int n_hidden, int grid, int resident,
    int edge_tile, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                           b_out, ln_scale, ln_bias, e_out, agg, zs, d, mu,
                           inv, workspace, ws_bytes, n_edges, n_nodes, h,
                           n_hidden, grid, resident, edge_tile, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(e, sg, d_proj, mask, receivers, w_e, ws,
                                   bs, w_out, b_out, ln_scale, ln_bias, e_out,
                                   agg, zs, d, mu, inv, workspace, ws_bytes,
                                   n_edges, n_nodes, h, n_hidden, grid,
                                   resident, edge_tile, s);
  return int(cudaErrorInvalidValue);
}
