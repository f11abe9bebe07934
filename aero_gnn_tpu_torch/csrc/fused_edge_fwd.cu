// Fused concat-trick edge layer, forward (kernel K1 of the port), and its
// save variant.
//
// Replaces: aero_gnn_tpu/ops/pallas_fused.py fused_edge_layer -> _fused_fwd
// (pallas_call of _make_kernel / _make_kernel_split), with save_acts=True
// (AERO_GNN_SAVE_ACTS, pallas_fused.py:215-268, outputs :427-443) the save
// variant. Computes exactly its reference composition _equiv and returns
// (e', agg); the save variant also writes zs, d, mu and inv for the
// saved-activation backward K8 (fused_edge_bwd_saved.cu). The device code
// and the layout contract are in edge_fwd.cuh.
//
// Schedule: one CTA per node block (persistent over blocks), the block's
// rows in chunks of 128, agg by a segmented row sum (no atomics: the same
// inputs give the same bits). Pad tiles are skipped; fill_pad_tiles, a
// second grid-stride kernel, gives their e' rows e (a zero update; pad rows
// of e' are never observed).
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 4 products of 2*E*h^2 = 34.6 GFLOP per launch. In bf16 the bytes moved
// (read e, sg, d_proj, recv, mask; write e', agg: ~239 MB; the save variant
// adds zs, d, mu, inv: ~206 MB more) bound it; in fp32 the FFMA rate bounds
// it (no TF32, to keep fp32 results). This version keeps the weights
// resident in shared memory when they fit (bf16), streams them per stage
// otherwise (fp32), and uses mma.sync, not wgmma/TMA.

#include "edge_fwd.cuh"

namespace {

using namespace chain;

template <typename T, int H, bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
fused_edge_fwd_kernel(EdgeFwdArgs<T> a, int resident) {
  constexpr int LD = Layout<T, H>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int range_s[2];
  const int n_mats = a.n_hidden + 2;
  const WeightSlots<T, H> w{reinterpret_cast<T*>(smem_raw), resident};
  T* act = w.wbuf + size_t(resident ? n_mats : 1) * H * LD;
  int* recv_s = reinterpret_cast<int*>(act + kRows * LD);
  for (int m = 0; m < n_mats; ++m) w.preload(m, a.template weight<H>(m));
  __syncthreads();
  const int n_blocks = a.n_nodes / a.node_block;
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x)
    edge_fwd_block<T, H, kSave>(a, w, act, recv_s, range_s, b);
}

template <typename T, int H, bool kSave>
cudaError_t launch(const EdgeFwdArgs<T>& a, cudaStream_t stream) {
  int resident = 0;
  size_t smem = 0;
  cudaError_t err = plan_smem<T, H>(a.n_hidden + 2, kRows * sizeof(int),
                                    &resident, &smem);
  if (err != cudaSuccess) return err;
  auto kernel = fused_edge_fwd_kernel<T, H, kSave>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const int n_blocks = a.n_nodes / a.node_block;
  const int grid = n_blocks < sm_count() ? n_blocks : sm_count();
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(a, resident);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fill_pad_tiles<T>(a.mask, a.n_tiles, a.edge_tile, H,
                                  a.e_out, a.e, nullptr, nullptr, stream);
}

template <typename T>
int dispatch(const void* e, const void* sg, const void* d_proj,
             const void* mask, const void* receivers, const void* w_e,
             const void* ws, const void* bs, const void* w_out,
             const void* b_out, const void* ln_scale, const void* ln_bias,
             void* e_out, void* agg, void* zs, void* d, void* mu, void* inv,
             int64_t n_edges, int64_t n_nodes, int h, int n_hidden,
             int node_block, int edge_tile, cudaStream_t stream) {
  EdgeFwdArgs<T> a{
      static_cast<const T*>(e), static_cast<const T*>(sg),
      static_cast<const T*>(d_proj), static_cast<const T*>(mask),
      static_cast<const int*>(receivers), static_cast<const T*>(w_e),
      static_cast<const T*>(ws), static_cast<const T*>(bs),
      static_cast<const T*>(w_out), static_cast<const T*>(b_out),
      static_cast<const T*>(ln_scale), static_cast<const T*>(ln_bias),
      static_cast<T*>(e_out), static_cast<T*>(agg), static_cast<T*>(zs),
      static_cast<T*>(d), static_cast<float*>(mu), static_cast<float*>(inv),
      n_edges, int(n_edges / edge_tile), int(n_nodes), n_hidden, node_block,
      edge_tile};
  const bool save = zs != nullptr;
  if (h == 128)
    return int(save ? launch<T, 128, true>(a, stream)
                    : launch<T, 128, false>(a, stream));
  if (h == 64)
    return int(save ? launch<T, 64, true>(a, stream)
                    : launch<T, 64, false>(a, stream));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. zs, d, mu, inv: all null (K1), or the
// save variant's outputs ([n_hidden + 1][E][h] and [E][h] of the dtype,
// [E] fp32 each). Returns a cudaError_t (0 = success).
extern "C" int aero_fused_edge_fwd(
    const void* e, const void* sg, const void* d_proj, const void* mask,
    const void* receivers, const void* w_e, const void* ws, const void* bs,
    const void* w_out, const void* b_out, const void* ln_scale,
    const void* ln_bias, void* e_out, void* agg, void* zs, void* d, void* mu,
    void* inv, int64_t n_edges, int64_t n_nodes, int h, int n_hidden,
    int node_block, int edge_tile, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                           b_out, ln_scale, ln_bias, e_out, agg, zs, d, mu,
                           inv, n_edges, n_nodes, h, n_hidden, node_block,
                           edge_tile, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(e, sg, d_proj, mask, receivers, w_e, ws,
                                   bs, w_out, b_out, ln_scale, ln_bias, e_out,
                                   agg, zs, d, mu, inv, n_edges, n_nodes, h,
                                   n_hidden, node_block, edge_tile, s);
  return int(cudaErrorInvalidValue);
}
