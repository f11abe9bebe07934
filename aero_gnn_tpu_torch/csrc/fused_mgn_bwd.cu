// Whole MGN processor layer, backward (kernel K9-bwd of the port;
// AERO_GNN_MEGA).
//
// Replaces: aero_gnn_tpu/ops/pallas_mega.py _fmgn_bwd -> _mega_bwd_call
// (pallas_call at :380 of the kernel at :240). The VJP of K9-fwd
// (fused_mgn_fwd.cu) for the cotangents ct_x of x' and ct_e of e', from the
// forward's inputs and its saved aggregate agg. Per node block, one CTA:
//
//   1. the node backward over the block's 256 rows (K4, node_bwd.cuh):
//      d_x, the node weight gradients and d_agg = dz @ W1a^T, the
//      aggregation's cotangent;
//   2. the edge backward over the block's tiles (K2, edge_bwd.cuh) with
//      ct_agg = that d_agg: d_e, d_sg, d_dproj and the edge weight
//      gradients.
//
// The TPU kernel keeps d_agg in VMEM scratch between the two; here it goes
// through a global [N, h] scratch that the same CTA writes in step 1 and
// reads in step 2, after a CTA barrier (the rows stay in L2). Every
// rounding point is K4's and K2's, so the results are those of K4 followed
// by K2. Pad tiles are skipped and filled as in K2. The 16 weight
// gradients go to per-CTA fp32 partials (edge matrices, node matrices, edge
// vectors, node vectors) summed in CTA order by a second kernel: the same
// bits on every launch.
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 12 products of 2*E*h^2 plus 15 of 2*N*h^2 = 136 GFLOP per launch; bytes:
// K2's and K4's inputs and outputs without the d_agg round trip (~441 MB
// in bf16: 0.13 ms); fp32: FFMA bounds it (2.0 ms). mma.sync, no
// wgmma/TMA.

#include "edge_bwd.cuh"
#include "node_bwd.cuh"

namespace {

using namespace chain;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
fused_mgn_bwd_kernel(EdgeBwdArgs<T> ea, NodeBwdArgs<T> na,
                     float* __restrict__ part_all, T* scratch, int n_bufs,
                     int n_smem, int64_t part_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int range_s[2];
  const int e_mats = ea.n_hidden + 2, n_mats = na.n_hidden + 3;
  const int e_vecs = ea.n_hidden + 3, n_vecs = na.n_hidden + 4;
  const BwdCta<T, H> c(smem_raw, scratch, n_bufs, n_smem);
  float* part = part_all + int64_t(blockIdx.x) * part_len;
  float* node_mats = part + int64_t(e_mats) * H * H;
  float* node_vecs = c.vec_s + e_vecs * H;
  zero_grads<H>(part, e_mats + n_mats, c.vec_s, e_vecs + n_vecs);
  __syncthreads();
  const int n_blocks = ea.n_nodes / ea.node_block;
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const int64_t node_lo = int64_t(b) * ea.node_block;
    for (int64_t r0 = node_lo; r0 < node_lo + ea.node_block; r0 += kRows)
      node_bwd_chunk<T, H>(na, c, node_mats, node_vecs, r0);
    edge_bwd_block<T, H, false>(ea, c, part, c.vec_s, range_s, b);
  }
  float* vec_part = part + int64_t(e_mats + n_mats) * H * H;
  for (int i = threadIdx.x; i < (e_vecs + n_vecs) * H; i += kThreads)
    vec_part[i] = c.vec_s[i];
}

template <typename T, int H>
cudaError_t plan(int64_t n_nodes, int ne_hidden, int nn_hidden,
                 int node_block, int* n_bufs, BwdPlan* p) {
  *n_bufs = ne_hidden + 3 > nn_hidden + 4 ? ne_hidden + 3 : nn_hidden + 4;
  return plan_bwd<T, H>(*n_bufs, ne_hidden + 2 + nn_hidden + 3,
                        ne_hidden + 3 + nn_hidden + 4, n_nodes / node_block,
                        p);
}

template <typename T, int H>
cudaError_t launch(const EdgeBwdArgs<T>& ea, const NodeBwdArgs<T>& na,
                   float* dw, void* workspace, int64_t ws_bytes,
                   cudaStream_t stream) {
  if (ea.node_block % kRows) return cudaErrorInvalidValue;
  BwdPlan p;
  int n_bufs = 0;
  cudaError_t err = plan<T, H>(ea.n_nodes, ea.n_hidden, na.n_hidden,
                               ea.node_block, &n_bufs, &p);
  if (err != cudaSuccess) return err;
  if (ws_bytes < p.ws_bytes || p.grid == 0) return cudaErrorInvalidValue;
  auto kernel = fused_mgn_bwd_kernel<T, H>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(p.smem));
  if (err != cudaSuccess) return err;
  float* part = static_cast<float*>(workspace);
  T* scratch = reinterpret_cast<T*>(static_cast<char*>(workspace) +
                                    int64_t(p.grid) * p.part_len * 4);
  kernel<<<p.grid, kThreads, p.smem, stream>>>(ea, na, part, scratch, n_bufs,
                                                p.n_smem, p.part_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_fill_pad_tiles<T>(ea.mask, ea.n_tiles, ea.edge_tile, H,
                                 ea.d_e, ea.ct_e, ea.d_sg, nullptr, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, p.grid, p.part_len, dw, stream);
}

template <typename T>
int dispatch(void* const* p, void* dw, void* workspace, int64_t ws_bytes,
             int64_t n_edges, int64_t n_nodes, int h, int ne_hidden,
             int nn_hidden, int node_block, int edge_tile,
             cudaStream_t stream) {
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  // p: 0 e, 1 sg, 2 d_proj, 3 x, 4 agg, 5 mask, 6 recv | 7 wb_e, 8 bs_e,
  // 9 b_out_e, 10 ln_scale_e | 11 wb_n, 12 b1, 13 bs_n, 14 b_out_n,
  // 15 ln_scale_n | 16 ct_e, 17 ct_x | 18 d_e, 19 d_sg, 20 d_dproj, 21 d_x,
  // 22 d_agg (the edge backward's ct_agg)
  const EdgeBwdArgs<T> ea{
      in(0), in(1), in(2), in(5), static_cast<const int*>(p[6]), in(7),
      in(8), in(9), in(10), in(16), in(22), out(18), out(19), out(20),
      nullptr, nullptr, nullptr, nullptr, n_edges, int(n_edges / edge_tile),
      int(n_nodes), ne_hidden, node_block, edge_tile};
  const NodeBwdArgs<T> na{in(3),  in(4),  in(11), in(12),  in(13), in(14),
                          in(15), in(17), out(21), out(22), nn_hidden};
  auto f = static_cast<float*>(dw);
  if (h == 128)
    return int(launch<T, 128>(ea, na, f, workspace, ws_bytes, stream));
  if (h == 64)
    return int(launch<T, 64>(ea, na, f, workspace, ws_bytes, stream));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Bytes of device workspace aero_fused_mgn_bwd needs. Returns a
// cudaError_t (0 = success).
extern "C" int aero_fused_mgn_bwd_workspace(int64_t n_nodes, int h,
                                            int ne_hidden, int nn_hidden,
                                            int node_block, int dtype,
                                            int64_t* ws_bytes) {
  BwdPlan p;
  int n_bufs = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && h == 128)
    err = plan<float, 128>(n_nodes, ne_hidden, nn_hidden, node_block,
                           &n_bufs, &p);
  if (dtype == 0 && h == 64)
    err = plan<float, 64>(n_nodes, ne_hidden, nn_hidden, node_block, &n_bufs,
                          &p);
  if (dtype == 1 && h == 128)
    err = plan<__nv_bfloat16, 128>(n_nodes, ne_hidden, nn_hidden, node_block,
                                   &n_bufs, &p);
  if (dtype == 1 && h == 64)
    err = plan<__nv_bfloat16, 64>(n_nodes, ne_hidden, nn_hidden, node_block,
                                  &n_bufs, &p);
  *ws_bytes = p.ws_bytes;
  return int(err);
}

// dtype: 0 = float32, 1 = bfloat16. The tensors in order: e, sg, d_proj,
// x, agg (the forward's), mask, receivers; the edge weights as
// aero_fused_edge_bwd takes them (wb_e [W_e, ws, W_out] each twice, bs,
// b_out, ln_scale) and the node weights as aero_fused_node_bwd (wb_n
// [W1x, W1a, ws, W_out] each twice, b1, bs, b_out, ln_scale); the
// cotangents ct_e, ct_x; the outputs d_e, d_sg, d_dproj, d_x and d_agg
// (scratch [N, h] of the dtype). dw receives the fp32 weight gradients:
// edge [dW_e, dWs, dW_out], node [dW1x, dW1a, dWs, dW_out] ([h, h] each),
// then edge [db_out, dscale, dbias, dbs], node [db_out, dscale, dbias, db1,
// dbs] ([h] each). Returns a cudaError_t (0 = success).
extern "C" int aero_fused_mgn_bwd(
    const void* e, const void* sg, const void* d_proj, const void* x,
    const void* agg, const void* mask, const void* receivers,
    const void* wb_e, const void* e_bs, const void* e_b_out,
    const void* e_ln_scale, const void* wb_n, const void* b1,
    const void* n_bs, const void* n_b_out, const void* n_ln_scale,
    const void* ct_e, const void* ct_x, void* d_e, void* d_sg, void* d_dproj,
    void* d_x, void* d_agg, void* dw, void* workspace, int64_t ws_bytes,
    int64_t n_edges, int64_t n_nodes, int h, int ne_hidden, int nn_hidden,
    int node_block, int edge_tile, int dtype, void* stream) {
  void* const p[] = {
      const_cast<void*>(e),          const_cast<void*>(sg),
      const_cast<void*>(d_proj),     const_cast<void*>(x),
      const_cast<void*>(agg),        const_cast<void*>(mask),
      const_cast<void*>(receivers),  const_cast<void*>(wb_e),
      const_cast<void*>(e_bs),       const_cast<void*>(e_b_out),
      const_cast<void*>(e_ln_scale), const_cast<void*>(wb_n),
      const_cast<void*>(b1),         const_cast<void*>(n_bs),
      const_cast<void*>(n_b_out),    const_cast<void*>(n_ln_scale),
      const_cast<void*>(ct_e),       const_cast<void*>(ct_x),
      d_e,                           d_sg,
      d_dproj,                       d_x,
      d_agg};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(p, dw, workspace, ws_bytes, n_edges, n_nodes, h,
                           ne_hidden, nn_hidden, node_block, edge_tile, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(p, dw, workspace, ws_bytes, n_edges,
                                   n_nodes, h, ne_hidden, nn_hidden,
                                   node_block, edge_tile, s);
  return int(cudaErrorInvalidValue);
}
