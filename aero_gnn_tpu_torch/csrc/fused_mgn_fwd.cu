// Whole MGN processor layer, forward (kernel K9-fwd of the port;
// AERO_GNN_MEGA).
//
// Replaces: aero_gnn_tpu/ops/pallas_mega.py fused_mgn_layer ->
// _fmgn_fwd_impl -> _mega_fwd_call (pallas_call at :221 of the kernel at
// :92). The concat-trick edge update with its receiver gather and 'add'
// aggregation (K1, edge_fwd.cuh), then on each node block, as soon as its
// aggregate is complete, the node block + residual (K3, node_fwd.cuh):
//
//   e', agg = edge layer (e, sg, d_proj, mask, recv)
//   x'      = x + LayerNorm(MLP([x, agg]))   per node block
//
// and returns (e', agg, x'). The TPU kernel runs the node update as an
// epilogue on each block's last edge tile; here one CTA owns a node block
// (as in K1), walks its edge tiles, writes its agg rows, and after a CTA
// barrier runs the node chain on the block's 256 rows (two chunks of 128),
// reading the agg rows it just wrote back from L2 in the compute type, as
// K3 reads them: the results are those of K1 followed by K3. Every node
// row of the block gets x', nodes without an edge and the pad sink
// included. Pad tiles are skipped and filled as in K1.
//
// Shared memory: the activation buffer, and the edge weights resident with
// the node weights streamed per stage when not all nine matrices fit (bf16
// at h = 128: 4 + 1 slots, 209 KB), or both streamed through one slot
// (fp32).
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 4 products of 2*E*h^2 plus 5 of 2*N*h^2 = 45.4 GFLOP per launch; bytes:
// K1's and K3's inputs and outputs without the agg re-read (~273 MB in
// bf16: 0.08 ms); fp32: FFMA bounds it (0.68 ms). mma.sync, no wgmma/TMA.

#include "edge_fwd.cuh"
#include "node_fwd.cuh"

namespace {

using namespace chain;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
fused_mgn_fwd_kernel(EdgeFwdArgs<T> ea, NodeFwdArgs<T> na, int edge_resident,
                     int node_resident) {
  constexpr int LD = Layout<T, H>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int range_s[2];
  const int ne = ea.n_hidden + 2, nn = na.n_hidden + 3;
  T* wbuf = reinterpret_cast<T*>(smem_raw);
  // edge streamed: one slot for both chains; else the node slots follow
  const WeightSlots<T, H> we{wbuf, edge_resident};
  const WeightSlots<T, H> wn{wbuf + size_t(edge_resident ? ne : 0) * H * LD,
                             node_resident};
  const int slots = edge_resident ? ne + (node_resident ? nn : 1) : 1;
  T* act = wbuf + size_t(slots) * H * LD;
  int* recv_s = reinterpret_cast<int*>(act + kRows * LD);
  for (int m = 0; m < ne; ++m) we.preload(m, ea.template weight<H>(m));
  for (int m = 0; m < nn; ++m) wn.preload(m, na.template weight<H>(m));
  __syncthreads();
  const int n_blocks = ea.n_nodes / ea.node_block;
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    edge_fwd_block<T, H>(ea, we, act, recv_s, range_s, b);
    const int64_t node_lo = int64_t(b) * ea.node_block;
    for (int64_t r0 = node_lo; r0 < node_lo + ea.node_block; r0 += kRows)
      node_fwd_chunk<T, H>(na, wn, act, r0);
  }
}

// Which weights stay resident: all, the edge chain's (node streamed), or
// none (one slot for both).
template <typename T, int H>
cudaError_t plan(int ne, int nn, int* edge_resident, int* node_resident,
                 size_t* bytes) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t budget = size_t(max_smem) - 256;  // room for static smem
  const size_t base = Layout<T, H>::kActBytes + kRows * sizeof(int);
  const size_t mat = Layout<T, H>::kMatBytes;
  *edge_resident = base + (ne + 1) * mat <= budget;
  *node_resident = base + (ne + nn) * mat <= budget;
  const int slots = *edge_resident ? ne + (*node_resident ? nn : 1) : 1;
  *bytes = base + slots * mat;
  return *bytes <= budget ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int H>
cudaError_t launch(const EdgeFwdArgs<T>& ea, const NodeFwdArgs<T>& na,
                   cudaStream_t stream) {
  if (ea.node_block % kRows) return cudaErrorInvalidValue;
  int edge_resident = 0, node_resident = 0;
  size_t smem = 0;
  cudaError_t err = plan<T, H>(ea.n_hidden + 2, na.n_hidden + 3,
                               &edge_resident, &node_resident, &smem);
  if (err != cudaSuccess) return err;
  auto kernel = fused_mgn_fwd_kernel<T, H>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const int n_blocks = ea.n_nodes / ea.node_block;
  const int grid = n_blocks < sm_count() ? n_blocks : sm_count();
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(ea, na, edge_resident,
                                           node_resident);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fill_pad_tiles<T>(ea.mask, ea.n_tiles, ea.edge_tile, H,
                                  ea.e_out, ea.e, nullptr, nullptr, stream);
}

template <typename T>
int dispatch(void* const* p, int64_t n_edges, int64_t n_nodes, int h,
             int ne_hidden, int nn_hidden, int node_block, int edge_tile,
             cudaStream_t stream) {
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  // p: 0 e, 1 sg, 2 d_proj, 3 x, 4 mask, 5 recv | 6-12 edge weights |
  // 13-21 node weights | 22 e', 23 agg (the node chain's input), 24 x'
  const EdgeFwdArgs<T> ea{
      in(0), in(1), in(2), in(4), static_cast<const int*>(p[5]), in(6),
      in(7), in(8), in(9), in(10), in(11), in(12), out(22), out(23),
      int(n_edges / edge_tile), int(n_nodes), ne_hidden, node_block,
      edge_tile};
  const NodeFwdArgs<T> na{in(3),  out(23), in(13), in(14), in(15), in(16),
                          in(17), in(18),  in(19), in(20), in(21), out(24),
                          nn_hidden};
  if (h == 128) return int(launch<T, 128>(ea, na, stream));
  if (h == 64) return int(launch<T, 64>(ea, na, stream));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The tensors in order: e, sg, d_proj,
// x, mask, receivers; the edge weights w_e, ws, bs, w_out, b_out,
// ln_scale, ln_bias; the node weights w1x, w1a, b1, ws, bs, w_out, b_out,
// ln_scale, ln_bias; the outputs e', agg, x'. Returns a cudaError_t (0 =
// success).
extern "C" int aero_fused_mgn_fwd(
    const void* e, const void* sg, const void* d_proj, const void* x,
    const void* mask, const void* receivers, const void* w_e,
    const void* e_ws, const void* e_bs, const void* e_w_out,
    const void* e_b_out, const void* e_ln_scale, const void* e_ln_bias,
    const void* w1x, const void* w1a, const void* b1, const void* n_ws,
    const void* n_bs, const void* n_w_out, const void* n_b_out,
    const void* n_ln_scale, const void* n_ln_bias, void* e_out, void* agg,
    void* x_out, int64_t n_edges, int64_t n_nodes, int h, int ne_hidden,
    int nn_hidden, int node_block, int edge_tile, int dtype, void* stream) {
  void* const p[] = {
      const_cast<void*>(e),          const_cast<void*>(sg),
      const_cast<void*>(d_proj),     const_cast<void*>(x),
      const_cast<void*>(mask),       const_cast<void*>(receivers),
      const_cast<void*>(w_e),        const_cast<void*>(e_ws),
      const_cast<void*>(e_bs),       const_cast<void*>(e_w_out),
      const_cast<void*>(e_b_out),    const_cast<void*>(e_ln_scale),
      const_cast<void*>(e_ln_bias),  const_cast<void*>(w1x),
      const_cast<void*>(w1a),        const_cast<void*>(b1),
      const_cast<void*>(n_ws),       const_cast<void*>(n_bs),
      const_cast<void*>(n_w_out),    const_cast<void*>(n_b_out),
      const_cast<void*>(n_ln_scale), const_cast<void*>(n_ln_bias),
      e_out,                         agg,
      x_out};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(p, n_edges, n_nodes, h, ne_hidden, nn_hidden,
                           node_block, edge_tile, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(p, n_edges, n_nodes, h, ne_hidden,
                                   nn_hidden, node_block, edge_tile, s);
  return int(cudaErrorInvalidValue);
}
