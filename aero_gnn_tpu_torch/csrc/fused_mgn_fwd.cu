// Whole MGN processor layer, forward (kernel K9-fwd of the port;
// AERO_GNN_MEGA).
//
// Replaces: aero_gnn_tpu/ops/pallas_mega.py fused_mgn_layer ->
// _fmgn_fwd_impl -> _mega_fwd_call (pallas_call at :221 of the kernel at
// :92). The concat-trick edge update with its receiver gather and 'add'
// aggregation (K1), then on each node block, as soon as its aggregate is
// complete, the node block + residual (K3):
//
//   e', agg = edge layer (e, sg, d_proj, mask, recv)
//   x'      = x + LayerNorm(MLP([x, agg]))   per node block
//
// and returns (e', agg, x'), the bits of K1 followed by K3. The TPU kernel
// runs the node update as an epilogue on each block's last edge tile; here
// one CTA owns a node block (256 nodes; its edge rows are a run of whole
// tiles, graph/padded.py _align_edge_blocks) and, with no CTA barrier
// between products:
//
//  1. runs K1's chunk body (edge_fwd_rows.cuh edge_rows_chunk) over the
//     128-row chunks of the block's live tiles (those whose first row is
//     real; chain.cuh "Pad tiles"), writing e', while the block's first
//     and last live row of each node are noted in shared memory
//     (mega_block.cuh node_bounds);
//  2. after one CTA barrier sums agg for the block's nodes from the e' rows
//     it just wrote (mega_block.cuh block_sum): the fp32 sum of mask * e'
//     over each node's rows in stream order, rounded once, the pad sink 0
//     -- the sum K1's agg pass (K5's ring) takes, so the same bits;
//  3. after another runs K3's chunk body (node_fwd_rows.cuh
//     node_rows_chunk) over the block's rows, reading agg back in the
//     compute type as K3 reads it.
//
// Each warp then copies e' = e for its share of the pad tiles' chunks
// (mega_block.cuh pad_chunks). Every node row of the block gets x', nodes
// without an edge and the pad sink included. The block's tile range is
// counted over all tiles by one warp (mega_block.cuh block_tiles).
//
// Why one CTA a block and not the edge chunks round robin with the node
// update run by the CTA whose chunk completes a block: the flagship's 258
// blocks take two waves on 132 SMs (258 of 264 CTA slots busy), the same
// work per SM within 2.3 %, and a block's sums need no fence, no counter
// and no workspace. A graph whose block count is just past a multiple of
// 132 leaves its last wave part empty (the Loader graph's 306 blocks: 3
// waves, the last 42 CTAs).
//
// Shared memory (ops/hopper_mega.py mega_fwd_plan, checked here): the
// weights resident where max(edge, node) of them fit (the edge chain's
// for the edge chunks, then the node chain's in the same slots, copied
// during the block's sums: bf16 at h = 128 and 2 hidden, 5 x 34.8 KB), else
// both chains streamed through a two-slot ring (one CTA barrier a
// product); fp32's warps' A operand slices; each node's live-row bounds.
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 4 products of 2*E*h^2 plus 5 of 2*N*h^2 = 45.4 GFLOP per launch; bytes:
// K1's and K3's inputs and outputs without the agg re-read (~273 MB in
// bf16: 0.08 ms); fp32: FFMA bounds it (0.68 ms). mma.sync, no wgmma/TMA.

#include "edge_fwd_rows.cuh"
#include "mega_block.cuh"
#include "node_fwd_rows.cuh"

namespace {

using namespace chain;

template <typename T>
struct MegaArgs {
  FwdRowsArgs<T> e;  // the edge half (K1's, without the save outputs)
  NodeFwdArgs<T> n;  // the node half: its agg is `agg`, written here
  T* agg;
  int n_nodes, node_block, n_tiles, resident;
};

// Shared bytes besides the weights: fp32's A operand slices, then each
// node's live-row bounds ([2][node_block] ints) and the block's tile range.
template <typename T, int H>
__host__ __device__ constexpr size_t mega_fixed_smem(int node_block) {
  return (sizeof(T) == 4 ? Layout<T, H>::kActBytes : 0) +
         (2 * size_t(node_block) + 4) * sizeof(int);
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
fused_mgn_fwd_kernel(MegaArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = Layout<T, H>::kLd;
  constexpr size_t kMat = WeightStream<T, H>::kMat;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x, ET = a.e.edge_tile;
  const int ne = a.e.n_hidden + 2, nn = a.n.n_hidden + 3;
  const FwdChain<T, H> ec = edge_chain<T, H>(a.e);
  const FwdChain<T, H> nc = node_chain<T, H>(a.n);
  T* w = reinterpret_cast<T*>(smem_raw);  // resident tiles, or the ring
  WeightStream<T, H> ring{w, 0};
  T* stg_all = w + (a.resident ? max(ne, nn) : 2) * kMat;
  T* stg = stg_all + size_t(warp) * 16 * LD;
  int* s_lo = reinterpret_cast<int*>(stg_all +
                                     (sizeof(T) == 4 ? kRows * LD : 0));
  int* s_hi = s_lo + a.node_block;
  int* range_s = s_hi + a.node_block;
  const int node_lo = b * a.node_block;

  if (a.resident) {
    for (int m = 0; m < ne; ++m)
      copy_mat_async<T, H>(w + m * kMat, ec.src(m));
    cp_async_commit();
  }
  block_tiles(a.e.recv, a.e.mask, a.n_tiles, ET, a.node_block, b, s_lo, s_hi,
              range_s);
  const int64_t row_lo = int64_t(range_s[0]) * ET;
  const int64_t row_hi = int64_t(range_s[1]) * ET;
  const int n_ec = int((row_hi - row_lo) / kRows);
  if (!a.resident) ring.prime(n_ec > 0 ? ec.src(0) : nc.src(0));
  node_bounds(a.e.recv, a.e.mask, row_lo, row_hi, node_lo, a.node_block,
              s_lo, s_hi);
  if (a.resident) {
    cp_async_wait<0>();
    __syncthreads();  // the edge weights are visible
  }

  for (int c = 0; c < n_ec; ++c) {
    const bool last = c + 1 == n_ec;
    edge_rows_chunk<T, H, false>(
        a.e,
        [&](int m) -> const T* {
          if (a.resident) return w + m * kMat;
          return ring.next(m + 1 < ne ? ec.src(m + 1)
                                      : last ? nc.src(0) : ec.src(0));
        },
        stg, row_lo + int64_t(c) * kRows);
  }
  __syncthreads();  // the block's e' rows and live-row bounds; the edge
                    // weights are free
  if (a.resident) {  // the node weights, in flight during the sums
    for (int m = 0; m < nn; ++m)
      copy_mat_async<T, H>(w + m * kMat, nc.src(m));
    cp_async_commit();
  }
  block_sum<T, H>(a.e.e_out, a.e.mask, a.n_nodes, a.node_block, node_lo,
                  s_lo, s_hi, a.agg);
  if (a.resident) cp_async_wait<0>();
  __syncthreads();  // the block's agg rows; the node weights
  const int nk = a.node_block / kRows;
  for (int k = 0; k < nk; ++k) {
    node_rows_chunk<T, H>(
        a.n,
        [&](int m) -> const T* {
          if (a.resident) return w + m * kMat;
          return ring.next(m + 1 < nn     ? nc.src(m + 1)
                           : k + 1 < nk ? nc.src(0)
                                        : nullptr);
        },
        stg, int64_t(node_lo) + int64_t(k) * kRows);
  }
  ring.finish();

  // this warp's share of the pad tiles' chunks: e' = e, a zero update
  pad_chunks<T, H>(a.e.mask, int(a.e.n_edges / kRows), ET, a.e.e,
                   a.e.e_out, nullptr);
}

// The launch on `stream`. The residency flag is the plan's, checked
// against this side's reckoning.
template <typename T, int H>
cudaError_t launch(MegaArgs<T> a, cudaStream_t stream) {
  const int64_t E = a.e.n_edges;
  if (a.e.n_hidden < 0 || a.n.n_hidden < 0 || a.node_block <= 0 ||
      a.node_block % kRows || a.n_nodes <= 0 || a.n_nodes % a.node_block ||
      a.e.edge_tile <= 0 || a.e.edge_tile % kRows || E <= 0 ||
      E % a.e.edge_tile || E > 0x7fffffff || a.n.n_rows != a.n_nodes)
    return cudaErrorInvalidValue;
  a.n_tiles = int(E / a.e.edge_tile);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int ne = a.e.n_hidden + 2, nn = a.n.n_hidden + 3;
  const size_t mat = Layout<T, H>::kMatBytes;
  const size_t fixed = mega_fixed_smem<T, H>(a.node_block);
  const int fits = (ne > nn ? ne : nn) * mat + fixed <= size_t(max_smem);
  if (fits != a.resident) return cudaErrorInvalidValue;
  const size_t smem = (fits ? (ne > nn ? ne : nn) : 2) * mat + fixed;
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  auto kernel = fused_mgn_fwd_kernel<T, H>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<a.n_nodes / a.node_block, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(void* const* p, int64_t n_edges, int64_t n_nodes, int h,
             int ne_hidden, int nn_hidden, int node_block, int edge_tile,
             int resident, cudaStream_t stream) {
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  // p: 0 e, 1 sg, 2 d_proj, 3 x, 4 mask, 5 recv | 6-12 edge weights |
  // 13-21 node weights | 22 e', 23 agg (the node chain's input), 24 x'
  MegaArgs<T> a{};
  a.e = FwdRowsArgs<T>{in(0),   in(1),   in(2),   in(4),
                       static_cast<const int*>(p[5]),
                       in(6),   in(7),   in(8),   in(9),   in(10),  in(11),
                       in(12),  out(22), nullptr, nullptr, nullptr, nullptr,
                       n_edges, ne_hidden, edge_tile, 0};
  a.n = NodeFwdArgs<T>{in(3),  out(23), in(13), in(14), in(15), in(16),
                       in(17), in(18),  in(19), in(20), in(21), out(24),
                       n_nodes, nn_hidden, 0};
  a.agg = out(23);
  a.n_nodes = int(n_nodes);
  a.node_block = node_block;
  a.resident = resident;
  if (h == 128) return int(launch<T, 128>(a, stream));
  if (h == 64) return int(launch<T, 64>(a, stream));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; h 64 or 128. The tensors in order: e,
// sg, d_proj, x, mask, receivers; the edge weights w_e, ws, bs, w_out,
// b_out, ln_scale, ln_bias; the node weights w1x, w1a, b1, ws, bs, w_out,
// b_out, ln_scale, ln_bias (all as they lie, [in][out]); the outputs e',
// agg, x'. resident (the weights kept in shared memory, else streamed):
// ops/hopper_mega.py mega_fwd_plan.
// Returns a cudaError_t (0 = success).
extern "C" int aero_fused_mgn_fwd(
    const void* e, const void* sg, const void* d_proj, const void* x,
    const void* mask, const void* receivers, const void* w_e,
    const void* e_ws, const void* e_bs, const void* e_w_out,
    const void* e_b_out, const void* e_ln_scale, const void* e_ln_bias,
    const void* w1x, const void* w1a, const void* b1, const void* n_ws,
    const void* n_bs, const void* n_w_out, const void* n_b_out,
    const void* n_ln_scale, const void* n_ln_bias, void* e_out, void* agg,
    void* x_out, int64_t n_edges, int64_t n_nodes, int h, int ne_hidden,
    int nn_hidden, int node_block, int edge_tile, int resident, int dtype,
    void* stream) {
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
                           node_block, edge_tile, resident, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(p, n_edges, n_nodes, h, ne_hidden,
                                   nn_hidden, node_block, edge_tile, resident,
                                   s);
  return int(cudaErrorInvalidValue);
}
