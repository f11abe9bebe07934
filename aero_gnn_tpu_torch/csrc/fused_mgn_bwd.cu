// Whole MGN processor layer, backward (kernel K9-bwd of the port;
// AERO_GNN_MEGA).
//
// Replaces: aero_gnn_tpu/ops/pallas_mega.py _fmgn_bwd -> _mega_bwd_call
// (pallas_call at :380 of the kernel at :240). The VJP of K9-fwd
// (fused_mgn_fwd.cu) for the cotangents ct_x of x' and ct_e of e', from the
// forward's inputs and its saved aggregate agg: K4's backward (the node
// block) and then K2's (the edge layer) with the aggregation's cotangent
// ct_agg = K4's d_agg, the bits of K4 followed by K2. The TPU kernel keeps
// d_agg in VMEM between the two; here one CTA owns a node block (256
// nodes; its edge rows are a run of whole tiles, mega_block.cuh) and, with
// no CTA barrier between products:
//
//  1. runs K4's chunk body (node_bwd_rows.cuh node_bwd_chunk) over the
//     block's two 128-row node chunks: d_x, d_agg (a [N, h] scratch) and
//     K4's workspace rows a(0..nh), dz(0..nh), d_d;
//  2. after one CTA barrier runs K2's chunk body (edge_bwd_rows.cuh
//     edge_bwd_chunk) over the chunks of the block's live tiles, reading
//     ct_agg = d_agg[recv] back in the compute type as K2 reads it (rows
//     the same CTA just wrote, still in L2): d_e, d_sg and K2's workspace
//     rows a(0..nh), dz(1..nh), d_d;
//  3. after another sums the block's d_dproj from the d_sg rows it just
//     wrote (mega_block.cuh block_sum: 4 lanes a node, the fp32 sum of
//     mask * d_sg in stream order, rows of mask 0 passed over, rounded
//     once, the pad sink 0) -- K2's segmented sum, so the same bits.
//
// While the node weights are copied in, one warp counts the block's live
// tiles and the block notes each node's first and last live row
// (mega_block.cuh block_tiles, node_bounds); between 1 and 2, while the
// edge weights are, each warp fills its share of the pad tiles' chunks
// (d_e = ct_e, d_sg = 0; pad_chunks), so the Loader's pad-sink tail needs
// no launch of its own.
//
// Weight gradients: one launch (mega_dw_kernel) runs K2's and K4's
// split-K pairs (edge_dw_pair, node_dw_pair) over those workspaces with
// the grids K2's and K4's own plans choose for the same E and N, and
// rebuilds each split's LayerNorm column sums (dscale, dbias of both
// chains) from the per-chunk sums the row chunks leave in the workspace in
// the row kernels' order (rows_bwd.cuh ln_split); then one
// reduce_partials per chain. So every weight gradient is K4 -> K2's bit for
// bit too.
//
// Why one CTA a node block and not K4's and K2's row kernels over the
// whole graph launched in turn: the block keeps d_agg's round trip in L2
// and needs no fill, offsets or segmented-sum launch; the row kernels have
// no block imbalance, and the block's granularity leaves a part-empty last
// wave where the block count is just past a multiple of 132 (the Loader
// graph's 306 blocks: 3 waves, the last 42 CTAs), as in K9-fwd.
//
// Shared memory (ops/hopper_mega.py mega_bwd_plan, checked here): the
// weights resident where max(edge, node) of them fit (K4's for the node
// chunks, then K2's copied into the same slots during the pad fill: bf16 at
// h = 128 and 2 hidden, 5 x 34.8 KB), else both chains streamed through a
// two-slot ring (one CTA barrier a product); fp32's warps' A operand
// slices; a chunk's LayerNorm column sums; each node's live-row bounds.
// bf16 reads one copy of each weight (the forward product with ldmatrix,
// the backward one with ldmatrix.trans), fp32 W and W^T
// (ops/_build.py edge_bwd_operands), as K2 and K4.
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 12 products of 2*E*h^2 plus 15 of 2*N*h^2 = 136 GFLOP per launch; bytes:
// K2's and K4's inputs and outputs without the d_agg round trip (~441 MB
// in bf16: 0.13 ms); fp32: FFMA bounds it (2.0 ms). mma.sync, no
// wgmma/TMA.

#include "edge_bwd_rows.cuh"
#include "mega_block.cuh"
#include "node_bwd_rows.cuh"

namespace {

using namespace chain;

template <typename T>
struct MegaBwdArgs {
  RowsBwdArgs<T> e;   // K2's half: its ct_agg is d_agg, written here
  NodeRowsArgs<T> n;  // K4's half
  // each chunk's per-warp LayerNorm column sums, [chunks][2][kWarps][H]
  float *e_sums, *n_sums;
  int e_grid, n_grid;  // K2's and K4's weight-gradient splits
  int n_nodes, node_block, n_tiles, resident;
};

// Shared bytes besides the weights: fp32's A operand slices, a chunk's
// LayerNorm column sums ([2][kWarps][H] fp32), each node's live-row bounds
// ([2][node_block] ints) and the block's tile range.
template <typename T, int H>
__host__ __device__ constexpr size_t mega_bwd_fixed_smem(int node_block) {
  return (sizeof(T) == 4 ? Layout<T, H>::kActBytes : 0) +
         2 * size_t(kWarps) * H * sizeof(float) +
         (2 * size_t(node_block) + 4) * sizeof(int);
}

// kDeep: the edge chain is deeper than the ReLU masks kept in registers
// (edge_bwd_chunk).
template <typename T, int H, bool kDeep>
__global__ void __launch_bounds__(kThreads, 1)
fused_mgn_bwd_kernel(MegaBwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = Layout<T, H>::kLd;
  constexpr size_t kMat = WeightStream<T, H>::kMat;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x, ET = a.e.edge_tile;
  const int ne = a.e.n_hidden + 2, nn = a.n.n_hidden + 3;
  const int ne_st = ne * kCopies<T>, nn_st = nn * kCopies<T>;
  T* w = reinterpret_cast<T*>(smem_raw);  // resident tiles, or the ring
  WeightStream<T, H> ring{w, 0};
  T* stg_all = w + (a.resident ? max(ne_st, nn_st) : 2) * kMat;
  T* stg = stg_all + size_t(warp) * 16 * LD;
  float* warp_part = reinterpret_cast<float*>(
      stg_all + (sizeof(T) == 4 ? kRows * LD : 0));
  int* s_lo = reinterpret_cast<int*>(warp_part + 2 * kWarps * H);
  int* s_hi = s_lo + a.node_block;
  int* range_s = s_hi + a.node_block;
  const int node_lo = b * a.node_block;
  // the stored matrix product p of each chain reads (rows_bwd.cuh mat_of)
  auto nsrc = [&](int p) {
    return a.n.wb + size_t(mat_of<T>(p, nn)) * H * H;
  };
  auto esrc = [&](int p) {
    return a.e.wb + size_t(mat_of<T>(p, ne)) * H * H;
  };

  if (a.resident) {
    for (int m = 0; m < nn_st; ++m)
      copy_mat_async<T, H>(w + m * kMat, a.n.wb + size_t(m) * H * H);
    cp_async_commit();
  } else {
    ring.prime(nsrc(0));
  }
  // while the node weights are copied in: the block's live tiles and each
  // node's live-row bounds
  block_tiles(a.e.recv, a.e.mask, a.n_tiles, ET, a.node_block, b, s_lo, s_hi,
              range_s);
  const int64_t row_lo = int64_t(range_s[0]) * ET;
  const int64_t row_hi = int64_t(range_s[1]) * ET;
  const int n_ec = int((row_hi - row_lo) / kRows);
  node_bounds(a.e.recv, a.e.mask, row_lo, row_hi, node_lo, a.node_block,
              s_lo, s_hi);
  if (a.resident) {
    cp_async_wait<0>();
    __syncthreads();  // the node weights are visible
  }

  // 1. K4's chunk body over the block's node rows
  const int nk = a.node_block / kRows;
  for (int k = 0; k < nk; ++k) {
    const int64_t r0 = int64_t(node_lo) + int64_t(k) * kRows;
    float* sums = a.n_sums + r0 / kRows * 2 * kWarps * H;
    node_bwd_chunk<T, H>(
        a.n,
        [&](int p) -> const T* {
          if (a.resident) return w + mat_of<T>(p, nn) * kMat;
          return ring.next(p + 1 < 2 * nn ? nsrc(p + 1)
                           : k + 1 < nk   ? nsrc(0)
                           : n_ec > 0     ? esrc(0)
                                          : nullptr);
        },
        stg, warp_part,
        [&](int c) {
          sums[c] = warp_part[c];
          sums[kWarps * H + c] = warp_part[kWarps * H + c];
        },
        r0, nn - 3, warp, g, t, int64_t(a.n.n_rows) * H);
  }
  __syncthreads();  // the block's d_agg rows; the node weights are free
  if (a.resident) {  // the edge weights, in flight during the pad fill
    for (int m = 0; m < ne_st; ++m)
      copy_mat_async<T, H>(w + m * kMat, a.e.wb + size_t(m) * H * H);
    cp_async_commit();
  }
  // this warp's share of the pad tiles' chunks: d_e = ct_e, d_sg = 0
  pad_chunks<T, H>(a.e.mask, a.e.n_chunks, ET, a.e.ct_e, a.e.d_e, a.e.d_sg);
  if (a.resident) {
    cp_async_wait<0>();
    __syncthreads();  // the edge weights are visible
  }

  // 2. K2's chunk body over the block's live edge chunks
  for (int c = 0; c < n_ec; ++c) {
    const int64_t r0 = row_lo + int64_t(c) * kRows;
    float* sums = a.e_sums + r0 / kRows * 2 * kWarps * H;
    edge_bwd_chunk<T, H, kDeep, false>(
        a.e,
        [&](int p) -> const T* {
          if (a.resident) return w + mat_of<T>(p, ne) * kMat;
          return ring.next(p + 1 < 2 * ne ? esrc(p + 1)
                           : c + 1 < n_ec ? esrc(0)
                                          : nullptr);
        },
        stg, warp_part,
        [&](int c) {
          sums[c] = warp_part[c];
          sums[kWarps * H + c] = warp_part[kWarps * H + c];
        },
        r0, ne - 2, warp, g, t, a.e.n_edges);
  }
  ring.finish();
  __syncthreads();  // the block's d_sg rows and live-row bounds

  // 3. d_dproj of the block's nodes
  block_sum<T, H>(a.e.d_sg, a.e.mask, a.n_nodes, a.node_block, node_lo, s_lo,
                  s_hi, a.e.d_dproj);
}

// CTA (s, p): the LayerNorm column sums of split s of K2's chain (p = 0)
// and of K4's (p = 1) (ln_split, first, so they start with the launch),
// then K2's pairs (edge_dw_pair, split s of e_grid) and K4's (node_dw_pair,
// split s of n_grid), into the partials those kernels' own launches would
// have left.
template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
mega_dw_kernel(MegaBwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s = blockIdx.x, p = blockIdx.y;
  const int ne = a.e.n_hidden + 2, nn = a.n.n_hidden + 3;
  const int ET = a.e.edge_tile;
  if (p == 0) {
    if (s < a.e_grid)
      ln_split<H>(
          a.e_sums, s, a.e_grid, a.e.n_chunks,
          [&](int q) {
            return Num<T>::load1(a.e.mask + int64_t(q) * kRows / ET * ET) !=
                   0.f;
          },
          a.e.part + int64_t(s) * a.e.part_len + int64_t(ne) * H * H + H);
  } else if (p == 1) {
    if (s < a.n_grid)
      ln_split<H>(a.n_sums, s, a.n_grid, a.n.n_chunks,
                  [](int) { return true; },
                  a.n.part + int64_t(s) * a.n.part_len +
                      int64_t(nn) * H * H + H);
  } else if (p < 2 + ne) {
    if (s < a.e_grid)
      edge_dw_pair<T, H>(smem_raw, a.e, s, p - 2, a.e_grid);
  } else if (s < a.n_grid) {
    node_dw_pair<T, H>(smem_raw, a.n, s, p - 2 - ne, a.n_grid);
  }
}

// The workspace (ops/hopper_mega.py mega_bwd_plan lays it out alike), each
// region at a multiple of 256 bytes: K2's partials [e_grid][part_len_e],
// K4's [n_grid][part_len_n] (fp32); K2's a(0..nh) and dz(1..nh), d_d, each
// [E][H]; K4's a(0..nh) and dz(0..nh), d_d, each [N][H]; the chunks'
// LayerNorm column sums, edge then node ([chunks][2][kWarps][H] fp32);
// d_agg [N][H].
struct MegaBwdLayout {
  int64_t e_part, n_part, e_acts, e_cots, n_acts, e_sums, n_sums, d_agg,
      total;
};

inline MegaBwdLayout mega_bwd_layout(int64_t E, int64_t N, int h, int ne_h,
                                     int nn_h, int e_grid, int n_grid,
                                     int elem) {
  auto up = [](int64_t x) { return (x + 255) / 256 * 256; };
  const int64_t part_e = int64_t(ne_h + 2) * h * h + int64_t(ne_h + 3) * h;
  const int64_t part_n = int64_t(nn_h + 3) * h * h + int64_t(nn_h + 4) * h;
  MegaBwdLayout l{};
  l.e_part = 0;
  l.n_part = up(int64_t(e_grid) * part_e * 4);
  l.e_acts = l.n_part + up(int64_t(n_grid) * part_n * 4);
  l.e_cots = l.e_acts + up(int64_t(ne_h + 1) * E * h * elem);
  l.n_acts = l.e_cots + up(int64_t(ne_h + 1) * E * h * elem);
  l.e_sums = l.n_acts + up(int64_t(2 * nn_h + 3) * N * h * elem);
  l.n_sums = l.e_sums + up(E / kRows * 2 * kWarps * h * 4);
  l.d_agg = l.n_sums + up(N / kRows * 2 * kWarps * h * 4);
  l.total = l.d_agg + up(N * h * elem);
  return l;
}

// The launches on `stream`; dw receives K2's weight gradients then K4's
// (module comment). The grids and the residency flag are the plan's,
// checked against this side's reckoning.
template <typename T, int H>
cudaError_t launch(MegaBwdArgs<T> a, float* dw, void* workspace,
                   int64_t ws_bytes, cudaStream_t stream) {
  const int64_t E = a.e.n_edges, N = a.n_nodes;
  const int ne_h = a.e.n_hidden, nn_h = a.n.n_hidden, ET = a.e.edge_tile;
  if (ne_h < 0 || nn_h < 0 || a.node_block <= 0 || a.node_block % kRows ||
      N <= 0 || N % a.node_block || ET <= 0 || ET % kRows || E <= 0 ||
      E % ET || E > 0x7fffffff || a.n.n_rows != N)
    return cudaErrorInvalidValue;
  a.n_tiles = int(E / ET);
  a.e.n_chunks = int(E / kRows);
  a.n.n_chunks = int(N / kRows);
  if (a.e_grid <= 0 || a.e_grid > a.e.n_chunks || a.n_grid <= 0 ||
      a.n_grid > a.n.n_chunks)
    return cudaErrorInvalidValue;
  const MegaBwdLayout l = mega_bwd_layout(E, N, H, ne_h, nn_h, a.e_grid,
                                          a.n_grid, sizeof(T));
  if (ws_bytes < l.total) return cudaErrorInvalidValue;
  char* ws = static_cast<char*>(workspace);
  a.e.part = reinterpret_cast<float*>(ws + l.e_part);
  a.e.part_len = int64_t(ne_h + 2) * H * H + int64_t(ne_h + 3) * H;
  a.e.acts = reinterpret_cast<T*>(ws + l.e_acts);
  a.e.cots = reinterpret_cast<T*>(ws + l.e_cots);
  a.n.part = reinterpret_cast<float*>(ws + l.n_part);
  a.n.part_len = int64_t(nn_h + 3) * H * H + int64_t(nn_h + 4) * H;
  a.n.acts = reinterpret_cast<T*>(ws + l.n_acts);
  a.n.cots = a.n.acts + int64_t(nn_h + 1) * N * H;
  a.e_sums = reinterpret_cast<float*>(ws + l.e_sums);
  a.n_sums = reinterpret_cast<float*>(ws + l.n_sums);
  a.n.d_agg = reinterpret_cast<T*>(ws + l.d_agg);
  a.e.ct_agg = a.n.d_agg;

  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int ne_st = (ne_h + 2) * kCopies<T>, nn_st = (nn_h + 3) * kCopies<T>;
  const int n_st = ne_st > nn_st ? ne_st : nn_st;
  const size_t mat = Layout<T, H>::kMatBytes;
  const size_t fixed = mega_bwd_fixed_smem<T, H>(a.node_block);
  const int fits = n_st * mat + fixed <= size_t(max_smem);
  if (fits != a.resident) return cudaErrorInvalidValue;
  const size_t smem = (fits ? n_st : 2) * mat + fixed;
  if (smem > size_t(max_smem) || dw_smem<T, H>() > size_t(max_smem))
    return cudaErrorInvalidValue;

  auto kernel = ne_h > kMaxHidden ? fused_mgn_bwd_kernel<T, H, true>
                                  : fused_mgn_bwd_kernel<T, H, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(N / a.node_block), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dwk = mega_dw_kernel<T, H>;
  err = cudaFuncSetAttribute(dwk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(dw_smem<T, H>()));
  if (err != cudaSuccess) return err;
  const int splits = a.e_grid > a.n_grid ? a.e_grid : a.n_grid;
  dwk<<<dim3(splits, (ne_h + 2) + (nn_h + 3) + 2), kThreads, dw_smem<T, H>(),
        stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_reduce(a.e.part, a.e_grid, a.e.part_len, dw, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(a.n.part, a.n_grid, a.n.part_len, dw + a.e.part_len,
                       stream);
}

template <typename T>
int dispatch(void* const* p, void* dw, void* workspace, int64_t ws_bytes,
             int64_t n_edges, int64_t n_nodes, int h, int ne_hidden,
             int nn_hidden, int node_block, int edge_tile, int e_grid,
             int n_grid, int resident, cudaStream_t stream) {
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  // p: 0 e, 1 sg, 2 d_proj, 3 x, 4 agg, 5 mask, 6 recv | 7 wb_e, 8 bs_e,
  // 9 b_out_e, 10 ln_scale_e | 11 wb_n, 12 b1, 13 bs_n, 14 b_out_n,
  // 15 ln_scale_n | 16 ct_e, 17 ct_x | 18 d_e, 19 d_sg, 20 d_dproj, 21 d_x
  MegaBwdArgs<T> a{};
  a.e.e = in(0);
  a.e.sg = in(1);
  a.e.d_proj = in(2);
  a.e.mask = in(5);
  a.e.recv = static_cast<const int*>(p[6]);
  a.e.wb = in(7);
  a.e.bs = in(8);
  a.e.b_out = in(9);
  a.e.ln_scale = in(10);
  a.e.ct_e = in(16);
  a.e.d_e = out(18);
  a.e.d_sg = out(19);
  a.e.d_dproj = out(20);
  a.e.n_edges = n_edges;
  a.e.n_nodes = int(n_nodes);
  a.e.n_hidden = ne_hidden;
  a.e.edge_tile = edge_tile;
  a.n.x = in(3);
  a.n.agg = in(4);
  a.n.wb = in(11);
  a.n.b1 = in(12);
  a.n.bs = in(13);
  a.n.b_out = in(14);
  a.n.ln_scale = in(15);
  a.n.ct = in(17);
  a.n.d_x = out(21);
  a.n.n_rows = n_nodes;
  a.n.n_hidden = nn_hidden;
  a.e_grid = e_grid;
  a.n_grid = n_grid;
  a.n_nodes = int(n_nodes);
  a.node_block = node_block;
  a.resident = resident;
  auto f = static_cast<float*>(dw);
  if (h == 128)
    return int(launch<T, 128>(a, f, workspace, ws_bytes, stream));
  if (h == 64) return int(launch<T, 64>(a, f, workspace, ws_bytes, stream));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; h 64 or 128. The tensors in order: e,
// sg, d_proj, x, agg (the forward's), mask, receivers; the edge weights as
// aero_fused_edge_bwd takes them (wb_e [W_e, ws, W_out], bs, b_out,
// ln_scale) and the node weights as aero_fused_node_bwd (wb_n [W1x, W1a,
// ws, W_out], b1, bs, b_out, ln_scale), each wb laid out by
// ops/_build.py edge_bwd_operands; the cotangents ct_e, ct_x; the outputs
// d_e, d_sg, d_dproj, d_x. dw receives the fp32 weight gradients as
// aero_fused_edge_bwd's dw followed by aero_fused_node_bwd's. e_grid,
// n_grid (K2's and K4's weight-gradient splits), resident (the weights kept
// in shared memory, else streamed) and the workspace of at least
// mega_bwd_layout's bytes: ops/hopper_mega.py mega_bwd_plan. Returns a
// cudaError_t (0 = success).
extern "C" int aero_fused_mgn_bwd(
    const void* e, const void* sg, const void* d_proj, const void* x,
    const void* agg, const void* mask, const void* receivers,
    const void* wb_e, const void* e_bs, const void* e_b_out,
    const void* e_ln_scale, const void* wb_n, const void* b1,
    const void* n_bs, const void* n_b_out, const void* n_ln_scale,
    const void* ct_e, const void* ct_x, void* d_e, void* d_sg, void* d_dproj,
    void* d_x, void* dw, void* workspace, int64_t ws_bytes, int64_t n_edges,
    int64_t n_nodes, int h, int ne_hidden, int nn_hidden, int node_block,
    int edge_tile, int e_grid, int n_grid, int resident, int dtype,
    void* stream) {
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
      d_dproj,                       d_x};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(p, dw, workspace, ws_bytes, n_edges, n_nodes, h,
                           ne_hidden, nn_hidden, node_block, edge_tile,
                           e_grid, n_grid, resident, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(p, dw, workspace, ws_bytes, n_edges,
                                   n_nodes, h, ne_hidden, nn_hidden,
                                   node_block, edge_tile, e_grid, n_grid,
                                   resident, s);
  return int(cudaErrorInvalidValue);
}
