// Fused concat-trick edge layer, forward (kernel K1 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_fused.py fused_edge_layer -> _fused_fwd
// (pallas_call of _make_kernel / _make_kernel_split). Computes exactly its
// reference composition _equiv: per receiver-sorted edge row
//
//   dg  = mask * d_proj[recv]                   (direct row read, no one-hot)
//   h0  = e @ W_e + sg + dg;  z = relu(h0)
//   z   = relu(z @ ws[i] + bs[i])               (i < n_hidden)
//   de  = z @ W_out + b_out
//   e'  = e + LayerNorm(de)                     (fp32 stats, eps 1e-5)
//   agg[n] = sum over rows with recv == n of mask * e'
//
// and returns (e', agg). Layout contract (graph/padded.py align_edges):
// rows are receiver-sorted, E % edge_tile == 0, N % node_block == 0, and each
// node block owns a contiguous run of whole tiles (at least one). A tile's
// block is recv[first row] / node_block, derived here by binary search, the
// same rule as derive_tiles.
//
// Schedule: one CTA per node block (persistent over blocks). The CTA walks
// its block's rows in chunks of 128, runs the whole MLP chain per chunk in
// shared memory and registers, writes e', and folds the chunk into the
// aggregation with a segmented row sum over the sorted receivers, one
// column per thread, carrying the open receiver's partial sum to the next
// chunk. Every agg row of the block is written by that CTA alone (empty
// nodes, including the pad node, get exact zeros), so there are no atomics
// and the result is deterministic: the same inputs give the same bits.
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 4 products of 2*E*h^2 = 34.6 GFLOP per launch. In bf16 the bytes moved
// (read e, sg, d_proj, recv, mask; write e', agg: ~239 MB) bound it; in fp32
// the FFMA rate bounds it (no TF32, to keep fp32 results). This version
// keeps the weights resident in shared memory when they fit (bf16), streams
// them per stage otherwise (fp32), and uses mma.sync, not wgmma/TMA.

#include "chain.cuh"

namespace {

using namespace chain;

__device__ int first_tile(const int* __restrict__ recv, int n_tiles,
                          int edge_tile, int node_block, int block) {
  int lo = 0, hi = n_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (recv[int64_t(mid) * edge_tile] / node_block < block)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
fused_edge_fwd_kernel(const T* __restrict__ e, const T* __restrict__ sg,
                      const T* __restrict__ d_proj, const T* __restrict__ mask,
                      const int* __restrict__ recv, const T* __restrict__ w_e,
                      const T* __restrict__ ws, const T* __restrict__ bs,
                      const T* __restrict__ w_out, const T* __restrict__ b_out,
                      const T* __restrict__ ln_scale,
                      const T* __restrict__ ln_bias, T* __restrict__ e_out,
                      T* __restrict__ agg, int n_tiles, int n_nodes,
                      int n_hidden, int node_block, int edge_tile,
                      int resident) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int range_s[2];
  const int n_mats = n_hidden + 2;
  T* wbuf = reinterpret_cast<T*>(smem_raw);
  T* act = wbuf + size_t(resident ? n_mats : 1) * H * LD;
  int* recv_s = reinterpret_cast<int*>(act + kRows * LD);

  auto weight = [&](int m) -> const T* {
    return m == 0 ? w_e
                  : (m <= n_hidden ? ws + size_t(m - 1) * H * H : w_out);
  };
  auto slot = [&](int m) -> const T* {
    return resident ? wbuf + size_t(m) * H * LD : wbuf;
  };
  auto stage = [&](int m) {  // streamed weights: whole CTA swaps the slot
    if (!resident) {
      __syncthreads();
      load_weight<T, H>(wbuf, weight(m));
      __syncthreads();
    }
  };
  if (resident) {
    for (int m = 0; m < n_mats; ++m)
      load_weight<T, H>(wbuf + size_t(m) * H * LD, weight(m));
    __syncthreads();
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  T* my_act = act + warp * 16 * LD;
  const int n_blocks = n_nodes / node_block;
  float acc[H / 8][4];

  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    if (tid == 0) {
      range_s[0] = first_tile(recv, n_tiles, edge_tile, node_block, b);
      range_s[1] = first_tile(recv, n_tiles, edge_tile, node_block, b + 1);
    }
    __syncthreads();
    const int64_t row_lo = int64_t(range_s[0]) * edge_tile;
    const int64_t row_hi = int64_t(range_s[1]) * edge_tile;
    const int node_lo = b * node_block, node_hi = node_lo + node_block;
    // segmented-sum state of column `tid` (threads tid < H)
    int cur = node_lo - 1;
    float sum = 0.f;
    auto flush = [&](int node, float s) {
      if (node >= node_lo && node < node_hi)
        N::store1(agg + int64_t(node) * H + tid, s);
    };
    auto zero_gap = [&](int from, int to) {
      for (int z = max(from, node_lo); z < min(to, node_hi); ++z)
        N::store1(agg + int64_t(z) * H + tid, 0.f);
    };

    for (int64_t r0 = row_lo; r0 < row_hi; r0 += kRows) {
      const int64_t rw = r0 + warp * 16;
      const int64_t ra = rw + g, rb = rw + g + 8;

      // h0 = e @ W_e + sg + mask * d_proj[recv];  z = relu(h0)
      load_rows<T, H>(my_act, e + rw * H);
      __syncwarp();
      zero<H>(acc);
      stage(0);
      mm<H>(my_act, slot(0), acc);
      __syncwarp();
      const int na = recv[ra], nb = recv[rb];
      const float ma = N::load1(mask + ra), mb = N::load1(mask + rb);
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 sa = N::load2(sg + ra * H + col);
        const float2 sb = N::load2(sg + rb * H + col);
        const float2 da = N::load2(d_proj + int64_t(na) * H + col);
        const float2 db = N::load2(d_proj + int64_t(nb) * H + col);
        const float v0 = N::rnd(N::rnd(N::rnd(acc[j][0]) + sa.x) + N::rnd(da.x * ma));
        const float v1 = N::rnd(N::rnd(N::rnd(acc[j][1]) + sa.y) + N::rnd(da.y * ma));
        const float v2 = N::rnd(N::rnd(N::rnd(acc[j][2]) + sb.x) + N::rnd(db.x * mb));
        const float v3 = N::rnd(N::rnd(N::rnd(acc[j][3]) + sb.y) + N::rnd(db.y * mb));
        N::store2(my_act + g * LD + col, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        N::store2(my_act + (g + 8) * LD + col, fmaxf(v2, 0.f), fmaxf(v3, 0.f));
      }
      __syncwarp();

      for (int i = 0; i < n_hidden; ++i) {
        zero<H>(acc);
        stage(1 + i);
        mm<H>(my_act, slot(1 + i), acc);
        __syncwarp();
        bias_relu_store<T, H>(acc, bs + size_t(i) * H, my_act);
        __syncwarp();
      }

      // e' = e + LayerNorm(z @ W_out + b_out)
      zero<H>(acc);
      stage(n_hidden + 1);
      mm<H>(my_act, slot(n_hidden + 1), acc);
      __syncwarp();
      bias_layer_norm<T, H>(acc, b_out, ln_scale, ln_bias);
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 ea = N::load2(e + ra * H + col);
        const float2 eb = N::load2(e + rb * H + col);
        const float y0 = N::rnd(ea.x + acc[j][0]), y1 = N::rnd(ea.y + acc[j][1]);
        const float y2 = N::rnd(eb.x + acc[j][2]), y3 = N::rnd(eb.y + acc[j][3]);
        N::store2(e_out + ra * H + col, y0, y1);
        N::store2(e_out + rb * H + col, y2, y3);
        N::store2(my_act + g * LD + col, y0 * ma, y1 * ma);  // mask * e'
        N::store2(my_act + (g + 8) * LD + col, y2 * mb, y3 * mb);
      }
      if (t == 0) {
        recv_s[warp * 16 + g] = na;
        recv_s[warp * 16 + g + 8] = nb;
      }
      __syncthreads();

      // agg: segmented sum down the chunk's sorted rows, column `tid`
      if (tid < H) {
        for (int r = 0; r < kRows; ++r) {
          const int n = recv_s[r];
          if (n != cur) {
            flush(cur, sum);
            zero_gap(cur + 1, n);
            cur = n;
            sum = 0.f;
          }
          sum += N::load1(act + r * LD + tid);
        }
      }
      __syncthreads();
    }
    if (tid < H) {
      flush(cur, sum);
      zero_gap(cur + 1, node_hi);
    }
    __syncthreads();  // range_s is rewritten for the next block
  }
}

template <typename T, int H>
cudaError_t launch(const void* e, const void* sg, const void* d_proj,
                   const void* mask, const int* recv, const void* w_e,
                   const void* ws, const void* bs, const void* w_out,
                   const void* b_out, const void* ln_scale,
                   const void* ln_bias, void* e_out, void* agg,
                   int64_t n_edges, int64_t n_nodes, int n_hidden,
                   int node_block, int edge_tile, cudaStream_t stream) {
  int resident = 0;
  size_t smem = 0;
  cudaError_t err = plan_smem<T, H>(n_hidden + 2, kRows * sizeof(int),
                                    &resident, &smem);
  if (err != cudaSuccess) return err;
  auto kernel = fused_edge_fwd_kernel<T, H>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const int n_blocks = int(n_nodes / node_block);
  const int grid = n_blocks < sm_count() ? n_blocks : sm_count();
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(e), static_cast<const T*>(sg),
      static_cast<const T*>(d_proj), static_cast<const T*>(mask), recv,
      static_cast<const T*>(w_e), static_cast<const T*>(ws),
      static_cast<const T*>(bs), static_cast<const T*>(w_out),
      static_cast<const T*>(b_out), static_cast<const T*>(ln_scale),
      static_cast<const T*>(ln_bias), static_cast<T*>(e_out),
      static_cast<T*>(agg), int(n_edges / edge_tile), int(n_nodes), n_hidden,
      node_block, edge_tile, resident);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int aero_fused_edge_fwd(
    const void* e, const void* sg, const void* d_proj, const void* mask,
    const void* receivers, const void* w_e, const void* ws, const void* bs,
    const void* w_out, const void* b_out, const void* ln_scale,
    const void* ln_bias, void* e_out, void* agg, int64_t n_edges,
    int64_t n_nodes, int h, int n_hidden, int node_block, int edge_tile,
    int dtype, void* stream) {
  const int* recv = static_cast<const int*>(receivers);
  auto s = static_cast<cudaStream_t>(stream);
#define AERO_EDGE_CASE(T, H)                                                 \
  return int(launch<T, H>(e, sg, d_proj, mask, recv, w_e, ws, bs, w_out,     \
                          b_out, ln_scale, ln_bias, e_out, agg, n_edges,     \
                          n_nodes, n_hidden, node_block, edge_tile, s))
  if (dtype == 0 && h == 128) AERO_EDGE_CASE(float, 128);
  if (dtype == 0 && h == 64) AERO_EDGE_CASE(float, 64);
  if (dtype == 1 && h == 128) AERO_EDGE_CASE(__nv_bfloat16, 128);
  if (dtype == 1 && h == 64) AERO_EDGE_CASE(__nv_bfloat16, 64);
#undef AERO_EDGE_CASE
  return int(cudaErrorInvalidValue);
}
