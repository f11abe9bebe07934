// One node block of the fused concat-trick edge layer's forward: the device
// code of the edge half of K9-fwd (fused_mgn_fwd.cu). K1 and its save
// variant ran it before their row kernel (edge_fwd_rows.cuh), which keeps
// its rounding points, so K9-fwd's e' and agg are K1's bits. Per
// receiver-sorted edge row
//
//   dg  = mask * d_proj[recv]                   (direct row read, no one-hot)
//   h0  = e @ W_e + sg + dg;  z = relu(h0)
//   z   = relu(z @ ws[i] + bs[i])               (i < n_hidden)
//   de  = z @ W_out + b_out
//   e'  = e + LayerNorm(de)                     (fp32 stats, eps 1e-5)
//   agg[n] = sum over rows with recv == n of mask * e'
//
// Layout contract (graph/padded.py align_edges): rows are receiver-sorted,
// E % edge_tile == 0, N % node_block == 0, and each node block owns a
// contiguous run of whole tiles (at least one). A tile's block is
// recv[first row] / node_block, derived by binary search, the same rule as
// derive_tiles.
//
// The CTA walks its block's rows in chunks of 128, runs the whole MLP chain
// per chunk in shared memory and registers, writes e', and folds the chunk
// into the aggregation with a segmented row sum over the sorted receivers,
// one column per thread, carrying the open receiver's partial sum to the
// next chunk. Every agg row of the block is written by that CTA alone
// (empty nodes, including the pad node, get exact zeros), so there are no
// atomics and the result is deterministic. The CTA walks only its block's
// tiles before the first pad tile (chain.cuh): pad tiles add nothing to
// agg, and the launch's fill_pad_tiles gives their e' rows e.
#pragma once

#include "chain.cuh"

namespace chain {

template <typename T>
struct EdgeFwdArgs {
  const T *e, *sg, *d_proj, *mask;
  const int* recv;
  const T *w_e, *ws, *bs, *w_out, *b_out, *ln_scale, *ln_bias;
  T *e_out, *agg;
  int n_tiles, n_nodes, n_hidden, node_block, edge_tile;

  // weights in chain order: 0 W_e, 1.. ws[i], n_hidden + 1 W_out
  template <int H>
  __device__ const T* weight(int m) const {
    return m == 0 ? w_e
                  : (m <= n_hidden ? ws + size_t(m - 1) * H * H : w_out);
  }
};

// Node block b of the edge layer. `act` is the CTA's [kRows][LD] activation
// buffer, `recv_s` [kRows] ints and `range_s` [2] ints of shared memory.
// Every thread of the CTA calls it; it ends with a __syncthreads.
template <typename T, int H>
__device__ void edge_fwd_block(const EdgeFwdArgs<T>& a,
                               const WeightSlots<T, H>& w, T* act,
                               int* recv_s, int* range_s, int b) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  T* my_act = act + warp * 16 * LD;
  float acc[H / 8][4];

  if (tid == 0) {
    const int lo = first_tile(a.recv, a.n_tiles, a.edge_tile, a.node_block, b);
    const int hi =
        first_tile(a.recv, a.n_tiles, a.edge_tile, a.node_block, b + 1);
    range_s[0] = lo;
    range_s[1] = first_pad_tile(a.mask, lo, hi, a.edge_tile);
  }
  __syncthreads();
  const int64_t row_lo = int64_t(range_s[0]) * a.edge_tile;
  const int64_t row_hi = int64_t(range_s[1]) * a.edge_tile;
  const int node_lo = b * a.node_block, node_hi = node_lo + a.node_block;
  // segmented-sum state of column `tid` (threads tid < H)
  int cur = node_lo - 1;
  float sum = 0.f;
  auto flush = [&](int node, float s) {
    if (node >= node_lo && node < node_hi)
      N::store1(a.agg + int64_t(node) * H + tid, s);
  };
  auto zero_gap = [&](int from, int to) {
    for (int z = max(from, node_lo); z < min(to, node_hi); ++z)
      N::store1(a.agg + int64_t(z) * H + tid, 0.f);
  };

  for (int64_t r0 = row_lo; r0 < row_hi; r0 += kRows) {
    const int64_t rw = r0 + warp * 16;
    const int64_t ra = rw + g, rb = rw + g + 8;

    // h0 = e @ W_e + sg + mask * d_proj[recv];  z = relu(h0)
    load_rows<T, H>(my_act, a.e + rw * H);
    __syncwarp();
    zero<H>(acc);
    mm<H>(my_act, w.use(0, a.template weight<H>(0)), acc);
    __syncwarp();
    const int na = a.recv[ra], nb = a.recv[rb];
    const float ma = N::load1(a.mask + ra), mb = N::load1(a.mask + rb);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 sa = N::load2(a.sg + ra * H + col);
      const float2 sb = N::load2(a.sg + rb * H + col);
      const float2 da = N::load2(a.d_proj + int64_t(na) * H + col);
      const float2 db = N::load2(a.d_proj + int64_t(nb) * H + col);
      const float v0 = N::rnd(N::rnd(N::rnd(acc[j][0]) + sa.x) + N::rnd(da.x * ma));
      const float v1 = N::rnd(N::rnd(N::rnd(acc[j][1]) + sa.y) + N::rnd(da.y * ma));
      const float v2 = N::rnd(N::rnd(N::rnd(acc[j][2]) + sb.x) + N::rnd(db.x * mb));
      const float v3 = N::rnd(N::rnd(N::rnd(acc[j][3]) + sb.y) + N::rnd(db.y * mb));
      N::store2(my_act + g * LD + col, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      N::store2(my_act + (g + 8) * LD + col, fmaxf(v2, 0.f), fmaxf(v3, 0.f));
    }
    __syncwarp();

    for (int i = 0; i < a.n_hidden; ++i) {
      zero<H>(acc);
      mm<H>(my_act, w.use(1 + i, a.template weight<H>(1 + i)), acc);
      __syncwarp();
      bias_relu_store<T, H>(acc, a.bs + size_t(i) * H, my_act);
      __syncwarp();
    }

    // e' = e + LayerNorm(z @ W_out + b_out)
    zero<H>(acc);
    mm<H>(my_act, w.use(a.n_hidden + 1, a.template weight<H>(a.n_hidden + 1)),
          acc);
    __syncwarp();
    bias_round<T, H>(acc, a.b_out);
    float mu[2], inv[2];
    row_stats<H>(acc, 0, mu[0], inv[0]);
    row_stats<H>(acc, 1, mu[1], inv[1]);
    layer_norm_rows<T, H>(acc, mu, inv, a.ln_scale, a.ln_bias);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 ea = N::load2(a.e + ra * H + col);
      const float2 eb = N::load2(a.e + rb * H + col);
      const float y0 = N::rnd(ea.x + acc[j][0]), y1 = N::rnd(ea.y + acc[j][1]);
      const float y2 = N::rnd(eb.x + acc[j][2]), y3 = N::rnd(eb.y + acc[j][3]);
      N::store2(a.e_out + ra * H + col, y0, y1);
      N::store2(a.e_out + rb * H + col, y2, y3);
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

}  // namespace chain
