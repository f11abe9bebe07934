// Kernel K1 of the port and its save variant: the fused concat-trick edge
// layer's forward as a row kernel and a segmented sum that
// fused_edge_fwd.cu launches in turn. Per receiver-sorted edge row
//
//   dg  = mask * d_proj[recv]                   (direct row read)
//   h0  = e @ W_e + sg + dg;  z = relu(h0)
//   z   = relu(z @ ws[i] + bs[i])               (i < n_hidden)
//   de  = z @ W_out + b_out
//   e'  = e + LayerNorm(de)                     (fp32 stats, eps 1e-5)
//   agg[n] = sum over rows with recv == n of mask * e'
//
// with every rounding point of the node-block schedule it replaced, so e',
// agg and the save variant's outputs are the same bits as that schedule
// gave. K9-fwd (fused_mgn_fwd.cu) runs the same chunk body.
//
//  1. edge_fwd_rows_kernel: each warp owns 16 rows of a 128-row chunk and
//     runs the whole chain for them with no CTA barrier between products
//     (edge_rows_chunk on rows_bwd.cuh's machinery, the forward half of
//     K2's row kernel). In
//     bf16 the activation never leaves registers (the mma accumulator of
//     one product, rounded and packed in pairs, is the A fragment of the
//     next), the weights stay resident in shared memory for the CTA's life
//     and are read by ldmatrix, e's fragments are kept for the residual,
//     and sg and d_proj[recv] are loaded before the first product. fp32
//     (FFMA, no TF32) keeps each activation row-major in a warp-private
//     slice of shared memory, the next product's A operand, and runs its
//     products on RowTile, a register-blocked tile that reads 16 bytes of
//     shared memory per 16 FMA (chain.cuh's mm reads 8 per 4); its weights
//     stream through a ring of two slots, the next product's cp.async copy
//     overlapping the current product (one CTA barrier a product). The
//     weights are read as they lie in device memory ([in][out]): the bf16
//     product reads its B tile with ldmatrix.trans. The CTAs walk the
//     chunks round robin; a chunk of a pad tile (chain.cuh "Pad tiles":
//     all its rows are masked) gets e' = e, a zero update, copied across
//     the CTA, so no pad tile falls to one CTA alone. It writes e' and, in
//     the save variant (kSave), zs, d, mu and inv (not on the rows of pad
//     tiles, which K8 never reads).
//  2. agg: K5's bulk-copy ring (segment_bulk.cuh) over e', the receivers
//     and the mask, on a row pointer built first, with the pad sink
//     declared (graph/padded.py: the last node has no real edge, and the
//     Loader's pad tail is keyed to it): the fp32 sum of each node's rows
//     mask * e' in stream order, rounded once, the rows of mask 0 passed
//     over (they add +-0), exact zeros for nodes without a real edge. For
//     a 0/1 mask that is the sum the node-block schedule took. No atomics:
//     the same inputs give the same bits. A second pass, not a sum inside
//     the row kernel: a node's rows cross warps, chunks and CTAs there,
//     and the sum's order (the bits) would chain the CTAs again.
//
// The plan (grid, resident weights or the ring, shared memory, the row
// pointer's workspace) is made in Python (ops/hopper_fused.py
// edge_fwd_plan) and checked here.
#pragma once

#include "rows_bwd.cuh"
#include "segment_bulk.cuh"

namespace chain {

template <typename T>
struct FwdRowsArgs {
  const T *e, *sg, *d_proj, *mask;
  const int* recv;
  const T *w_e, *ws, *bs, *w_out, *b_out, *ln_scale, *ln_bias;
  T* e_out;
  T *zs, *d;        // kSave: [n_hidden + 1][n_edges][H], [n_edges][H]
  float *mu, *inv;  // kSave: [n_edges]
  int64_t n_edges;
  int n_hidden, edge_tile, n_chunks;
};

// The chain's weights (0 W_e, 1.. ws[i], n_hidden + 1 W_out).
template <typename T, int H>
__device__ __forceinline__ FwdChain<T, H> edge_chain(const FwdRowsArgs<T>& a) {
  return {a.w_e, nullptr, a.ws, a.w_out, 1, a.n_hidden + 2};
}

// Rows [r0, r0 + kRows) of a live chunk: e' (and, kSave, zs, d, mu, inv).
// get(m) gives product m's [in][out] weight tile in shared memory; stg is
// the warp's [16][LD] fp32 A operand slice. Every thread of the CTA calls
// it; the warps share nothing but what get() does.
template <typename T, int H, bool kSave, typename Get>
__device__ __forceinline__ void edge_rows_chunk(const FwdRowsArgs<T>& a,
                                                Get&& get, T* stg,
                                                int64_t r0) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  const int nh = a.n_hidden;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t E = a.n_edges;
  // e' = e + LayerNorm(acc + b_out) for the rows ra / rb, acc the last
  // product (and, saved, d, mu, inv); e_at(j) gives e's values at acc[j]
  auto finish_rows = [&](float (&acc)[H / 8][4], int64_t ra, int64_t rb,
                         auto e_at) {
    bias_round<T, H>(acc, a.b_out);
    float mu[2], inv[2];
    row_stats<H>(acc, 0, mu[0], inv[0]);
    row_stats<H>(acc, 1, mu[1], inv[1]);
    if constexpr (kSave) {
      store_acc<T, H>(acc, a.d + ra * H, a.d + rb * H);
      if (t == 0) {
        a.mu[ra] = mu[0];
        a.inv[ra] = inv[0];
        a.mu[rb] = mu[1];
        a.inv[rb] = inv[1];
      }
    }
    layer_norm_rows<T, H>(acc, mu, inv, a.ln_scale, a.ln_bias);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float4 ev = e_at(j);  // rows ra, rb
      N::store2(a.e_out + ra * H + col, N::rnd(ev.x + acc[j][0]),
                N::rnd(ev.y + acc[j][1]));
      N::store2(a.e_out + rb * H + col, N::rnd(ev.z + acc[j][2]),
                N::rnd(ev.w + acc[j][3]));
    }
  };

  const int64_t rw = r0 + warp * 16;
  if constexpr (sizeof(T) == 2) {
    const int64_t ra = rw + g, rb = ra + 8;
    RowOperand<T, H> op;
    const int na = a.recv[ra], nb = a.recv[rb];
    const float ma = N::load1(a.mask + ra), mb = N::load1(a.mask + rb);
    op.from_rows(a.e + ra * H, a.e + rb * H, stg);
    // e's A fragments, kept for the residual: they are e's rows ra / rb
    // in the accumulator layout
    uint32_t e_frag[H / 16][4];
#pragma unroll
    for (int kb = 0; kb < H / 16; ++kb)
#pragma unroll
      for (int q = 0; q < 4; ++q) e_frag[kb][q] = op.f[kb][q];
    // the first epilogue's operands, in flight during the product
    uint32_t sga[H / 8], sgb[H / 8], dpa[H / 8], dpb[H / 8];
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      sga[j] = *reinterpret_cast<const uint32_t*>(a.sg + ra * H + col);
      sgb[j] = *reinterpret_cast<const uint32_t*>(a.sg + rb * H + col);
      dpa[j] = *reinterpret_cast<const uint32_t*>(
          a.d_proj + int64_t(na) * H + col);
      dpb[j] = *reinterpret_cast<const uint32_t*>(
          a.d_proj + int64_t(nb) * H + col);
    }
    float acc[H / 8][4];
    zero<H>(acc);
    op.template mm<true>(get(0), acc, stg);
    // h0 = e @ W_e + sg + mask * d_proj[recv];  z = relu(h0)
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const float2 sa = widen(sga[j]), sb = widen(sgb[j]);
      const float2 da = widen(dpa[j]), db = widen(dpb[j]);
      const float v0 = N::rnd(N::rnd(N::rnd(acc[j][0]) + sa.x) + N::rnd(da.x * ma));
      const float v1 = N::rnd(N::rnd(N::rnd(acc[j][1]) + sa.y) + N::rnd(da.y * ma));
      const float v2 = N::rnd(N::rnd(N::rnd(acc[j][2]) + sb.x) + N::rnd(db.x * mb));
      const float v3 = N::rnd(N::rnd(N::rnd(acc[j][3]) + sb.y) + N::rnd(db.y * mb));
      acc[j][0] = fmaxf(v0, 0.f);
      acc[j][1] = fmaxf(v1, 0.f);
      acc[j][2] = fmaxf(v2, 0.f);
      acc[j][3] = fmaxf(v3, 0.f);
    }
    for (int i = 0; i <= nh; ++i) {
      // acc holds a(i), the post-ReLU activation the next product reads
      if constexpr (kSave)
        store_acc<T, H>(acc, a.zs + (i * E + ra) * H,
                        a.zs + (i * E + rb) * H);
      op.from_acc(acc, stg);
      zero<H>(acc);
      op.template mm<true>(get(1 + i), acc, stg);
      if (i < nh) bias_relu<T, H>(acc, a.bs + size_t(i) * H);
    }
    finish_rows(acc, ra, rb, [&](int j) {
      const float2 ea = widen(e_frag[j / 2][2 * (j & 1)]);
      const float2 eb = widen(e_frag[j / 2][2 * (j & 1) + 1]);
      return make_float4(ea.x, ea.y, eb.x, eb.y);
    });
  } else {
    // fp32: the chain on RowTile, each activation row-major in the warp's
    // slice (the next product's A operand)
    RowTile<H> tl;
    __syncwarp();  // the chunk before has read the slice
    load_rows<float, H>(stg, a.e + rw * H);
    __syncwarp();
    tl.mm(stg, get(0));
    // h0 = e @ W_e + sg + mask * d_proj[recv];  z = relu(h0)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t r = rw + tl.row(i);
      const float m = a.mask[r];
      const int n = a.recv[r];
#pragma unroll
      for (int q = 0; q < RowTile<H>::NQ; ++q) {
        const int col = tl.col(q);
        const float4 s4 = *reinterpret_cast<const float4*>(a.sg + r * H +
                                                            col);
        const float4 d4 = *reinterpret_cast<const float4*>(
            a.d_proj + int64_t(n) * H + col);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = N::rnd(N::rnd(N::rnd(tl.v[i][q][c]) + sv[c]) +
                                 N::rnd(dv[c] * m));
          tl.v[i][q][c] = fmaxf(x, 0.f);
        }
      }
    }
    for (int i = 0; i <= nh; ++i) {
      // tl holds a(i): the next product's A operand (and, saved, zs[i])
      __syncwarp();  // the product has read the slice
      tl.store(stg, LD);
      if constexpr (kSave) tl.store(a.zs + (i * E + rw) * H, H);
      __syncwarp();
      tl.mm(stg, get(1 + i));
      if (i < nh) tl.bias_relu(a.bs + size_t(i) * H);  // a(i + 1)
    }
    // the last product into the accumulator layout, through the slice
    float acc[H / 8][4];
    tl.to_acc(acc, stg);
    const int64_t ra = rw + g, rb = ra + 8;
    finish_rows(acc, ra, rb, [&](int j) {
      const int col = 8 * j + 2 * t;
      const float2 ea = N::load2(a.e + ra * H + col);
      const float2 eb = N::load2(a.e + rb * H + col);
      return make_float4(ea.x, ea.y, eb.x, eb.y);
    });
  }
}

template <typename T, int H, bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
edge_fwd_rows_kernel(FwdRowsArgs<T> a, int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  constexpr size_t kMat = FwdWeights<T, H>::kMat;
  FwdWeights<T, H> w{edge_chain<T, H>(a), {reinterpret_cast<T*>(smem_raw), 0},
                     resident};
  // fp32: the warps' A operand slices ([kRows][LD] after the weights)
  T* stg = reinterpret_cast<T*>(smem_raw) +
           (resident ? a.n_hidden + 2 : 2) * kMat +
           size_t(warp) * 16 * Layout<T, H>::kLd;
  w.start();
  for (int ch = blockIdx.x; ch < a.n_chunks; ch += gridDim.x) {
    const int64_t r0 = int64_t(ch) * kRows;
    if (Num<T>::load1(a.mask + r0 / a.edge_tile * a.edge_tile) == 0.f) {
      // a chunk of a pad tile (the same for the whole CTA): e' = e, a zero
      // update, 16 bytes a thread and copy
      constexpr int kVecs = kRows * H * int(sizeof(T)) / 16;
      const uint4* src = reinterpret_cast<const uint4*>(a.e + r0 * H);
      uint4* dst = reinterpret_cast<uint4*>(a.e_out + r0 * H);
      uint4 v[kVecs / kThreads];
#pragma unroll
      for (int k = 0; k < kVecs / kThreads; ++k)
        v[k] = src[k * kThreads + threadIdx.x];
#pragma unroll
      for (int k = 0; k < kVecs / kThreads; ++k)
        dst[k * kThreads + threadIdx.x] = v[k];
      continue;
    }
    edge_rows_chunk<T, H, kSave>(a, [&](int m) { return w.get(m); }, stg,
                                 r0);
  }
  w.finish();
}

// The launches (module comment) on `stream`. `grid` and `resident`
// are the plan's, checked against this side's reckoning; `workspace`
// holds the receiver stream's row pointer ([n_nodes + 1] ints).
template <typename T, int H, bool kSave>
cudaError_t launch_fwd_rows(FwdRowsArgs<T> a, T* agg, int64_t n_nodes,
                            int grid, int resident, void* workspace,
                            int64_t ws_bytes, cudaStream_t stream) {
  if (a.n_hidden < 0 || a.n_edges <= 0 || a.edge_tile % kRows ||
      a.n_edges % a.edge_tile || n_nodes <= 0)
    return cudaErrorInvalidValue;
  a.n_chunks = int(a.n_edges / kRows);
  if (grid <= 0 || grid > a.n_chunks || ws_bytes < (n_nodes + 1) * 4)
    return cudaErrorInvalidValue;
  int fits = 0;
  size_t smem = 0;
  cudaError_t err = fwd_rows_smem<T, H>(a.n_hidden + 2, &fits, &smem);
  if (err != cudaSuccess) return err;
  if (fits != resident) return cudaErrorInvalidValue;

  auto rows = edge_fwd_rows_kernel<T, H, kSave>;
  err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  rows<<<grid, kThreads, smem, stream>>>(a, resident);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int* offsets = static_cast<int*>(workspace);
  err = segrows::launch_offsets(a.recv, a.n_edges, n_nodes, offsets, stream);
  if (err != cudaSuccess) return err;
  return segbulk::launch_sums<T>(a.e_out, a.recv, a.mask, nullptr, offsets,
                                 agg, n_nodes, H, 1, stream);
}

}  // namespace chain
