// Kernels K2 and K8 of the port: the fused concat-trick edge layer's
// backward (K2, recomputing the chain) and its backward from the save
// variant's activations (K8, kSaved), each as three kernels that
// fused_edge_bwd.cu / fused_edge_bwd_saved.cu launch in turn. Per receiver-
// sorted edge row, the VJP of K1 (edge_fwd_rows.cuh) for the cotangents
// ct_e of e' and ct_agg of agg, with every rounding point of the plain
// version (ops/hopper_fused.py):
//
//   h0 = e @ W_e + sg + mask * d_proj[recv];  a(0) = relu(h0)
//   a(i+1) = relu(a(i) @ ws[i] + bs[i]);  d = a(nh) @ W_out + b_out
//   ct   = ct_e + mask * ct_agg[recv]
//   d_d  = LayerNorm backward of ct (fp32 statistics of d, rounded to T)
//   dz   = (d_d @ W_out^T) * (a(nh) > 0), then through the hidden stack
//          dz = (dz @ ws[i]^T) * (a(i) > 0)
//   d_e  = ct + dz @ W_e^T,   d_sg = dz,
//   d_dproj[n] = sum over rows with recv == n of mask * dz
//
// and the weight gradients in fp32: dW_e = e^T dz, dWs[i] = a(i)^T dz_i,
// dbs[i] = colsum dz_i, dW_out = a(nh)^T d_d, db_out = colsum d_d, dscale =
// colsum ct * xn, dbias = colsum ct (pallas_fused.py:653-696).
//
//  1. edge_rows_kernel: each warp owns 16 rows of a 128-row chunk and runs
//     the whole chain for them with no CTA barrier (edge_bwd_chunk, which
//     K9-bwd runs on its node blocks' edge chunks): K2 recomputes the
//     forward (e @ W_e + sg + mask * d_proj[recv], the hidden stack,
//     W_out) and writes the post-ReLU activations a(0..nh) for the weight
//     gradients; K8 starts from the save variant's d, mu, inv and reads
//     each ReLU mask from its zs = a(0..nh) where the mask is used, so it
//     runs only the nh + 2 backward products and writes no activation. Both then run the
//     LayerNorm backward and the backward products, writing d_e, d_sg and
//     the cotangents dz(1..nh), d_d to a workspace. In bf16 the activation
//     between two products never leaves registers: the mma accumulator of
//     one product, rounded and packed in pairs, is the A fragment of the
//     next (the m16n8 accumulator layout is the k16 A layout), and the
//     ReLU masks are kept as bits (those past kMaxHidden + 1 read back from
//     the a(i) in device memory, so any depth runs, as the TPU kernel's).
//     fp32 (FFMA, no TF32) stages each product's A operand in a
//     warp-private slice of shared memory. Weights (WeightRing): in bf16
//     one copy of each, the forward product reading it with ldmatrix and
//     the backward one (dz @ W^T) with ldmatrix.trans from the same tile;
//     in fp32 K2 keeps W and W^T, K8 W^T only. All resident for the CTA's
//     life where they fit (the bf16 flagship: 4 x 34.8 KB), else (fp32 at
//     h = 128) a ring of two slots in the product order, the next weight's
//     cp.async copy overlapping the current product, one CTA barrier per
//     product. The LayerNorm column sums (dscale, dbias) accumulate per
//     warp in shared memory over all of the CTA's chunks.
//  2. fill_pad_rows (pad tiles' d_e and d_sg, kFillSplit CTAs a tile),
//     then d_dproj, the segmented row sum of
//     mask * d_sg by receiver, on K7's lane-group schedule
//     (segment_rows.cuh, the pad sink declared).
//  3. edge_dw_kernel: dW = A^T dZ for the nh + 2 pairs (e, d_sg), (a(i),
//     dz(i + 1)), (a(nh), d_d), and the bias gradients as column sums of
//     dZ, split over the rows: CTA (s, p) sums pair p over the chunks s, s
//     + grid, ... in 64-row slabs that cp.async double-buffers, mma.sync on
//     fragments ldmatrix.trans loads (bf16) or FFMA (fp32), its fp32
//     accumulator in registers for the CTA's whole range, written once. K8
//     reads zs where K2 reads its workspace's a(i).
//  4. reduce_partials (chain_bwd.cuh) sums the per-split partials in split
//     order. No float atomics anywhere: the same inputs give the same bits.
//
// K8 runs K2's grid and chunk-to-CTA map on K2's products, rounding points
// and sums, and zs, d, mu, inv are the bits K2 recomputes (K1's save
// variant writes them from the same chain), so all ten of its outputs are
// K2's bit for bit.
//
// Pad tiles (chain.cuh "Pad tiles": a tile whose first row is masked) are
// skipped by kernels 1 and 3 (K1's save variant never wrote their saved
// rows) and filled by fill_pad_rows (d_e = ct_e, d_sg = 0), the VJP
// wherever the cotangent of pad rows is zero, as on the training path. The
// workspace ([grid] partials; K2 then a(0..nh); dz(1..nh), d_d, each
// [E][H] of T; then d_dproj's row pointer) is planned in Python
// (ops/hopper_fused.py edge_bwd_plan, edge_bwd_saved_plan) and checked
// here. The machinery of kernels 1 and 3 (WeightRing, RowOperand, the ReLU
// bits, DwAcc, dw_split) is rows_bwd.cuh's, which K4 (node_bwd_rows.cuh)
// shares.
#pragma once

#include "rows_bwd.cuh"
#include "segment_rows.cuh"

namespace chain {

template <typename T>
struct RowsBwdArgs {
  const T *e, *sg, *d_proj, *mask;  // sg, d_proj: K2 only
  const int* recv;
  // W_e, ws[0..nh), W_out as the products read their B operand: K2 bf16
  // [n_hidden + 2][H][H] transposed ([n][k]), fp32 [n_hidden + 2][2][H][H]
  // (W and W^T, [k][n]) (ops/_build.py edge_bwd_operands); K8 W^T only,
  // [n_hidden + 2][H][H] (bwd_only_operands)
  const T *wb, *bs, *b_out, *ln_scale, *ct_e, *ct_agg;  // bs, b_out: K2
  T *d_e, *d_sg, *d_dproj;
  // a(0..nh): K2's workspace, K8 the save variant's zs (only read); then
  // dz(1..nh), d_d (workspace)
  T *acts, *cots;
  const T* d;              // K8: the save variant's d [E][H]
  const float *mu, *inv;   // K8: its statistics [E]
  float* part;             // workspace: [grid][part_len]
  int* offsets;            // workspace: the receiver stream's row pointer [N + 1]
  int64_t n_edges, part_len;
  int n_nodes, n_hidden, edge_tile, n_chunks;
};

// Rows [r0, r0 + kRows) of a live chunk (module comment, 1): d_e, d_sg and
// the workspace rows. get(p) gives product p's weight tile (mat_of's
// numbering: 0 .. n_mats - 1 forward, n_mats .. 2 n_mats - 1 backward;
// kSaved calls only the latter); stg is the warp's [16][LD] fp32 A operand
// slice, warp_part the CTA's [2][kWarps][H] LayerNorm column sums of one
// chunk (ln_backward); add_sums(c) takes the warp's dscale / dbias sums at
// warp_part[c] and warp_part[kWarps * H + c], c = warp * H + column (the
// lanes of g == 0 call it). Every thread of the CTA calls it; the warps
// share nothing but what get() does. nh (n_hidden), warp, g, t (the lane's
// row pair and column pair) and E (n_edges) come from the caller, computed
// once for its kernel: computed in each chunk, they left K2's row kernel
// with another register allocation (222 registers against 229 in bf16 at
// h = 128) and ~2 % slower on the H100. kDeep: the stack is deeper than
// the ReLU masks kept in registers (n_hidden > kMaxHidden); the shallower
// ones compile without the read-back path, which slowed the flagship's
// bf16 row kernel by a third on the H100.
template <typename T, int H, bool kDeep, bool kSaved, typename Get,
          typename Sums>
__device__ __forceinline__ void edge_bwd_chunk(const RowsBwdArgs<T>& a,
                                               Get&& get, T* stg,
                                               float* warp_part,
                                               Sums&& add_sums, int64_t r0,
                                               int nh, int warp, int g, int t,
                                               int64_t E) {
  using N = Num<T>;
  RowOperand<T, H> op;
  float acc[H / 8][4];
  uint64_t bits[kMaxHidden + 1];
  const int64_t ra = r0 + warp * 16 + g, rb = ra + 8;
  const int na = a.recv[ra], nb = a.recv[rb];
  const float ma = N::load1(a.mask + ra), mb = N::load1(a.mask + rb);
  auto store_rows_of = [&](T* base) {
    store_acc<T, H>(acc, base + ra * H, base + rb * H);
  };

  float mu[2], inv[2];  // kSaved: the saved statistics of d
  if constexpr (kSaved) {
    // ---- the save variant's d and its statistics ----
    load_acc<T, H>(acc, a.d + ra * H, a.d + rb * H);
    mu[0] = a.mu[ra];
    mu[1] = a.mu[rb];
    inv[0] = a.inv[ra];
    inv[1] = a.inv[rb];
  } else {
    // ---- forward recompute, as K1 ----
    op.from_rows(a.e + ra * H, a.e + rb * H, stg);
    zero<H>(acc);
    op.template mm<false>(get(0), acc, stg);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 sa = N::load2(a.sg + ra * H + col);
      const float2 sb = N::load2(a.sg + rb * H + col);
      const float2 da = N::load2(a.d_proj + int64_t(na) * H + col);
      const float2 db = N::load2(a.d_proj + int64_t(nb) * H + col);
      acc[j][0] = fmaxf(N::rnd(N::rnd(N::rnd(acc[j][0]) + sa.x) +
                               N::rnd(da.x * ma)), 0.f);
      acc[j][1] = fmaxf(N::rnd(N::rnd(N::rnd(acc[j][1]) + sa.y) +
                               N::rnd(da.y * ma)), 0.f);
      acc[j][2] = fmaxf(N::rnd(N::rnd(N::rnd(acc[j][2]) + sb.x) +
                               N::rnd(db.x * mb)), 0.f);
      acc[j][3] = fmaxf(N::rnd(N::rnd(N::rnd(acc[j][3]) + sb.y) +
                               N::rnd(db.y * mb)), 0.f);
    }
    for (int i = 0; i <= nh; ++i) {
      // acc holds a(i): keep it for the weight gradients and its mask
      store_rows_of(a.acts + i * E * H);
      if (!kDeep || i <= kMaxHidden) bits[i] = relu_bits<H>(acc);
      op.from_acc(acc, stg);
      zero<H>(acc);
      op.template mm<false>(get(1 + i), acc, stg);
      if (i < nh) {  // a(i + 1) = relu(rnd(rnd(acc) + bs[i]))
        const T* b = a.bs + size_t(i) * H;
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          const float2 bb = N::load2(b + 8 * j + 2 * t);
          acc[j][0] = fmaxf(N::rnd(N::rnd(acc[j][0]) + bb.x), 0.f);
          acc[j][1] = fmaxf(N::rnd(N::rnd(acc[j][1]) + bb.y), 0.f);
          acc[j][2] = fmaxf(N::rnd(N::rnd(acc[j][2]) + bb.x), 0.f);
          acc[j][3] = fmaxf(N::rnd(N::rnd(acc[j][3]) + bb.y), 0.f);
        }
      }
    }
    bias_round<T, H>(acc, a.b_out);  // d, the pre-LayerNorm output
  }

  // ---- ct = ct_e + mask * ct_agg[recv]; LayerNorm backward ----
  {
    float ct[H / 8][4];
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 ea = N::load2(a.ct_e + ra * H + col);
      const float2 eb = N::load2(a.ct_e + rb * H + col);
      const float2 ga = N::load2(a.ct_agg + int64_t(na) * H + col);
      const float2 gb = N::load2(a.ct_agg + int64_t(nb) * H + col);
      ct[j][0] = N::rnd(ea.x + N::rnd(ma * ga.x));
      ct[j][1] = N::rnd(ea.y + N::rnd(ma * ga.y));
      ct[j][2] = N::rnd(eb.x + N::rnd(mb * gb.x));
      ct[j][3] = N::rnd(eb.y + N::rnd(mb * gb.y));
    }
    if constexpr (kSaved)
      ln_backward<T, H>(acc, ct, a.ln_scale, warp_part, mu, inv);
    else  // the statistics of the recomputed d
      ln_backward<T, H>(acc, ct, a.ln_scale, warp_part);
  }
  if (g == 0) {  // this lane's columns of the warp's dscale / dbias sums
#pragma unroll
    for (int j = 0; j < H / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) add_sums(warp * H + 8 * j + 2 * t + q);
  }

  // a(i)'s ReLU mask: the bits kept, or (kSaved, or deeper in the stack)
  // read from the a(i) in device memory where it is used, the same bits
  // (a(i) is rounded to T before the ReLU, so the store is exact; K8 read
  // all of them at the chunk's start slower, 0.52 against 0.48 ms for its
  // bf16 row kernel on the H100)
  auto mask_of = [&](int i) {
    return !kSaved && (!kDeep || i <= kMaxHidden)
               ? bits[i]
               : stored_relu_bits<T, H>(a.acts + i * E * H + ra * H,
                                        a.acts + i * E * H + rb * H);
  };

  // ---- acc = d_d: output linear and hidden stack, in reverse ----
  store_rows_of(a.cots + nh * E * H);
  op.from_acc(acc, stg);
  zero<H>(acc);
  op.template mm<true>(get(nh + 2), acc, stg);
  relu_grad<T, H>(acc, mask_of(nh));
  for (int i = nh - 1; i >= 0; --i) {
    store_rows_of(a.cots + i * E * H);  // dz(i + 1)
    op.from_acc(acc, stg);
    zero<H>(acc);
    op.template mm<true>(get(2 * nh + 2 - i), acc, stg);
    relu_grad<T, H>(acc, mask_of(i));
  }

  // ---- acc = dz(0) = d_sg; d_e = ct + dz @ W_e^T ----
  store_rows_of(a.d_sg);
  op.from_acc(acc, stg);
  zero<H>(acc);
  op.template mm<true>(get(2 * nh + 3), acc, stg);
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 ea = N::load2(a.ct_e + ra * H + col);
    const float2 eb = N::load2(a.ct_e + rb * H + col);
    const float2 ga = N::load2(a.ct_agg + int64_t(na) * H + col);
    const float2 gb = N::load2(a.ct_agg + int64_t(nb) * H + col);
    const float c0 = N::rnd(ea.x + N::rnd(ma * ga.x));
    const float c1 = N::rnd(ea.y + N::rnd(ma * ga.y));
    const float c2 = N::rnd(eb.x + N::rnd(mb * gb.x));
    const float c3 = N::rnd(eb.y + N::rnd(mb * gb.y));
    N::store2(a.d_e + ra * H + col, N::rnd(c0 + N::rnd(acc[j][0])),
              N::rnd(c1 + N::rnd(acc[j][1])));
    N::store2(a.d_e + rb * H + col, N::rnd(c2 + N::rnd(acc[j][2])),
              N::rnd(c3 + N::rnd(acc[j][3])));
  }
}

template <typename T, int H, bool kDeep, bool kSaved>
__global__ void __launch_bounds__(kThreads, 1)
edge_rows_kernel(RowsBwdArgs<T> a, int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nh = a.n_hidden, n_mats = nh + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t E = a.n_edges;
  constexpr size_t kMat = WeightRing<T, H, kSaved>::kMat;
  WeightRing<T, H, kSaved> ring{reinterpret_cast<T*>(smem_raw), a.wb,
                                resident, n_mats, 0};
  unsigned char* rest =
      smem_raw +
      (resident ? n_mats * kStored<T, kSaved> : 2) * kMat * sizeof(T);
  float* stg_all = reinterpret_cast<float*>(rest);
  float* warp_part = reinterpret_cast<float*>(
      rest + (sizeof(T) == 4 ? Layout<T, H>::kActBytes : 0));
  float* vsum = warp_part + 2 * kWarps * H;  // [2][kWarps][H]
  T* stg = reinterpret_cast<T*>(stg_all) + warp * 16 * Layout<T, H>::kLd;
  for (int i = lane; i < H; i += 32) {
    vsum[warp * H + i] = 0.f;
    vsum[(kWarps + warp) * H + i] = 0.f;
  }
  __syncwarp();
  ring.start();

  for (int ch = blockIdx.x; ch < a.n_chunks; ch += gridDim.x) {
    const int64_t r0 = int64_t(ch) * kRows;
    // a chunk of a pad tile: nothing to do (the same for the whole CTA)
    if (Num<T>::load1(a.mask + r0 / a.edge_tile * a.edge_tile) == 0.f)
      continue;
    edge_bwd_chunk<T, H, kDeep, kSaved>(
        a, [&](int p) { return ring.get(p); }, stg, warp_part,
        [&](int c) {
          vsum[c] += warp_part[c];
          vsum[kWarps * H + c] += warp_part[kWarps * H + c];
        },
        r0, nh, warp, g, t, E);
  }
  ring.finish();
  __syncthreads();
  // this CTA's dscale (vector 1) and dbias (vector 2): warps in order
  float* vec = a.part + int64_t(blockIdx.x) * a.part_len +
               int64_t(n_mats) * H * H;
  for (int c = tid; c < H; c += kThreads) {
    float sx = 0.f, sc = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sx += vsum[w * H + c];
      sc += vsum[(kWarps + w) * H + c];
    }
    vec[H + c] = sx;
    vec[2 * H + c] = sc;
  }
}

constexpr int kFillSplit = 16;  // CTAs per pad tile in fill_pad_rows

// The rows of every pad tile (first row masked): d_e = ct_e, d_sg = 0.
// CTA (x, tile) copies part x of kFillSplit of its tile, 16 bytes per
// thread and store, so a pad tile costs a few round trips, not a CTA's
// serial walk; the CTAs of other tiles return at once.
template <typename T>
__global__ void __launch_bounds__(256)
fill_pad_rows(const T* __restrict__ mask, int edge_tile, int h,
              const T* __restrict__ ct_e, T* __restrict__ d_e,
              T* __restrict__ d_sg) {
  const int64_t tile = blockIdx.y;
  if (Num<T>::load1(mask + tile * edge_tile) != 0.f) return;
  const int64_t vecs = int64_t(edge_tile) * h * sizeof(T) / 16;
  const int64_t per = (vecs + kFillSplit - 1) / kFillSplit;
  const int64_t lo = tile * vecs + blockIdx.x * per;
  const int64_t hi = min(lo + per, (tile + 1) * vecs);
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    reinterpret_cast<uint4*>(d_e)[i] = reinterpret_cast<const uint4*>(ct_e)[i];
    reinterpret_cast<uint4*>(d_sg)[i] = zero4;
  }
}

// First chunk at or after q, stepping by `step`, that is not a pad tile's
// (n_chunks if none).
template <typename T>
__device__ __forceinline__ int live_chunk(const RowsBwdArgs<T>& a, int q,
                                          int step) {
  while (q < a.n_chunks &&
         Num<T>::load1(a.mask + int64_t(q) * kRows / a.edge_tile *
                                    a.edge_tile) == 0.f)
    q += step;
  return q;
}

// Split s of `step`, pair p of dW = A^T dZ (dw_split): the pairs (e,
// d_sg), (a(i), dz(i + 1)), (a(nh), d_d), and the bias gradients as column
// sums of dZ: db_out (vector 0) from d_d, dbs[p - 1] (vector 3 + p - 1)
// from dz; W_e has no bias. Every thread of the CTA calls it.
template <typename T, int H>
__device__ __forceinline__ void edge_dw_pair(unsigned char* smem,
                                             const RowsBwdArgs<T>& a, int s,
                                             int p, int step) {
  const int nh = a.n_hidden;
  const int64_t EH = a.n_edges * H;
  const T* A = p == 0 ? a.e : a.acts + (p - 1) * EH;
  const T* D = p == 0 ? a.d_sg : a.cots + (p - 1) * EH;
  float* part = a.part + int64_t(s) * a.part_len;
  float* vec = p == 0 ? nullptr
                      : part + int64_t(nh + 2) * H * H +
                            (p == nh + 1 ? 0 : 2 + p) * H;
  dw_split<T, H>(smem, A, D, s, step, a.n_chunks,
                 [&](int q) { return live_chunk(a, q, step); },
                 part + int64_t(p) * H * H, vec);
}

// CTA (s, p): edge_dw_pair over split s of gridDim.x.
template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
edge_dw_kernel(RowsBwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  edge_dw_pair<T, H>(smem_raw, a, blockIdx.x, blockIdx.y, gridDim.x);
}

// Bytes of workspace the launch needs: the partials, then (K2) a(0..nh),
// then dz(1..nh), d_d, then d_dproj's row pointer (ops/hopper_fused.py
// edge_bwd_plan / edge_bwd_saved_plan lay it out alike); the offset of the
// cotangents in *cots_at.
inline int64_t rows_bwd_workspace(int64_t n_edges, int64_t n_nodes, int h,
                                  int n_hidden, int grid, int elem,
                                  bool saved, int64_t* cots_at) {
  const int64_t part_len =
      int64_t(n_hidden + 2) * h * h + int64_t(n_hidden + 3) * h;
  const int64_t act_bytes = int64_t(n_hidden + 1) * n_edges * h * elem;
  *cots_at = (int64_t(grid) * part_len * 4 + 255) / 256 * 256 +
             (saved ? 0 : act_bytes);
  return *cots_at + act_bytes + (n_nodes + 1) * 4;
}

// The four launches (module comment) on `stream`; dw receives [dW_e,
// dWs[0..nh), dW_out] ([H, H] each) then [db_out, dscale, dbias,
// dbs[0..nh)] ([H] each), fp32. K2 keeps its weights resident where they
// fit; K8 (kSaved, a.acts = zs) takes `resident` from its plan and checks
// it against this side's reckoning.
template <typename T, int H, bool kSaved>
cudaError_t launch_rows_bwd(RowsBwdArgs<T> a, float* dw, void* workspace,
                            int64_t ws_bytes, int grid, int resident,
                            cudaStream_t stream) {
  const int nh = a.n_hidden, n_mats = nh + 2;
  if (nh < 0 || grid <= 0 || a.n_edges <= 0 || a.n_edges % kRows ||
      a.edge_tile <= 0 || a.edge_tile % kRows || a.n_edges % a.edge_tile)
    return cudaErrorInvalidValue;
  a.n_chunks = int(a.n_edges / kRows);
  if (grid > a.n_chunks) return cudaErrorInvalidValue;
  int64_t cots_at = 0;
  const int64_t need = rows_bwd_workspace(a.n_edges, a.n_nodes, H, nh, grid,
                                          sizeof(T), kSaved, &cots_at);
  if (ws_bytes < need) return cudaErrorInvalidValue;
  a.part_len = int64_t(n_mats) * H * H + int64_t(nh + 3) * H;
  char* ws = static_cast<char*>(workspace);
  a.part = reinterpret_cast<float*>(ws);
  const int64_t act_bytes = int64_t(nh + 1) * a.n_edges * H * sizeof(T);
  if (!kSaved) a.acts = reinterpret_cast<T*>(ws + cots_at - act_bytes);
  a.cots = reinterpret_cast<T*>(ws + cots_at);
  a.offsets = reinterpret_cast<int*>(ws + cots_at + act_bytes);

  // the weights resident where they fit, else the two-slot ring
  const int n_stored = n_mats * kStored<T, kSaved>;
  int fits = 0;
  size_t smem = 0;
  cudaError_t err = rows_smem<T, H>(n_stored, 0, &smem, &fits);
  if (err != cudaSuccess) return err;
  if (kSaved && fits != resident) return cudaErrorInvalidValue;
  if (fits) err = rows_smem<T, H>(n_stored, 1, &smem, &fits);
  if (err != cudaSuccess) return err;

  auto rows = nh > kMaxHidden ? edge_rows_kernel<T, H, true, kSaved>
                              : edge_rows_kernel<T, H, false, kSaved>;
  err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  rows<<<grid, kThreads, smem, stream>>>(a, fits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fill_pad_rows<T><<<dim3(kFillSplit, unsigned(a.n_edges / a.edge_tile)),
                     256, 0, stream>>>(a.mask, a.edge_tile, H, a.ct_e, a.d_e,
                                       a.d_sg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = segrows::launch<T, false>(a.d_sg, a.recv, a.mask, nullptr, nullptr,
                                  a.offsets, a.d_dproj, a.n_edges, a.n_nodes,
                                  H, 1, stream);
  if (err != cudaSuccess) return err;
  auto dwk = edge_dw_kernel<T, H>;
  err = cudaFuncSetAttribute(dwk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(dw_smem<T, H>()));
  if (err != cudaSuccess) return err;
  dwk<<<dim3(grid, n_mats), kThreads, dw_smem<T, H>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(a.part, grid, a.part_len, dw, stream);
}

}  // namespace chain
