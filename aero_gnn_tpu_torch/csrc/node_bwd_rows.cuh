// Kernel K4 of the port: the fused node block's backward, as two kernels
// and a reduction that fused_node_bwd.cu launches in turn. Per node row,
// the VJP of K3 (node_fwd_rows.cuh) for the cotangent ct of x' = x +
// LayerNorm(MLP([x, agg])), with every rounding point of the plain version
// (ops/hopper_node.py): the chain recomputed,
//
//   a0 = relu(x @ W1x + agg @ W1a + b1)   (the two products in one fp32
//                                          accumulator before the single
//                                          rounding, as K3 and the TPU
//                                          kernel, pallas_node.py:212)
//   a(i+1) = relu(a(i) @ ws[i] + bs[i]);  d = a(nh) @ W_out + b_out
//
// the LayerNorm backward with the statistics of d in fp32, the cotangent
// run back through the stack, d_x = ct + dz0 @ W1x^T (the residual) and
// d_agg = dz0 @ W1a^T (pallas_node.py:226-265).
//
//  1. node_rows_kernel: each warp owns 16 rows of a 128-row chunk and runs
//     that whole chain for them with no CTA barrier (node_bwd_chunk, which
//     K9-bwd runs on its node blocks; rows_bwd.cuh: in bf16
//     the activation between two products stays in registers and the ReLU
//     masks are bits, those past kMaxHidden + 1 read back from the a(i)
//     it stored; fp32 stages the A operand per warp). Its products
//     read the weights [W1x, W1a, ws[0..nh), W_out] forward and the same
//     in reverse backward, so d_agg is written before d_x. The weights are
//     resident where they fit (bf16 at two hidden layers: 5 x 34.8 KB),
//     else stream through WeightRing's two slots. It writes d_x, d_agg
//     and, for the weight gradients, a(0..nh), dz(0..nh) and d_d to the
//     workspace; the LayerNorm column sums (dscale, dbias) accumulate per
//     warp in shared memory over all of the CTA's chunks.
//  2. node_dw_kernel: CTA (s, p) sums pair p of the nh + 3 weight
//     gradients (x, dz0), (agg, dz0), (a(i), dz(i + 1)), (a(nh), d_d) over
//     split s with dw_split, and the bias gradients db1, dbs, db_out as
//     the column sums of dz0, dz(i + 1), d_d.
//  3. reduce_partials (chain_bwd.cuh) sums the splits' partials in split
//     order. No float atomics: the same inputs give the same bits.
//
// The plan (grid, whether the weights are resident, the workspace: [grid]
// fp32 partials, then a(0..nh), then dz(0..nh), d_d, each [N][H] of T) is
// made in Python (ops/hopper_node.py node_bwd_plan) and checked here.
#pragma once

#include "rows_bwd.cuh"

namespace chain {

template <typename T>
struct NodeRowsArgs {
  const T *x, *agg;
  // [W1x, W1a, ws[0..nh), W_out] as the products read their B operand
  // (ops/_build.py edge_bwd_operands): bf16 [n_hidden + 3][H][H]
  // transposed ([n][k]), fp32 [n_hidden + 3][2][H][H] (W and W^T, [k][n])
  const T *wb, *b1, *bs, *b_out, *ln_scale, *ct;
  T *d_x, *d_agg;
  T *acts, *cots;  // workspace: a(0..nh), and dz(0..nh) then d_d
  float* part;     // workspace: [grid][part_len]
  int64_t n_rows, part_len;
  int n_hidden, n_chunks;
};

// Rows [r0, r0 + kRows) (module comment, 1): d_x, d_agg and the workspace
// rows. get(p) gives product p's weight tile (mat_of's numbering); stg is
// the warp's [16][LD] fp32 A operand slice, warp_part the CTA's
// [2][kWarps][H] LayerNorm column sums of one chunk (ln_backward);
// add_sums(c) takes the warp's dscale / dbias sums at warp_part[c] and
// warp_part[kWarps * H + c], c = warp * H + column (the lanes of g == 0
// call it). Every thread of the CTA calls it; the warps share nothing but
// what get() does. nh (n_hidden), warp, g, t (the lane's row pair and
// column pair) and NH (n_rows * H) come from the caller, computed once
// for its kernel, as in edge_bwd_chunk.
template <typename T, int H, typename Get, typename Sums>
__device__ __forceinline__ void node_bwd_chunk(const NodeRowsArgs<T>& a,
                                               Get&& get, T* stg,
                                               float* warp_part,
                                               Sums&& add_sums, int64_t r0,
                                               int nh, int warp, int g, int t,
                                               int64_t NH) {
  using N = Num<T>;
  const int n_mats = nh + 3;
  RowOperand<T, H> op;
  float acc[H / 8][4];
  uint64_t bits[kMaxHidden + 1];
  const int64_t ra = r0 + warp * 16 + g, rb = ra + 8;
  auto store_rows_of = [&](T* base) {
    store_acc<T, H>(acc, base + ra * H, base + rb * H);
  };

  // ---- forward recompute, as K3: x @ W1x + agg @ W1a in one sum ----
  zero<H>(acc);
  op.from_rows(a.x + ra * H, a.x + rb * H, stg);
  op.template mm<false>(get(0), acc, stg);
  op.from_rows(a.agg + ra * H, a.agg + rb * H, stg);
  op.template mm<false>(get(1), acc, stg);
  bias_relu<T, H>(acc, a.b1);
  for (int i = 0; i <= nh; ++i) {
    // acc holds a(i): keep it for the weight gradients and its mask
    store_rows_of(a.acts + i * NH);
    if (i <= kMaxHidden) bits[i] = relu_bits<H>(acc);
    op.from_acc(acc, stg);
    zero<H>(acc);
    op.template mm<false>(get(2 + i), acc, stg);
    if (i < nh) bias_relu<T, H>(acc, a.bs + size_t(i) * H);
  }
  bias_round<T, H>(acc, a.b_out);  // d, the pre-LayerNorm output

  // ---- LayerNorm backward ----
  {
    float ct[H / 8][4];
    load_acc<T, H>(ct, a.ct + ra * H, a.ct + rb * H);
    ln_backward<T, H>(acc, ct, a.ln_scale, warp_part);
  }
  if (g == 0) {  // this lane's columns of the warp's dscale / dbias sums
#pragma unroll
    for (int j = 0; j < H / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) add_sums(warp * H + 8 * j + 2 * t + q);
  }

  // a(i)'s ReLU mask: the bits kept, or deeper in the stack the a(i)
  // this thread stored, the same bits (a(i) is rounded to T before the
  // ReLU, so the store is exact)
  auto mask_of = [&](int i) {
    return i <= kMaxHidden
               ? bits[i]
               : stored_relu_bits<T, H>(a.acts + i * NH + ra * H,
                                        a.acts + i * NH + rb * H);
  };

  // ---- acc = d_d: output linear and hidden stack, in reverse ----
  store_rows_of(a.cots + (nh + 1) * NH);
  op.from_acc(acc, stg);
  zero<H>(acc);
  op.template mm<true>(get(n_mats), acc, stg);
  relu_grad<T, H>(acc, mask_of(nh));
  for (int i = nh - 1; i >= 0; --i) {
    store_rows_of(a.cots + (i + 1) * NH);  // dz(i + 1)
    op.from_acc(acc, stg);
    zero<H>(acc);
    op.template mm<true>(get(2 * n_mats - 3 - i), acc, stg);
    relu_grad<T, H>(acc, mask_of(i));
  }

  // ---- acc = dz0: d_agg = dz0 @ W1a^T, d_x = ct + dz0 @ W1x^T ----
  store_rows_of(a.cots);
  op.from_acc(acc, stg);
  zero<H>(acc);
  op.template mm<true>(get(2 * n_mats - 2), acc, stg);
  store_rows_of(a.d_agg);
  zero<H>(acc);
  op.template mm<true>(get(2 * n_mats - 1), acc, stg);
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 ca = N::load2(a.ct + ra * H + col);
    const float2 cb = N::load2(a.ct + rb * H + col);
    N::store2(a.d_x + ra * H + col, N::rnd(ca.x + N::rnd(acc[j][0])),
              N::rnd(ca.y + N::rnd(acc[j][1])));
    N::store2(a.d_x + rb * H + col, N::rnd(cb.x + N::rnd(acc[j][2])),
              N::rnd(cb.y + N::rnd(acc[j][3])));
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
node_rows_kernel(NodeRowsArgs<T> a, int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nh = a.n_hidden, n_mats = nh + 3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t NH = a.n_rows * H;
  constexpr size_t kMat = WeightRing<T, H>::kMat;
  WeightRing<T, H> ring{reinterpret_cast<T*>(smem_raw), a.wb, resident,
                        n_mats, 0};
  unsigned char* rest =
      smem_raw + (resident ? n_mats * kCopies<T> : 2) * kMat * sizeof(T);
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

  for (int ch = blockIdx.x; ch < a.n_chunks; ch += gridDim.x)
    node_bwd_chunk<T, H>(
        a, [&](int p) { return ring.get(p); }, stg, warp_part,
        [&](int c) {
          vsum[c] += warp_part[c];
          vsum[kWarps * H + c] += warp_part[kWarps * H + c];
        },
        int64_t(ch) * kRows, nh, warp, g, t, NH);
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

// Split s of `step`, pair p of the weight gradients (dw_split): dW1x =
// x^T dz0 with db1 (vector 3), dW1a = agg^T dz0, dWs[i] = a(i)^T dz(i + 1)
// with dbs[i] (vector 4 + i), dW_out = a(nh)^T d_d with db_out (vector 0).
// Every chunk is live. Every thread of the CTA calls it.
template <typename T, int H>
__device__ __forceinline__ void node_dw_pair(unsigned char* smem,
                                             const NodeRowsArgs<T>& a, int s,
                                             int p, int step) {
  const int nh = a.n_hidden;
  const int64_t NH = a.n_rows * H;
  const T* A = p == 0 ? a.x : p == 1 ? a.agg : a.acts + (p - 2) * NH;
  const T* D = p < 2 ? a.cots : a.cots + (p - 1) * NH;
  float* part = a.part + int64_t(s) * a.part_len;
  const int vi = p == 0 ? 3 : p == 1 ? -1 : p == nh + 2 ? 0 : 2 + p;
  float* vec = vi < 0 ? nullptr : part + int64_t(nh + 3) * H * H + vi * H;
  dw_split<T, H>(smem, A, D, s, step, a.n_chunks, [](int q) { return q; },
                 part + int64_t(p) * H * H, vec);
}

// CTA (s, p): node_dw_pair over split s of gridDim.x.
template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
node_dw_kernel(NodeRowsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  node_dw_pair<T, H>(smem_raw, a, blockIdx.x, blockIdx.y, gridDim.x);
}

// Bytes of workspace the launch needs: the partials (padded to 256 bytes),
// then a(0..nh), then dz(0..nh), d_d (ops/hopper_node.py node_bwd_plan
// lays it out alike); the offset of the activations in *acts_at.
inline int64_t node_rows_workspace(int64_t n_rows, int h, int n_hidden,
                                   int grid, int elem, int64_t* acts_at) {
  const int64_t part_len =
      int64_t(n_hidden + 3) * h * h + int64_t(n_hidden + 4) * h;
  *acts_at = (int64_t(grid) * part_len * 4 + 255) / 256 * 256;
  return *acts_at + int64_t(2 * n_hidden + 3) * n_rows * h * elem;
}

// The three launches (module comment) on `stream`; dw receives [dW1x,
// dW1a, dWs[0..nh), dW_out] ([H, H] each) then [db_out, dscale, dbias,
// db1, dbs[0..nh)] ([H] each), fp32. `grid` and `resident` are the plan's.
template <typename T, int H>
cudaError_t launch_node_rows_bwd(NodeRowsArgs<T> a, float* dw,
                                 void* workspace, int64_t ws_bytes, int grid,
                                 int resident, cudaStream_t stream) {
  const int nh = a.n_hidden, n_mats = nh + 3;
  if (nh < 0 || a.n_rows <= 0 || a.n_rows % kRows)
    return cudaErrorInvalidValue;
  a.n_chunks = int(a.n_rows / kRows);
  if (grid <= 0 || grid > a.n_chunks) return cudaErrorInvalidValue;
  int64_t acts_at = 0;
  if (ws_bytes < node_rows_workspace(a.n_rows, H, nh, grid, sizeof(T),
                                     &acts_at))
    return cudaErrorInvalidValue;
  size_t smem = 0;
  int fits = 0;
  cudaError_t err =
      rows_smem<T, H>(n_mats * kCopies<T>, resident, &smem, &fits);
  if (err != cudaSuccess) return err;
  if (resident && !fits) return cudaErrorInvalidValue;
  a.part_len = int64_t(n_mats) * H * H + int64_t(nh + 4) * H;
  char* ws = static_cast<char*>(workspace);
  a.part = reinterpret_cast<float*>(ws);
  a.acts = reinterpret_cast<T*>(ws + acts_at);
  a.cots = a.acts + int64_t(nh + 1) * a.n_rows * H;

  auto rows = node_rows_kernel<T, H>;
  err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  rows<<<grid, kThreads, smem, stream>>>(a, resident);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dwk = node_dw_kernel<T, H>;
  err = cudaFuncSetAttribute(dwk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(dw_smem<T, H>()));
  if (err != cudaSuccess) return err;
  dwk<<<dim3(grid, n_mats), kThreads, dw_smem<T, H>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(a.part, grid, a.part_len, dw, stream);
}

}  // namespace chain
