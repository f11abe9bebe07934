// One node block of the fused concat-trick edge layer's backward: the
// device code of kernels K8 (fused_edge_bwd_saved.cu) and the edge half of
// K9-bwd (fused_mgn_bwd.cu), with K8's kernel and launch; K2 ran it too
// before its own schedule (edge_bwd_rows.cuh, the same math and rounding
// points). The VJP of the edge layer (K1's row kernel, edge_fwd_rows.cuh,
// whose rounding points the recompute follows) for the cotangents (ct_e
// of e', ct_agg of agg). Per receiver-sorted edge row the chain
//
//   h0 = e @ W_e + sg + mask * d_proj[recv];  a0 = relu(h0)
//   a(i+1) = relu(a(i) @ ws[i] + bs[i]);  d = a(nh) @ W_out + b_out
//
// is recomputed (K2, K9-bwd; the LayerNorm statistics of d in fp32,
// two-pass, as the forward) or read from what the save variant of K1 wrote
// (K8, kSaved: zs = a(0..nh), d, mu, inv; pallas_fused.py:1031-1099), then
//
//   ct   = ct_e + mask * ct_agg[recv]
//   d_d  = LayerNorm backward of ct (fp32, rounded to the compute type)
//   dz   = (d_d @ W_out^T) * (a(nh) > 0), then through the hidden stack
//          dz = (dz @ ws[i]^T) * (a(i) > 0)
//   d_e  = ct + dz @ W_e^T,   d_sg = dz,
//   d_dproj[n] = sum over rows with recv == n of mask * dz
//
// and the weight gradients in fp32: dW_e = e^T dz, dWs[i] = a(i)^T dz_i,
// dbs[i] = colsum dz_i, dW_out = a(nh)^T d_d, db_out = colsum d_d,
// dscale = colsum ct * xn, dbias = colsum ct (pallas_fused.py:653-696).
// Every rounding point follows the plain version (hopper_fused.py). The
// TPU kernels accumulate d_dproj per tile in the compute type; this code
// carries it in fp32 and rounds once.
//
// Schedule: K1's before its row kernel. One CTA per node block (persistent
// over blocks), its rows in chunks of 128; d_dproj is the segmented row
// sum carried across chunks (exact zeros for nodes without a real edge).
// The chunk's activations sit in buffers (chain_bwd.cuh); weights stream
// per stage, each a 16-byte copy of an operand the wrapper laid out for
// that product (8 stages a chunk at two hidden layers in K2, 4 in K8,
// which needs only the backward products). Weight gradients go to per-CTA
// fp32 partials and a second kernel sums them in CTA order: the same bits
// on every launch. Pad tiles are skipped (chain.cuh first_pad_tile; K9-fwd
// skips them too) -- in K8 this matters beyond speed: K1's save variant never
// wrote the saved rows of those tiles -- and fill_pad_tiles gives their
// d_e rows ct_e and their d_sg rows 0, which is the VJP wherever the
// cotangent of pad rows is zero, as it is on the training path.
#pragma once

#include "chain_bwd.cuh"

namespace chain {

template <typename T>
struct EdgeBwdArgs {
  const T *e, *sg, *d_proj, *mask;  // sg, d_proj: K2 / K9 only
  const int* recv;
  // the weights [W_e, ws[0..nh), W_out] each twice, [n][2][H][H]
  // (ops/_build.py mma_b_operands); bs, b_out: K2 / K9 only
  const T *wb, *bs, *b_out, *ln_scale, *ct_e, *ct_agg;
  T *d_e, *d_sg, *d_dproj;
  const T *zs, *d;            // K8: [nh + 1][n_edges][H], [n_edges][H]
  const float *mu, *inv;      // K8: [n_edges]
  int64_t n_edges;
  int n_tiles, n_nodes, n_hidden, node_block, edge_tile;
};

constexpr int kEdgeDz = 0;    // buffer: running cotangent dz (and d_d)
constexpr int kEdgeE = 1;     // buffer: e rows
constexpr int kEdgeAct0 = 2;  // buffers: a(0) .. a(nh)

// Node block b of the edge backward. `mats` is the CTA's fp32 partial of
// [dW_e, dWs[0..nh), dW_out] ([H, H] each), `vecs` its shared-memory
// [db_out, dscale, dbias, dbs[0..nh)] ([H] each); `range_s` [2] ints of
// shared memory. Every thread of the CTA calls it; it ends with a
// __syncthreads.
template <typename T, int H, bool kSaved>
__device__ void edge_bwd_block(const EdgeBwdArgs<T>& a, const BwdCta<T, H>& c,
                               float* mats, float* vecs, int* range_s, int b) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  const int nh = a.n_hidden;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  auto mat = [&](int m) { return mats + size_t(m) * H * H; };
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
  // segmented-sum state of d_dproj column `tid` (threads tid < H)
  int cur = node_lo - 1;
  float sum = 0.f;
  auto flush = [&](int node, float s) {
    if (node >= node_lo && node < node_hi)
      N::store1(a.d_dproj + int64_t(node) * H + tid, s);
  };
  auto zero_gap = [&](int from, int to) {
    for (int z = max(from, node_lo); z < min(to, node_hi); ++z)
      N::store1(a.d_dproj + int64_t(z) * H + tid, 0.f);
  };

  for (int64_t r0 = row_lo; r0 < row_hi; r0 += kRows) {
    const int64_t rw = r0 + wrow;
    const int64_t ra = rw + g, rb = rw + g + 8;
    T* e_w = c.buf(kEdgeE) + wrow * LD;
    T* dz_w = c.buf(kEdgeDz) + wrow * LD;
    load_rows<T, H>(e_w, a.e + rw * H);
    const int na = a.recv[ra], nb = a.recv[rb];
    const float ma = N::load1(a.mask + ra), mb = N::load1(a.mask + rb);
    if (t == 0) {
      c.recv_s[wrow + g] = na;
      c.recv_s[wrow + g + 8] = nb;
      c.mask_s[wrow + g] = ma;
      c.mask_s[wrow + g + 8] = mb;
    }
    float mu[2], inv[2];  // kSaved: the saved statistics of d
    if constexpr (kSaved) {
      // ---- the saved activations, pre-LayerNorm output and statistics ----
      for (int i = 0; i <= nh; ++i)
        load_rows<T, H>(c.buf(kEdgeAct0 + i) + wrow * LD,
                        a.zs + (size_t(i) * a.n_edges + rw) * H);
      load_acc<T, H>(acc, a.d + ra * H, a.d + rb * H);
      mu[0] = a.mu[ra];
      mu[1] = a.mu[rb];
      inv[0] = a.inv[ra];
      inv[1] = a.inv[rb];
      __syncwarp();
    } else {
      __syncwarp();
      // ---- forward recompute, as K1 ----
      c.stage(a.wb, 0, false);
      zero<H>(acc);
      mm<H>(e_w, c.slot, acc);
      {
        T* a_w = c.buf(kEdgeAct0) + wrow * LD;
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
          N::store2(a_w + g * LD + col, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          N::store2(a_w + (g + 8) * LD + col, fmaxf(v2, 0.f), fmaxf(v3, 0.f));
        }
      }
      __syncwarp();
      for (int i = 0; i < nh; ++i) {
        c.stage(a.wb, 1 + i, false);
        zero<H>(acc);
        mm<H>(c.buf(kEdgeAct0 + i) + wrow * LD, c.slot, acc);
        __syncwarp();
        bias_relu_store<T, H>(acc, a.bs + size_t(i) * H,
                              c.buf(kEdgeAct0 + i + 1) + wrow * LD);
        __syncwarp();
      }
      c.stage(a.wb, nh + 1, false);
      zero<H>(acc);
      mm<H>(c.buf(kEdgeAct0 + nh) + wrow * LD, c.slot, acc);
      bias_round<T, H>(acc, a.b_out);
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
        ln_backward<T, H>(acc, ct, a.ln_scale, c.warp_part, mu, inv);
      else  // the statistics of the recomputed d
        ln_backward<T, H>(acc, ct, a.ln_scale, c.warp_part);
    }
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      N::store2(dz_w + g * LD + col, acc[j][0], acc[j][1]);
      N::store2(dz_w + (g + 8) * LD + col, acc[j][2], acc[j][3]);
    }
    __syncthreads();
    add_warp_parts<H>(c.warp_part, vecs + H);
    add_warp_parts<H>(c.warp_part + kWarps * H, vecs + 2 * H);
    column_sum<T, H>(c.buf(kEdgeDz), vecs);
    weight_grad<T, H>(c.buf(kEdgeAct0 + nh), c.buf(kEdgeDz), mat(nh + 1));

    // ---- output linear and hidden stack, in reverse ----
    c.stage(a.wb, nh + 1, true);
    zero<H>(acc);
    mm<H>(dz_w, c.slot, acc);
    __syncwarp();
    relu_grad_store<T, H>(acc, c.buf(kEdgeAct0 + nh) + wrow * LD, dz_w);
    __syncthreads();
    for (int i = nh - 1; i >= 0; --i) {
      column_sum<T, H>(c.buf(kEdgeDz), vecs + size_t(3 + i) * H);
      weight_grad<T, H>(c.buf(kEdgeAct0 + i), c.buf(kEdgeDz), mat(1 + i));
      c.stage(a.wb, 1 + i, true);
      zero<H>(acc);
      mm<H>(dz_w, c.slot, acc);
      __syncwarp();
      relu_grad_store<T, H>(acc, c.buf(kEdgeAct0 + i) + wrow * LD, dz_w);
      __syncthreads();
    }

    // ---- dz is d(h0) = d_sg: dW_e, d_sg, d_e, d_dproj ----
    weight_grad<T, H>(c.buf(kEdgeE), c.buf(kEdgeDz), mat(0));
    store_rows<T, H>(a.d_sg + rw * H, dz_w);
    c.stage(a.wb, 0, true);
    zero<H>(acc);
    mm<H>(dz_w, c.slot, acc);
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
    // d_dproj: segmented sum of mask * dz down the chunk's sorted rows
    if (tid < H) {
      const T* dz_all = c.buf(kEdgeDz);
      for (int r = 0; r < kRows; ++r) {
        const int n = c.recv_s[r];
        if (n != cur) {
          flush(cur, sum);
          zero_gap(cur + 1, n);
          cur = n;
          sum = 0.f;
        }
        sum += c.mask_s[r] * N::load1(dz_all + r * LD + tid);
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

template <typename T, int H, bool kSaved>
__global__ void __launch_bounds__(kThreads, 1)
fused_edge_bwd_kernel(EdgeBwdArgs<T> a, float* __restrict__ part_all,
                      T* scratch, int n_smem, int64_t part_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int range_s[2];
  const int n_mats = a.n_hidden + 2, n_vecs = a.n_hidden + 3;
  const BwdCta<T, H> c(smem_raw, scratch, a.n_hidden + 3, n_smem);
  float* part = part_all + int64_t(blockIdx.x) * part_len;
  zero_grads<H>(part, n_mats, c.vec_s, n_vecs);
  const int n_blocks = a.n_nodes / a.node_block;
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x)
    edge_bwd_block<T, H, kSaved>(a, c, part, c.vec_s, range_s, b);
  float* vec_part = part + int64_t(n_mats) * H * H;
  for (int i = threadIdx.x; i < n_vecs * H; i += kThreads)
    vec_part[i] = c.vec_s[i];
}

template <typename T, int H>
cudaError_t plan_edge_bwd(int64_t n_nodes, int n_hidden, int node_block,
                          BwdPlan* p) {
  return plan_bwd<T, H>(n_hidden + 3, n_hidden + 2, n_hidden + 3,
                        n_nodes / node_block, p);
}

// The backward kernel, fill_pad_tiles, and the partials' sum into dw:
// [dW_e, dWs[0..nh), dW_out] ([H, H] each) then [db_out, dscale, dbias,
// dbs[0..nh)] ([H] each), fp32.
template <typename T, int H, bool kSaved>
cudaError_t launch_edge_bwd(const EdgeBwdArgs<T>& a, float* dw,
                            void* workspace, int64_t ws_bytes,
                            cudaStream_t stream) {
  BwdPlan p;
  cudaError_t err = plan_edge_bwd<T, H>(a.n_nodes, a.n_hidden, a.node_block,
                                        &p);
  if (err != cudaSuccess) return err;
  if (ws_bytes < p.ws_bytes || p.grid == 0) return cudaErrorInvalidValue;
  auto kernel = fused_edge_bwd_kernel<T, H, kSaved>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(p.smem));
  if (err != cudaSuccess) return err;
  float* part = static_cast<float*>(workspace);
  T* scratch = reinterpret_cast<T*>(static_cast<char*>(workspace) +
                                    int64_t(p.grid) * p.part_len * 4);
  kernel<<<p.grid, kThreads, p.smem, stream>>>(a, part, scratch, p.n_smem,
                                                p.part_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_fill_pad_tiles<T>(a.mask, a.n_tiles, a.edge_tile, H, a.d_e,
                                 a.ct_e, a.d_sg, nullptr, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, p.grid, p.part_len, dw, stream);
}

// Bytes of device workspace launch_edge_bwd needs (dtype 0 = float32,
// 1 = bfloat16). Returns a cudaError_t.
inline cudaError_t edge_bwd_workspace(int64_t n_nodes, int h, int n_hidden,
                                      int node_block, int dtype,
                                      int64_t* ws_bytes) {
  BwdPlan p;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && h == 128)
    err = plan_edge_bwd<float, 128>(n_nodes, n_hidden, node_block, &p);
  if (dtype == 0 && h == 64)
    err = plan_edge_bwd<float, 64>(n_nodes, n_hidden, node_block, &p);
  if (dtype == 1 && h == 128)
    err = plan_edge_bwd<__nv_bfloat16, 128>(n_nodes, n_hidden, node_block,
                                            &p);
  if (dtype == 1 && h == 64)
    err = plan_edge_bwd<__nv_bfloat16, 64>(n_nodes, n_hidden, node_block,
                                           &p);
  *ws_bytes = p.ws_bytes;
  return err;
}

// The arguments of a C entry (untyped pointers) as those of type T.
template <typename T>
EdgeBwdArgs<T> typed(const EdgeBwdArgs<void>& v) {
  return {static_cast<const T*>(v.e),      static_cast<const T*>(v.sg),
          static_cast<const T*>(v.d_proj), static_cast<const T*>(v.mask),
          v.recv,                          static_cast<const T*>(v.wb),
          static_cast<const T*>(v.bs),     static_cast<const T*>(v.b_out),
          static_cast<const T*>(v.ln_scale), static_cast<const T*>(v.ct_e),
          static_cast<const T*>(v.ct_agg), static_cast<T*>(v.d_e),
          static_cast<T*>(v.d_sg),         static_cast<T*>(v.d_dproj),
          static_cast<const T*>(v.zs),     static_cast<const T*>(v.d),
          v.mu,                            v.inv,
          v.n_edges,                       v.n_tiles,
          v.n_nodes,                       v.n_hidden,
          v.node_block,                    v.edge_tile};
}

// launch_edge_bwd for the dtype code (0 = float32, 1 = bfloat16) and the
// width h. Returns a cudaError_t (0 = success).
template <bool kSaved>
int dispatch_edge_bwd(const EdgeBwdArgs<void>& v, int h, int dtype,
                      void* dw, void* workspace, int64_t ws_bytes,
                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto out = static_cast<float*>(dw);
  if (dtype == 0 && h == 128)
    return int(launch_edge_bwd<float, 128, kSaved>(typed<float>(v), out,
                                                   workspace, ws_bytes, s));
  if (dtype == 0 && h == 64)
    return int(launch_edge_bwd<float, 64, kSaved>(typed<float>(v), out,
                                                  workspace, ws_bytes, s));
  if (dtype == 1 && h == 128)
    return int(launch_edge_bwd<__nv_bfloat16, 128, kSaved>(
        typed<__nv_bfloat16>(v), out, workspace, ws_bytes, s));
  if (dtype == 1 && h == 64)
    return int(launch_edge_bwd<__nv_bfloat16, 64, kSaved>(
        typed<__nv_bfloat16>(v), out, workspace, ws_bytes, s));
  return int(cudaErrorInvalidValue);
}

}  // namespace chain
