// Fused concat-trick edge layer, backward (kernel K2 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_fused.py _fel_bwd -> _fused_bwd
// (pallas_call of _make_bwd_kernel / _make_bwd_kernel_split). The VJP of
// K1 (fused_edge_fwd.cu) for the cotangents (ct_e of e', ct_agg of agg):
// per receiver-sorted edge row it recomputes the forward chain
//
//   h0 = e @ W_e + sg + mask * d_proj[recv];  a0 = relu(h0)
//   a(i+1) = relu(a(i) @ ws[i] + bs[i]);  d = a(nh) @ W_out + b_out
//
// with the LayerNorm statistics of d in fp32 (two-pass, as K1), then
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
// Every rounding point follows the plain version (hopper_fused.py
// fused_edge_layer_bwd_ref). The TPU kernel accumulates d_dproj per tile in
// the compute type; this one carries it in fp32 and rounds once.
//
// Schedule: K1's. One CTA per node block (persistent over blocks), its rows
// in chunks of 128; d_dproj is the segmented row sum of K1's agg carried
// across chunks (exact zeros for nodes without a real edge). The chunk's
// activations sit in buffers (chain_bwd.cuh): bf16 h = 128 with two hidden
// layers keeps all five plus the weight slot in 209 KB of shared memory;
// fp32 keeps two there and the rest in device scratch. Weights stream per
// stage (8 stages a chunk at two hidden layers), each a 16-byte copy of an
// operand the wrapper laid out for that product. Weight gradients go to
// per-CTA fp32 partials and a second kernel sums them in CTA order: the
// result is the same bits on every launch. Pad tiles are skipped as in K1
// (chain.cuh): fill_pad_tiles gives their d_e rows ct_e and their d_sg rows
// 0, which is the VJP wherever the cotangent of pad rows is zero, as it is
// on the training path.
//
// Bound on the H100 (flagship E = 264,192, N = 66,048, h = 128, 2 hidden):
// 3 x 4 products of 2*E*h^2 = 104 GFLOP per launch; bytes: read e, sg,
// ct_e, d_proj, ct_agg, recv, mask, write d_e, d_sg, d_dproj (~389 MB in
// bf16). bf16: bytes bound it (0.12 ms); fp32: FFMA bounds it (1.55 ms).
// This version uses mma.sync (the weight-gradient products on fragments
// that ldmatrix.trans loads), no wgmma/TMA.

#include "chain_bwd.cuh"

namespace {

using namespace chain;

constexpr int kDz = 0;    // buffer: running cotangent dz (and d_d)
constexpr int kE = 1;     // buffer: e rows
constexpr int kAct0 = 2;  // buffers: a(0) .. a(nh)

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
fused_edge_bwd_kernel(const T* __restrict__ e, const T* __restrict__ sg,
                      const T* __restrict__ d_proj, const T* __restrict__ mask,
                      const int* __restrict__ recv, const T* __restrict__ wb,
                      const T* __restrict__ bs, const T* __restrict__ b_out,
                      const T* __restrict__ ln_scale,
                      const T* __restrict__ ct_e, const T* __restrict__ ct_agg,
                      T* __restrict__ d_e, T* __restrict__ d_sg,
                      T* __restrict__ d_dproj, float* __restrict__ part_all,
                      T* scratch, int n_tiles, int n_nodes, int n_hidden,
                      int node_block, int edge_tile, int n_smem,
                      int64_t part_len) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int range_s[2];
  const int n_bufs = n_hidden + 3, n_mats = n_hidden + 2;
  const int n_vecs = n_hidden + 3;
  T* slot = reinterpret_cast<T*>(smem_raw);
  T* sbuf = slot + H * LD;
  int* recv_s = reinterpret_cast<int*>(sbuf + size_t(n_smem) * kRows * LD);
  float* mask_s = reinterpret_cast<float*>(recv_s + kRows);
  float* warp_part = mask_s + kRows;  // [2][kWarps][H]
  float* vec_s = warp_part + 2 * kWarps * H;  // db_out, dscale, dbias, dbs
  T* gbuf = scratch + size_t(blockIdx.x) * (n_bufs - n_smem) * kRows * LD;
  float* part = part_all + int64_t(blockIdx.x) * part_len;

  auto buf = [&](int b) -> T* {
    return b < n_smem ? sbuf + size_t(b) * kRows * LD
                      : gbuf + size_t(b - n_smem) * kRows * LD;
  };
  // weights: 0 W_e, 1.. ws[i], nh + 1 W_out; wb[m][0] forward, [1] backward
  auto stage = [&](int m, bool transpose) {
    __syncthreads();
    load_b<T, H>(slot, wb + (size_t(m) * 2 + transpose) * H * H);
    __syncthreads();
  };
  auto mat = [&](int m) { return part + size_t(m) * H * H; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  for (int64_t i = tid; i < int64_t(n_mats) * H * H; i += kThreads)
    part[i] = 0.f;
  for (int i = tid; i < n_vecs * H; i += kThreads) vec_s[i] = 0.f;

  const int n_blocks = n_nodes / node_block;
  float acc[H / 8][4];

  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    if (tid == 0) {
      const int lo = first_tile(recv, n_tiles, edge_tile, node_block, b);
      const int hi = first_tile(recv, n_tiles, edge_tile, node_block, b + 1);
      range_s[0] = lo;
      range_s[1] = first_pad_tile(mask, lo, hi, edge_tile);
    }
    __syncthreads();
    const int64_t row_lo = int64_t(range_s[0]) * edge_tile;
    const int64_t row_hi = int64_t(range_s[1]) * edge_tile;
    const int node_lo = b * node_block, node_hi = node_lo + node_block;
    // segmented-sum state of d_dproj column `tid` (threads tid < H)
    int cur = node_lo - 1;
    float sum = 0.f;
    auto flush = [&](int node, float s) {
      if (node >= node_lo && node < node_hi)
        N::store1(d_dproj + int64_t(node) * H + tid, s);
    };
    auto zero_gap = [&](int from, int to) {
      for (int z = max(from, node_lo); z < min(to, node_hi); ++z)
        N::store1(d_dproj + int64_t(z) * H + tid, 0.f);
    };

    for (int64_t r0 = row_lo; r0 < row_hi; r0 += kRows) {
      const int64_t rw = r0 + wrow;
      const int64_t ra = rw + g, rb = rw + g + 8;
      T* e_w = buf(kE) + wrow * LD;
      T* dz_w = buf(kDz) + wrow * LD;
      load_rows<T, H>(e_w, e + rw * H);
      const int na = recv[ra], nb = recv[rb];
      const float ma = N::load1(mask + ra), mb = N::load1(mask + rb);
      if (t == 0) {
        recv_s[wrow + g] = na;
        recv_s[wrow + g + 8] = nb;
        mask_s[wrow + g] = ma;
        mask_s[wrow + g + 8] = mb;
      }
      __syncwarp();

      // ---- forward recompute, as K1 ----
      stage(0, false);
      zero<H>(acc);
      mm<H>(e_w, slot, acc);
      {
        T* a_w = buf(kAct0) + wrow * LD;
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
          N::store2(a_w + g * LD + col, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          N::store2(a_w + (g + 8) * LD + col, fmaxf(v2, 0.f), fmaxf(v3, 0.f));
        }
      }
      __syncwarp();
      for (int i = 0; i < n_hidden; ++i) {
        stage(1 + i, false);
        zero<H>(acc);
        mm<H>(buf(kAct0 + i) + wrow * LD, slot, acc);
        __syncwarp();
        bias_relu_store<T, H>(acc, bs + size_t(i) * H,
                              buf(kAct0 + i + 1) + wrow * LD);
        __syncwarp();
      }
      stage(n_hidden + 1, false);
      zero<H>(acc);
      mm<H>(buf(kAct0 + n_hidden) + wrow * LD, slot, acc);
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const float2 bo = N::load2(b_out + 8 * j + 2 * t);
        acc[j][0] = N::rnd(N::rnd(acc[j][0]) + bo.x);
        acc[j][1] = N::rnd(N::rnd(acc[j][1]) + bo.y);
        acc[j][2] = N::rnd(N::rnd(acc[j][2]) + bo.x);
        acc[j][3] = N::rnd(N::rnd(acc[j][3]) + bo.y);
      }

      // ---- ct = ct_e + mask * ct_agg[recv]; LayerNorm backward ----
      {
        float ct[H / 8][4];
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          const int col = 8 * j + 2 * t;
          const float2 ea = N::load2(ct_e + ra * H + col);
          const float2 eb = N::load2(ct_e + rb * H + col);
          const float2 ga = N::load2(ct_agg + int64_t(na) * H + col);
          const float2 gb = N::load2(ct_agg + int64_t(nb) * H + col);
          ct[j][0] = N::rnd(ea.x + N::rnd(ma * ga.x));
          ct[j][1] = N::rnd(ea.y + N::rnd(ma * ga.y));
          ct[j][2] = N::rnd(eb.x + N::rnd(mb * gb.x));
          ct[j][3] = N::rnd(eb.y + N::rnd(mb * gb.y));
        }
        ln_backward<T, H>(acc, ct, ln_scale, warp_part);
      }
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int col = 8 * j + 2 * t;
        N::store2(dz_w + g * LD + col, acc[j][0], acc[j][1]);
        N::store2(dz_w + (g + 8) * LD + col, acc[j][2], acc[j][3]);
      }
      __syncthreads();
      add_warp_parts<H>(warp_part, vec_s + H);
      add_warp_parts<H>(warp_part + kWarps * H, vec_s + 2 * H);
      column_sum<T, H>(buf(kDz), vec_s);
      weight_grad<T, H>(buf(kAct0 + n_hidden), buf(kDz), mat(n_hidden + 1));

      // ---- output linear and hidden stack, in reverse ----
      stage(n_hidden + 1, true);
      zero<H>(acc);
      mm<H>(dz_w, slot, acc);
      __syncwarp();
      relu_grad_store<T, H>(acc, buf(kAct0 + n_hidden) + wrow * LD, dz_w);
      __syncthreads();
      for (int i = n_hidden - 1; i >= 0; --i) {
        column_sum<T, H>(buf(kDz), vec_s + size_t(3 + i) * H);
        weight_grad<T, H>(buf(kAct0 + i), buf(kDz), mat(1 + i));
        stage(1 + i, true);
        zero<H>(acc);
        mm<H>(dz_w, slot, acc);
        __syncwarp();
        relu_grad_store<T, H>(acc, buf(kAct0 + i) + wrow * LD, dz_w);
        __syncthreads();
      }

      // ---- dz is d(h0) = d_sg: dW_e, d_sg, d_e, d_dproj ----
      weight_grad<T, H>(buf(kE), buf(kDz), mat(0));
      store_rows<T, H>(d_sg + rw * H, dz_w);
      stage(0, true);
      zero<H>(acc);
      mm<H>(dz_w, slot, acc);
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 ea = N::load2(ct_e + ra * H + col);
        const float2 eb = N::load2(ct_e + rb * H + col);
        const float2 ga = N::load2(ct_agg + int64_t(na) * H + col);
        const float2 gb = N::load2(ct_agg + int64_t(nb) * H + col);
        const float c0 = N::rnd(ea.x + N::rnd(ma * ga.x));
        const float c1 = N::rnd(ea.y + N::rnd(ma * ga.y));
        const float c2 = N::rnd(eb.x + N::rnd(mb * gb.x));
        const float c3 = N::rnd(eb.y + N::rnd(mb * gb.y));
        N::store2(d_e + ra * H + col, N::rnd(c0 + N::rnd(acc[j][0])),
                  N::rnd(c1 + N::rnd(acc[j][1])));
        N::store2(d_e + rb * H + col, N::rnd(c2 + N::rnd(acc[j][2])),
                  N::rnd(c3 + N::rnd(acc[j][3])));
      }
      // d_dproj: segmented sum of mask * dz down the chunk's sorted rows
      if (tid < H) {
        const T* dz_all = buf(kDz);
        for (int r = 0; r < kRows; ++r) {
          const int n = recv_s[r];
          if (n != cur) {
            flush(cur, sum);
            zero_gap(cur + 1, n);
            cur = n;
            sum = 0.f;
          }
          sum += mask_s[r] * N::load1(dz_all + r * LD + tid);
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
  float* vec_part = part + int64_t(n_mats) * H * H;
  for (int i = tid; i < n_vecs * H; i += kThreads) vec_part[i] = vec_s[i];
}

template <typename T, int H>
cudaError_t plan(int64_t n_nodes, int n_hidden, int node_block, BwdPlan* p) {
  return plan_bwd<T, H>(n_hidden + 3, n_hidden + 2, n_hidden + 3,
                        n_nodes / node_block, p);
}

template <typename T, int H>
cudaError_t launch(const void* e, const void* sg, const void* d_proj,
                   const void* mask, const int* recv, const void* wb,
                   const void* bs, const void* b_out,
                   const void* ln_scale, const void* ct_e,
                   const void* ct_agg, void* d_e, void* d_sg, void* d_dproj,
                   void* dw, void* workspace, int64_t ws_bytes,
                   int64_t n_edges, int64_t n_nodes, int n_hidden,
                   int node_block, int edge_tile, cudaStream_t stream) {
  BwdPlan p;
  cudaError_t err = plan<T, H>(n_nodes, n_hidden, node_block, &p);
  if (err != cudaSuccess) return err;
  if (ws_bytes < p.ws_bytes || p.grid == 0) return cudaErrorInvalidValue;
  auto kernel = fused_edge_bwd_kernel<T, H>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(p.smem));
  if (err != cudaSuccess) return err;
  float* part = static_cast<float*>(workspace);
  T* scratch = reinterpret_cast<T*>(static_cast<char*>(workspace) +
                                    int64_t(p.grid) * p.part_len * 4);
  kernel<<<p.grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(e), static_cast<const T*>(sg),
      static_cast<const T*>(d_proj), static_cast<const T*>(mask), recv,
      static_cast<const T*>(wb), static_cast<const T*>(bs),
      static_cast<const T*>(b_out), static_cast<const T*>(ln_scale),
      static_cast<const T*>(ct_e), static_cast<const T*>(ct_agg),
      static_cast<T*>(d_e), static_cast<T*>(d_sg), static_cast<T*>(d_dproj),
      part, scratch, int(n_edges / edge_tile), int(n_nodes), n_hidden,
      node_block, edge_tile, p.n_smem, p.part_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_fill_pad_tiles<T>(
      static_cast<const T*>(mask), int(n_edges / edge_tile), edge_tile, H,
      static_cast<T*>(d_e), static_cast<const T*>(ct_e), static_cast<T*>(d_sg),
      nullptr, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, p.grid, p.part_len, static_cast<float*>(dw),
                       stream);
}

}  // namespace

#define AERO_DISPATCH(CASE)                                   \
  if (dtype == 0 && h == 128) CASE(float, 128);               \
  if (dtype == 0 && h == 64) CASE(float, 64);                 \
  if (dtype == 1 && h == 128) CASE(__nv_bfloat16, 128);       \
  if (dtype == 1 && h == 64) CASE(__nv_bfloat16, 64);         \
  return int(cudaErrorInvalidValue)

// Bytes of device workspace aero_fused_edge_bwd needs. Returns a
// cudaError_t (0 = success).
extern "C" int aero_fused_edge_bwd_workspace(int64_t n_nodes, int h,
                                             int n_hidden, int node_block,
                                             int dtype, int64_t* ws_bytes) {
#define AERO_WS_CASE(T, H)                                        \
  {                                                               \
    BwdPlan p;                                                    \
    const cudaError_t err = plan<T, H>(n_nodes, n_hidden, node_block, &p); \
    *ws_bytes = p.ws_bytes;                                       \
    return int(err);                                              \
  }
  AERO_DISPATCH(AERO_WS_CASE);
#undef AERO_WS_CASE
}

// dtype: 0 = float32, 1 = bfloat16. wb: the weights [W_e, ws[0..nh),
// W_out] each twice, [n][2][h][h], laid out as the products read them
// (ops/_build.py mma_b_operands). dw receives the fp32 weight gradients
// [dW_e, dWs[0..nh), dW_out] ([h, h] each) then [db_out, dscale, dbias,
// dbs[0..nh)] ([h] each). Returns a cudaError_t (0 = success).
extern "C" int aero_fused_edge_bwd(
    const void* e, const void* sg, const void* d_proj, const void* mask,
    const void* receivers, const void* wb, const void* bs, const void* b_out,
    const void* ln_scale, const void* ct_e, const void* ct_agg, void* d_e,
    void* d_sg,
    void* d_dproj, void* dw, void* workspace, int64_t ws_bytes,
    int64_t n_edges, int64_t n_nodes, int h, int n_hidden, int node_block,
    int edge_tile, int dtype, void* stream) {
  const int* recv = static_cast<const int*>(receivers);
  auto s = static_cast<cudaStream_t>(stream);
#define AERO_BWD_CASE(T, H)                                                 \
  return int(launch<T, H>(e, sg, d_proj, mask, recv, wb, bs, b_out,          \
                          ln_scale, ct_e, ct_agg, d_e, d_sg, d_dproj,        \
                          dw, workspace, ws_bytes, n_edges, n_nodes,        \
                          n_hidden, node_block, edge_tile, s))
  AERO_DISPATCH(AERO_BWD_CASE);
#undef AERO_BWD_CASE
}
