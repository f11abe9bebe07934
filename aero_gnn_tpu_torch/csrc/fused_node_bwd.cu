// Fused node block + residual, backward (kernel K4 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_node.py _fnl_bwd (pallas_call of
// _make_bwd_kernel). The VJP of K3 (fused_node_fwd.cu) for the cotangent ct
// of x' = x + LayerNorm(MLP([x, agg])): per node row it recomputes
//
//   a0 = relu(x @ W1x + agg @ W1a + b1)   (the two products summed in fp32
//                                          before rounding, as K3 and the
//                                          TPU kernel, pallas_node.py:212)
//   a(i+1) = relu(a(i) @ ws[i] + bs[i]);  d = a(nh) @ W_out + b_out
//
// with the LayerNorm statistics in fp32, then (pallas_node.py:226-265)
//
//   d_d  = LayerNorm backward of ct;  dz = (d_d @ W_out^T) * (a(nh) > 0)
//   dz   = (dz @ ws[i]^T) * (a(i) > 0)           (hidden stack, reverse)
//   d_x  = ct + dz @ W1x^T   (the residual),   d_agg = dz @ W1a^T
//
// and the fp32 weight gradients dW1x = x^T dz, dW1a = agg^T dz, db1, dWs,
// dbs, dW_out, db_out, dscale, dbias.
//
// Schedule: rows in chunks of 128, one CTA per SM, persistent over chunks.
// Buffers, weight slot and the deterministic weight-gradient partials are
// those of K2 (chain_bwd.cuh); bf16 h = 128 with two hidden layers keeps
// five of its six buffers in shared memory and one in device scratch.
//
// Bound on the H100 (flagship N = 66,048, h = 128, 2 hidden): 3 x 5
// products of 2*N*h^2 = 32 GFLOP per launch; bytes: read x, agg, ct, write
// d_x, d_agg (~85 MB in bf16, 0.025 ms at 3.35 TB/s). bf16: the
// operations bound it (0.033 ms at the tensor-core peak); fp32: FFMA
// bounds it (0.49 ms).

#include "chain_bwd.cuh"

namespace {

using namespace chain;

constexpr int kDz = 0;    // buffer: running cotangent dz (and d_d)
constexpr int kX = 1;     // buffer: x rows
constexpr int kAgg = 2;   // buffer: agg rows
constexpr int kAct0 = 3;  // buffers: a(0) .. a(nh)

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
fused_node_bwd_kernel(const T* __restrict__ x, const T* __restrict__ agg,
                      const T* __restrict__ wb, const T* __restrict__ b1,
                      const T* __restrict__ bs, const T* __restrict__ b_out,
                      const T* __restrict__ ln_scale,
                      const T* __restrict__ ct, T* __restrict__ d_x,
                      T* __restrict__ d_agg, float* __restrict__ part_all,
                      T* scratch, int64_t n_rows, int n_hidden, int n_smem,
                      int64_t part_len) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_bufs = n_hidden + 4, n_mats = n_hidden + 3;
  const int n_vecs = n_hidden + 4;
  T* slot = reinterpret_cast<T*>(smem_raw);
  T* sbuf = slot + H * LD;
  float* warp_part = reinterpret_cast<float*>(
      sbuf + size_t(n_smem) * kRows * LD) + 2 * kRows;  // past recv/mask
  // db_out, dscale, dbias, db1, dbs[0..nh)
  float* vec_s = warp_part + 2 * kWarps * H;
  T* gbuf = scratch + size_t(blockIdx.x) * (n_bufs - n_smem) * kRows * LD;
  float* part = part_all + int64_t(blockIdx.x) * part_len;

  auto buf = [&](int b) -> T* {
    return b < n_smem ? sbuf + size_t(b) * kRows * LD
                      : gbuf + size_t(b - n_smem) * kRows * LD;
  };
  // weights: 0 W1x, 1 W1a, 2.. ws[i], nh + 2 W_out; wb[m][0] forward,
  // wb[m][1] backward
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
  float acc[H / 8][4];

  for (int64_t r0 = int64_t(blockIdx.x) * kRows; r0 < n_rows;
       r0 += int64_t(gridDim.x) * kRows) {
    const int64_t rw = r0 + wrow;
    const int64_t ra = rw + g, rb = rw + g + 8;
    T* x_w = buf(kX) + wrow * LD;
    T* agg_w = buf(kAgg) + wrow * LD;
    T* dz_w = buf(kDz) + wrow * LD;
    load_rows<T, H>(x_w, x + rw * H);
    load_rows<T, H>(agg_w, agg + rw * H);
    __syncwarp();

    // ---- forward recompute, as K3 ----
    zero<H>(acc);
    stage(0, false);
    mm<H>(x_w, slot, acc);
    stage(1, false);
    mm<H>(agg_w, slot, acc);
    bias_relu_store<T, H>(acc, b1, buf(kAct0) + wrow * LD);
    __syncwarp();
    for (int i = 0; i < n_hidden; ++i) {
      stage(2 + i, false);
      zero<H>(acc);
      mm<H>(buf(kAct0 + i) + wrow * LD, slot, acc);
      __syncwarp();
      bias_relu_store<T, H>(acc, bs + size_t(i) * H,
                            buf(kAct0 + i + 1) + wrow * LD);
      __syncwarp();
    }
    stage(n_hidden + 2, false);
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

    // ---- LayerNorm backward ----
    {
      float c[H / 8][4];
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 ca = N::load2(ct + ra * H + col);
        const float2 cb = N::load2(ct + rb * H + col);
        c[j][0] = ca.x;
        c[j][1] = ca.y;
        c[j][2] = cb.x;
        c[j][3] = cb.y;
      }
      ln_backward<T, H>(acc, c, ln_scale, warp_part);
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
    weight_grad<T, H>(buf(kAct0 + n_hidden), buf(kDz), mat(n_hidden + 2));

    // ---- output linear and hidden stack, in reverse ----
    stage(n_hidden + 2, true);
    zero<H>(acc);
    mm<H>(dz_w, slot, acc);
    __syncwarp();
    relu_grad_store<T, H>(acc, buf(kAct0 + n_hidden) + wrow * LD, dz_w);
    __syncthreads();
    for (int i = n_hidden - 1; i >= 0; --i) {
      column_sum<T, H>(buf(kDz), vec_s + size_t(4 + i) * H);
      weight_grad<T, H>(buf(kAct0 + i), buf(kDz), mat(2 + i));
      stage(2 + i, true);
      zero<H>(acc);
      mm<H>(dz_w, slot, acc);
      __syncwarp();
      relu_grad_store<T, H>(acc, buf(kAct0 + i) + wrow * LD, dz_w);
      __syncthreads();
    }

    // ---- first (split) linear: dW1x, dW1a, db1, d_x, d_agg ----
    column_sum<T, H>(buf(kDz), vec_s + 3 * H);
    weight_grad<T, H>(buf(kX), buf(kDz), mat(0));
    weight_grad<T, H>(buf(kAgg), buf(kDz), mat(1));
    stage(0, true);
    zero<H>(acc);
    mm<H>(dz_w, slot, acc);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 ca = N::load2(ct + ra * H + col);
      const float2 cb = N::load2(ct + rb * H + col);
      N::store2(d_x + ra * H + col, N::rnd(ca.x + N::rnd(acc[j][0])),
                N::rnd(ca.y + N::rnd(acc[j][1])));
      N::store2(d_x + rb * H + col, N::rnd(cb.x + N::rnd(acc[j][2])),
                N::rnd(cb.y + N::rnd(acc[j][3])));
    }
    stage(1, true);
    zero<H>(acc);
    mm<H>(dz_w, slot, acc);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      N::store2(d_agg + ra * H + col, acc[j][0], acc[j][1]);
      N::store2(d_agg + rb * H + col, acc[j][2], acc[j][3]);
    }
    __syncthreads();
  }
  __syncthreads();
  float* vec_part = part + int64_t(n_mats) * H * H;
  for (int i = tid; i < n_vecs * H; i += kThreads) vec_part[i] = vec_s[i];
}

template <typename T, int H>
cudaError_t plan(int64_t n_rows, int n_hidden, BwdPlan* p) {
  return plan_bwd<T, H>(n_hidden + 4, n_hidden + 3, n_hidden + 4,
                        n_rows / kRows, p);
}

template <typename T, int H>
cudaError_t launch(const void* x, const void* agg, const void* wb,
                   const void* b1, const void* bs, const void* b_out,
                   const void* ln_scale, const void* ct, void* d_x,
                   void* d_agg, void* dw, void* workspace, int64_t ws_bytes,
                   int64_t n_rows, int n_hidden, cudaStream_t stream) {
  BwdPlan p;
  cudaError_t err = plan<T, H>(n_rows, n_hidden, &p);
  if (err != cudaSuccess) return err;
  if (ws_bytes < p.ws_bytes || p.grid == 0) return cudaErrorInvalidValue;
  auto kernel = fused_node_bwd_kernel<T, H>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(p.smem));
  if (err != cudaSuccess) return err;
  float* part = static_cast<float*>(workspace);
  T* scratch = reinterpret_cast<T*>(static_cast<char*>(workspace) +
                                    int64_t(p.grid) * p.part_len * 4);
  kernel<<<p.grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(agg),
      static_cast<const T*>(wb), static_cast<const T*>(b1),
      static_cast<const T*>(bs), static_cast<const T*>(b_out),
      static_cast<const T*>(ln_scale),
      static_cast<const T*>(ct), static_cast<T*>(d_x), static_cast<T*>(d_agg),
      part, scratch, n_rows, n_hidden, p.n_smem, p.part_len);
  err = cudaGetLastError();
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

// Bytes of device workspace aero_fused_node_bwd needs. Returns a
// cudaError_t (0 = success).
extern "C" int aero_fused_node_bwd_workspace(int64_t n_rows, int h,
                                             int n_hidden, int dtype,
                                             int64_t* ws_bytes) {
#define AERO_WS_CASE(T, H)                                    \
  {                                                           \
    BwdPlan p;                                                \
    const cudaError_t err = plan<T, H>(n_rows, n_hidden, &p); \
    *ws_bytes = p.ws_bytes;                                   \
    return int(err);                                          \
  }
  AERO_DISPATCH(AERO_WS_CASE);
#undef AERO_WS_CASE
}

// dtype: 0 = float32, 1 = bfloat16; n_rows % 128 == 0. wb: the weights
// [W1x, W1a, ws[0..nh), W_out] each twice, [n][2][h][h], laid out as the
// products read them (ops/_build.py mma_b_operands). dw receives the fp32
// weight gradients [dW1x, dW1a, dWs[0..nh), dW_out] ([h, h] each) then
// [db_out, dscale, dbias, db1, dbs[0..nh)] ([h] each). Returns a
// cudaError_t (0 = success).
extern "C" int aero_fused_node_bwd(
    const void* x, const void* agg, const void* wb, const void* b1,
    const void* bs, const void* b_out, const void* ln_scale, const void* ct,
    void* d_x,
    void* d_agg, void* dw, void* workspace, int64_t ws_bytes, int64_t n_rows,
    int h, int n_hidden, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define AERO_BWD_CASE(T, H)                                                \
  return int(launch<T, H>(x, agg, wb, b1, bs, b_out, ln_scale, ct, d_x,     \
                          d_agg, dw, workspace, ws_bytes,                   \
                          n_rows, n_hidden, s))
  AERO_DISPATCH(AERO_BWD_CASE);
#undef AERO_BWD_CASE
}
