// Fused node block + residual, forward (kernel K3 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_node.py fused_node_layer ->
// _fused_node_fwd (pallas_call of _make_fwd_kernel). Computes its reference
// composition _equiv for the square ReLU chain that nn/blocks.py
// _fused_node_ok admits, per node row:
//
//   z  = relu(x @ W1x + agg @ W1a + b1)     (concat first linear, split)
//   z  = relu(z @ ws[i] + bs[i])            (i < n_hidden)
//   d  = z @ W_out + b_out
//   x' = x + LayerNorm(d)                   (fp32 stats, eps 1e-5)
//
// As in the TPU kernel, x @ W1x + agg @ W1a is summed in fp32 before the
// first rounding to the compute type (the plain version rounds each product
// first); every later rounding point matches the plain version.
//
// Schedule: a dense row-block chain. Each CTA (persistent, one per SM)
// takes chunks of 128 rows; the chain runs in shared memory and registers
// with the weights resident when they fit (bf16: 5 x 128 x 128 weights plus
// one activation buffer, 209 KB) and streamed per stage otherwise (fp32).
// No reductions cross rows, so the result is deterministic.
//
// Bound on the H100 (flagship N = 66,048, h = 128, 2 hidden): 5 products of
// 2*N*h^2 = 10.8 GFLOP per launch. In bf16 the bytes (read x, agg; write x':
// ~51 MB) bound it; in fp32 the FFMA rate bounds it (no TF32).

#include "chain.cuh"

namespace {

using namespace chain;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
fused_node_fwd_kernel(const T* __restrict__ x, const T* __restrict__ agg,
                      const T* __restrict__ w1x, const T* __restrict__ w1a,
                      const T* __restrict__ b1, const T* __restrict__ ws,
                      const T* __restrict__ bs, const T* __restrict__ w_out,
                      const T* __restrict__ b_out,
                      const T* __restrict__ ln_scale,
                      const T* __restrict__ ln_bias, T* __restrict__ out,
                      int64_t n_rows, int n_hidden, int resident) {
  using N = Num<T>;
  constexpr int LD = Layout<T, H>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_mats = n_hidden + 3;
  T* wbuf = reinterpret_cast<T*>(smem_raw);
  T* act = wbuf + size_t(resident ? n_mats : 1) * H * LD;

  auto weight = [&](int m) -> const T* {
    if (m == 0) return w1x;
    if (m == 1) return w1a;
    return m <= n_hidden + 1 ? ws + size_t(m - 2) * H * H : w_out;
  };
  auto slot = [&](int m) -> const T* {
    return resident ? wbuf + size_t(m) * H * LD : wbuf;
  };
  auto stage = [&](int m) {
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

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* my_act = act + warp * 16 * LD;
  float acc[H / 8][4];

  for (int64_t r0 = int64_t(blockIdx.x) * kRows; r0 < n_rows;
       r0 += int64_t(gridDim.x) * kRows) {
    const int64_t rw = r0 + warp * 16;
    const int64_t ra = rw + g, rb = rw + g + 8;

    zero<H>(acc);
    load_rows<T, H>(my_act, x + rw * H);
    __syncwarp();
    stage(0);
    mm<H>(my_act, slot(0), acc);
    __syncwarp();
    load_rows<T, H>(my_act, agg + rw * H);
    __syncwarp();
    stage(1);
    mm<H>(my_act, slot(1), acc);
    __syncwarp();
    bias_relu_store<T, H>(acc, b1, my_act);
    __syncwarp();

    for (int i = 0; i < n_hidden; ++i) {
      zero<H>(acc);
      stage(2 + i);
      mm<H>(my_act, slot(2 + i), acc);
      __syncwarp();
      bias_relu_store<T, H>(acc, bs + size_t(i) * H, my_act);
      __syncwarp();
    }

    zero<H>(acc);
    stage(n_hidden + 2);
    mm<H>(my_act, slot(n_hidden + 2), acc);
    __syncwarp();
    bias_layer_norm<T, H>(acc, b_out, ln_scale, ln_bias);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 xa = N::load2(x + ra * H + col);
      const float2 xb = N::load2(x + rb * H + col);
      N::store2(out + ra * H + col, N::rnd(xa.x + acc[j][0]),
                N::rnd(xa.y + acc[j][1]));
      N::store2(out + rb * H + col, N::rnd(xb.x + acc[j][2]),
                N::rnd(xb.y + acc[j][3]));
    }
  }
}

template <typename T, int H>
cudaError_t launch(const void* x, const void* agg, const void* w1x,
                   const void* w1a, const void* b1, const void* ws,
                   const void* bs, const void* w_out, const void* b_out,
                   const void* ln_scale, const void* ln_bias, void* out,
                   int64_t n_rows, int n_hidden, cudaStream_t stream) {
  int resident = 0;
  size_t smem = 0;
  cudaError_t err = plan_smem<T, H>(n_hidden + 3, 0, &resident, &smem);
  if (err != cudaSuccess) return err;
  auto kernel = fused_node_fwd_kernel<T, H>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const int64_t chunks = n_rows / kRows;
  const int grid = int(chunks < sm_count() ? chunks : sm_count());
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(agg),
      static_cast<const T*>(w1x), static_cast<const T*>(w1a),
      static_cast<const T*>(b1), static_cast<const T*>(ws),
      static_cast<const T*>(bs), static_cast<const T*>(w_out),
      static_cast<const T*>(b_out), static_cast<const T*>(ln_scale),
      static_cast<const T*>(ln_bias), static_cast<T*>(out), n_rows, n_hidden,
      resident);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. n_rows % 128 == 0. Returns a
// cudaError_t (0 = success).
extern "C" int aero_fused_node_fwd(
    const void* x, const void* agg, const void* w1x, const void* w1a,
    const void* b1, const void* ws, const void* bs, const void* w_out,
    const void* b_out, const void* ln_scale, const void* ln_bias, void* out,
    int64_t n_rows, int h, int n_hidden, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define AERO_NODE_CASE(T, H)                                                \
  return int(launch<T, H>(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,       \
                          ln_scale, ln_bias, out, n_rows, n_hidden, s))
  if (dtype == 0 && h == 128) AERO_NODE_CASE(float, 128);
  if (dtype == 0 && h == 64) AERO_NODE_CASE(float, 64);
  if (dtype == 1 && h == 128) AERO_NODE_CASE(__nv_bfloat16, 128);
  if (dtype == 1 && h == 64) AERO_NODE_CASE(__nv_bfloat16, 64);
#undef AERO_NODE_CASE
  return int(cudaErrorInvalidValue);
}
