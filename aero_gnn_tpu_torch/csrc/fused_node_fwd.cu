// Fused node block + residual, forward (kernel K3 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_node.py fused_node_layer ->
// _fused_node_fwd (pallas_call of _make_fwd_kernel). Computes its reference
// composition _equiv for the square ReLU chain that nn/blocks.py
// _fused_node_ok admits; the device code and its rounding points are in
// node_fwd.cuh.
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

#include "node_fwd.cuh"

namespace {

using namespace chain;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
fused_node_fwd_kernel(NodeFwdArgs<T> a, int64_t n_rows, int resident) {
  constexpr int LD = Layout<T, H>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_mats = a.n_hidden + 3;
  const WeightSlots<T, H> w{reinterpret_cast<T*>(smem_raw), resident};
  T* act = w.wbuf + size_t(resident ? n_mats : 1) * H * LD;
  for (int m = 0; m < n_mats; ++m) w.preload(m, a.template weight<H>(m));
  __syncthreads();
  for (int64_t r0 = int64_t(blockIdx.x) * kRows; r0 < n_rows;
       r0 += int64_t(gridDim.x) * kRows)
    node_fwd_chunk<T, H>(a, w, act, r0);
}

template <typename T, int H>
cudaError_t launch(const NodeFwdArgs<T>& a, int64_t n_rows,
                   cudaStream_t stream) {
  int resident = 0;
  size_t smem = 0;
  cudaError_t err = plan_smem<T, H>(a.n_hidden + 3, 0, &resident, &smem);
  if (err != cudaSuccess) return err;
  auto kernel = fused_node_fwd_kernel<T, H>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const int64_t chunks = n_rows / kRows;
  const int grid = int(chunks < sm_count() ? chunks : sm_count());
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(a, n_rows, resident);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* agg, const void* w1x,
             const void* w1a, const void* b1, const void* ws, const void* bs,
             const void* w_out, const void* b_out, const void* ln_scale,
             const void* ln_bias, void* out, int64_t n_rows, int h,
             int n_hidden, cudaStream_t stream) {
  const NodeFwdArgs<T> a{
      static_cast<const T*>(x), static_cast<const T*>(agg),
      static_cast<const T*>(w1x), static_cast<const T*>(w1a),
      static_cast<const T*>(b1), static_cast<const T*>(ws),
      static_cast<const T*>(bs), static_cast<const T*>(w_out),
      static_cast<const T*>(b_out), static_cast<const T*>(ln_scale),
      static_cast<const T*>(ln_bias), static_cast<T*>(out), n_hidden};
  if (h == 128) return int(launch<T, 128>(a, n_rows, stream));
  if (h == 64) return int(launch<T, 64>(a, n_rows, stream));
  return int(cudaErrorInvalidValue);
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
  if (dtype == 0)
    return dispatch<float>(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                           ln_scale, ln_bias, out, n_rows, h, n_hidden, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, agg, w1x, w1a, b1, ws, bs, w_out,
                                   b_out, ln_scale, ln_bias, out, n_rows, h,
                                   n_hidden, s);
  return int(cudaErrorInvalidValue);
}
