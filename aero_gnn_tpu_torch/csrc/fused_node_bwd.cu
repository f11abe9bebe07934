// Fused node block + residual, backward (kernel K4 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_node.py _fnl_bwd (pallas_call of
// _make_bwd_kernel). The VJP of K3 (fused_node_fwd.cu) for the cotangent ct
// of x' = x + LayerNorm(MLP([x, agg])); the device code and its rounding
// points are in node_bwd.cuh.
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

#include "node_bwd.cuh"

namespace {

using namespace chain;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
fused_node_bwd_kernel(NodeBwdArgs<T> a, float* __restrict__ part_all,
                      T* scratch, int64_t n_rows, int n_smem,
                      int64_t part_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_mats = a.n_hidden + 3, n_vecs = a.n_hidden + 4;
  const BwdCta<T, H> c(smem_raw, scratch, a.n_hidden + 4, n_smem);
  float* part = part_all + int64_t(blockIdx.x) * part_len;
  zero_grads<H>(part, n_mats, c.vec_s, n_vecs);
  __syncthreads();
  for (int64_t r0 = int64_t(blockIdx.x) * kRows; r0 < n_rows;
       r0 += int64_t(gridDim.x) * kRows)
    node_bwd_chunk<T, H>(a, c, part, c.vec_s, r0);
  __syncthreads();
  float* vec_part = part + int64_t(n_mats) * H * H;
  for (int i = threadIdx.x; i < n_vecs * H; i += kThreads)
    vec_part[i] = c.vec_s[i];
}

template <typename T, int H>
cudaError_t plan(int64_t n_rows, int n_hidden, BwdPlan* p) {
  return plan_bwd<T, H>(n_hidden + 4, n_hidden + 3, n_hidden + 4,
                        n_rows / kRows, p);
}

template <typename T, int H>
cudaError_t launch(const NodeBwdArgs<T>& a, float* dw, void* workspace,
                   int64_t ws_bytes, int64_t n_rows, cudaStream_t stream) {
  BwdPlan p;
  cudaError_t err = plan<T, H>(n_rows, a.n_hidden, &p);
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
  kernel<<<p.grid, kThreads, p.smem, stream>>>(a, part, scratch, n_rows,
                                                p.n_smem, p.part_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(part, p.grid, p.part_len, dw, stream);
}

template <typename T>
int dispatch(const void* x, const void* agg, const void* wb, const void* b1,
             const void* bs, const void* b_out, const void* ln_scale,
             const void* ct, void* d_x, void* d_agg, void* dw,
             void* workspace, int64_t ws_bytes, int64_t n_rows, int h,
             int n_hidden, cudaStream_t stream) {
  const NodeBwdArgs<T> a{
      static_cast<const T*>(x), static_cast<const T*>(agg),
      static_cast<const T*>(wb), static_cast<const T*>(b1),
      static_cast<const T*>(bs), static_cast<const T*>(b_out),
      static_cast<const T*>(ln_scale), static_cast<const T*>(ct),
      static_cast<T*>(d_x), static_cast<T*>(d_agg), n_hidden};
  auto out = static_cast<float*>(dw);
  if (h == 128)
    return int(launch<T, 128>(a, out, workspace, ws_bytes, n_rows, stream));
  if (h == 64)
    return int(launch<T, 64>(a, out, workspace, ws_bytes, n_rows, stream));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Bytes of device workspace aero_fused_node_bwd needs. Returns a
// cudaError_t (0 = success).
extern "C" int aero_fused_node_bwd_workspace(int64_t n_rows, int h,
                                             int n_hidden, int dtype,
                                             int64_t* ws_bytes) {
  BwdPlan p;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && h == 128) err = plan<float, 128>(n_rows, n_hidden, &p);
  if (dtype == 0 && h == 64) err = plan<float, 64>(n_rows, n_hidden, &p);
  if (dtype == 1 && h == 128)
    err = plan<__nv_bfloat16, 128>(n_rows, n_hidden, &p);
  if (dtype == 1 && h == 64)
    err = plan<__nv_bfloat16, 64>(n_rows, n_hidden, &p);
  *ws_bytes = p.ws_bytes;
  return int(err);
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
    void* d_x, void* d_agg, void* dw, void* workspace, int64_t ws_bytes,
    int64_t n_rows, int h, int n_hidden, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, agg, wb, b1, bs, b_out, ln_scale, ct, d_x,
                           d_agg, dw, workspace, ws_bytes, n_rows, h,
                           n_hidden, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, agg, wb, b1, bs, b_out, ln_scale, ct,
                                   d_x, d_agg, dw, workspace, ws_bytes,
                                   n_rows, h, n_hidden, s);
  return int(cudaErrorInvalidValue);
}
