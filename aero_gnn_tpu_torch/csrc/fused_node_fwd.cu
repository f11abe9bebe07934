// Fused node block + residual, forward (kernel K3 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_node.py fused_node_layer ->
// _fused_node_fwd (pallas_call of _make_fwd_kernel). Computes its reference
// composition _equiv for the square ReLU chain that nn/blocks.py
// _fused_node_ok admits; the device code and its rounding points are in
// node_fwd_rows.cuh.
//
// Bound on the H100 (flagship N = 66,048, h = 128, 2 hidden): 5 products of
// 2*N*h^2 = 10.8 GFLOP per launch. In bf16 the bytes (read x, agg; write x':
// ~51 MB) bound it; in fp32 the FFMA rate bounds it (no TF32). The schedule
// before this one (a CTA-wide activation buffer in shared memory, every
// product's A and B operands read from it by scalar loads, the fp32
// weights restaged between CTA barriers) ran at 10 % of the bf16 bound and
// 33 % of the fp32 one. This one keeps the bf16 chain in registers with
// the weights resident and runs the fp32 products on a register-blocked
// tile with the weights streamed one product ahead.

#include "node_fwd_rows.cuh"

namespace {

template <typename T>
int dispatch(const void* x, const void* agg, const void* w1x,
             const void* w1a, const void* b1, const void* ws, const void* bs,
             const void* w_out, const void* b_out, const void* ln_scale,
             const void* ln_bias, void* out, int64_t n_rows, int h,
             int n_hidden, int grid, int resident, cudaStream_t stream) {
  const chain::NodeFwdArgs<T> a{
      static_cast<const T*>(x), static_cast<const T*>(agg),
      static_cast<const T*>(w1x), static_cast<const T*>(w1a),
      static_cast<const T*>(b1), static_cast<const T*>(ws),
      static_cast<const T*>(bs), static_cast<const T*>(w_out),
      static_cast<const T*>(b_out), static_cast<const T*>(ln_scale),
      static_cast<const T*>(ln_bias), static_cast<T*>(out), n_rows,
      n_hidden, 0};
  if (h == 128)
    return int(chain::launch_node_fwd_rows<T, 128>(a, grid, resident, stream));
  if (h == 64)
    return int(chain::launch_node_fwd_rows<T, 64>(a, grid, resident, stream));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; h 64 or 128; n_rows % 128 == 0. The
// weights as they lie ([in][out]; ws [n_hidden][h][h]). grid and resident
// (the weights kept in shared memory, else streamed): ops/hopper_node.py
// node_fwd_plan. Returns a cudaError_t (0 = success).
extern "C" int aero_fused_node_fwd(
    const void* x, const void* agg, const void* w1x, const void* w1a,
    const void* b1, const void* ws, const void* bs, const void* w_out,
    const void* b_out, const void* ln_scale, const void* ln_bias, void* out,
    int64_t n_rows, int h, int n_hidden, int grid, int resident, int dtype,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                           ln_scale, ln_bias, out, n_rows, h, n_hidden, grid,
                           resident, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, agg, w1x, w1a, b1, ws, bs, w_out,
                                   b_out, ln_scale, ln_bias, out, n_rows, h,
                                   n_hidden, grid, resident, s);
  return int(cudaErrorInvalidValue);
}
