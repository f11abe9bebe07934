// Row gather of an aligned receiver stream (kernel K6 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_segment.py gather_receivers_pallas ->
// _gather_fwd_pallas (pallas_call of _gather_kernel, a transposed one-hot
// MXU product of each 1024-row edge tile against its 256-node block).
// Computes
//
//   out[e] = nodes[idx[e]]      for every row e: [N, h] -> [E, h]
//
// The one-hot product is an exact copy on the aligned layout (every row's
// receiver lies in its tile's node block), so this kernel copies bytes:
// the output is bit-equal to index_select whatever the dtype.
//
// Bound on the H100: bytes (read the node table and idx once, write
// [E, h]: ~170 MB in fp32 on the flagship MGN's tight graph, E = 264,192,
// N = 66,048, h = 128, 0.051 ms at 3.35 TB/s). No arithmetic.
//
// Design: the rows are spread over the whole grid, not one CTA per node
// block, so the pad-sink tail of a Loader batch (whose rows all read the
// last node) costs only its own bytes. Each thread copies 16-byte vectors
// (2-byte words when a row's width is not a multiple of 16), kUnroll of
// them in flight, neighbouring threads on neighbouring addresses of one
// row; receiver-sorted idx makes neighbouring rows read the same node row,
// which stays in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vector loads in flight per thread

// out[i] = nodes[idx[i / vpr] * vpr + i % vpr] over the E * vpr vectors of
// the output (vpr vectors of V per row; E * vpr < 2^31, checked by the
// wrapper).
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ nodes, const int* __restrict__ idx,
                   V* __restrict__ out, uint32_t total, uint32_t vpr) {
  const uint32_t step = gridDim.x * kThreads * kUnroll;
  for (uint32_t base = blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < total; base += step) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = base + u * kThreads;
      if (i < total) {
        const uint32_t r = i / vpr;
        v[u] = nodes[int64_t(idx[r]) * vpr + (i - r * vpr)];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = base + u * kThreads;
      if (i < total) out[i] = v[u];
    }
  }
}

template <typename V>
cudaError_t launch(const void* nodes, const int* idx, void* out,
                   int64_t n_rows, int64_t row_bytes, cudaStream_t stream) {
  const int64_t vpr = row_bytes / int64_t(sizeof(V));
  const int64_t total = n_rows * vpr;
  if (total == 0) return cudaSuccess;
  if (total >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  const int64_t per_block = int64_t(kThreads) * kUnroll;
  const int64_t grid = (total + per_block - 1) / per_block;
  gather_rows_kernel<V><<<unsigned(grid), kThreads, 0, stream>>>(
      static_cast<const V*>(nodes), idx, static_cast<V*>(out),
      uint32_t(total), uint32_t(vpr));
  return cudaGetLastError();
}

}  // namespace

// row_bytes: the width of one row in bytes (h times the element size), a
// multiple of 2; rows of a multiple of 16 bytes are copied in 16-byte
// vectors (the wrapper passes 16-byte aligned tensors), others in 2-byte
// words. Returns a cudaError_t (0 = success).
extern "C" int aero_gather_rows(const void* nodes, const void* idx, void* out,
                                int64_t n_rows, int64_t row_bytes,
                                void* stream) {
  const int* id = static_cast<const int*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0)
    return int(launch<uint4>(nodes, id, out, n_rows, row_bytes, s));
  if (row_bytes % 2 == 0)
    return int(launch<uint16_t>(nodes, id, out, n_rows, row_bytes, s));
  return int(cudaErrorInvalidValue);
}
