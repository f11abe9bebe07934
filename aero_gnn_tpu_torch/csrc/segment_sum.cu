// Sorted masked segment sum (kernel K5 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_segment.py segment_agg_pallas ->
// _segment_sum_fwd_pallas (pallas_call of _agg_kernel / _agg_kernel_premask,
// a one-hot MXU contraction per edge tile). Computes
//
//   out[n] = sum over i with ids[i] == n of mask[i] * data[rows[i]]
//
// with ids ascending ([E_s] -> [N, h]), mask optional (ones), rows optional
// (i). On the training path it runs the sender gather's backward: data is
// the cotangent of the gathered rows, rows = sender_perm, ids =
// senders_sorted, so the permutation gather ct[sender_perm] is read here
// instead of being written out as an [E, h] copy first. It also runs K6's
// backward (the receiver stream, no rows, no mask) and the unfused
// aggregation (the receiver stream and the edge mask).
//
// Bound on the H100 (flagship sender stream, E_s ~ 264k rows, h = 128):
// bytes (read data, ids, rows; write out: ~86 MB in bf16, ~26 us at
// 3.35 TB/s). No arithmetic to speak of. The data of the sender stream is
// larger than L2 and read in random row order, so what the schedule must
// give is bytes in flight. A row pointer is built first (segment_rows.cuh
// row_offsets_kernel). Rows that are a whole number of 16-byte pieces up
// to 512 values then go to warps owning node runs that copy whole rows
// into a shared-memory ring by cp.async.bulk, up to 64 rows in flight a
// warp (segment_bulk.cuh); other rows to K7's lane groups, which gather
// rows into registers, eight in flight (segment_rows.cuh), in column
// blocks where the rows are wider than a group takes. The ring measured
// faster than the lane groups on the sender and the receiver stream of
// the H100 (PERF.md). Both give the same bits (fp32 sums in stream order,
// one rounding per row), which are those of the first schedule (one
// thread a column) wherever the data is finite.

#include "segment_bulk.cuh"

namespace {

template <typename T>
cudaError_t launch(const T* data, const int* ids, const T* mask,
                   const int* rows, int* offsets, T* out, int64_t n_ids,
                   int64_t n_nodes, int h, int pad_sink,
                   cudaStream_t stream) {
  if (n_nodes == 0 || h == 0) return cudaSuccess;
  cudaError_t err =
      segrows::launch_offsets(ids, n_ids, n_nodes, offsets, stream);
  if (err != cudaSuccess) return err;
  if (segbulk::takes<T>(h))
    return segbulk::launch_sums<T>(data, ids, mask, rows, offsets, out,
                                   n_nodes, h, pad_sink, stream);
  // lane groups, in column blocks of at most max_cols(h) values
  const int block = segrows::max_cols(h);
  for (int c0 = 0; c0 < h; c0 += block) {
    err = segrows::launch_sums<T, false>(
        data + c0, ids, mask, rows, nullptr, offsets, out + c0, n_ids,
        n_nodes, h - c0 < block ? h - c0 : block, h, pad_sink, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; mask and rows may be null; offsets:
// scratch of n_nodes + 1 ints (the stream's row pointer is built there
// first); pad_sink (0/1) as in segment_rows.cuh. Returns a cudaError_t
// (0 = success).
extern "C" int aero_segment_sum(const void* data, const void* ids,
                                const void* mask, const void* rows,
                                void* offsets, void* out, int64_t n_ids,
                                int64_t n_nodes, int h, int pad_sink,
                                int dtype, void* stream) {
  auto off = static_cast<int*>(offsets);
  const int* id = static_cast<const int*>(ids);
  const int* rw = static_cast<const int*>(rows);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch<float>(static_cast<const float*>(data), id,
                             static_cast<const float*>(mask), rw, off,
                             static_cast<float*>(out), n_ids, n_nodes, h,
                             pad_sink, s));
  if (dtype == 1)
    return int(launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(data), id,
        static_cast<const __nv_bfloat16*>(mask), rw, off,
        static_cast<__nv_bfloat16*>(out), n_ids, n_nodes, h, pad_sink, s));
  return int(cudaErrorInvalidValue);
}
