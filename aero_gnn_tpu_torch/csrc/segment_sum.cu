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
// instead of being written out as an [E, h] copy first. Schedule in
// segment_sum.cuh.
//
// Bound on the H100 (flagship sender stream, E_s ~ 270k rows, h = 128):
// bytes (read data, ids, rows; write out: ~86 MB in bf16, ~26 us at
// 3.35 TB/s). No arithmetic to speak of. This version issues one 2- or
// 4-byte load per thread and row (8 in flight), so load latency, not the
// bytes, bounds it.

#include "segment_sum.cuh"

// dtype: 0 = float32, 1 = bfloat16; mask and rows may be null; pad_sink
// (0/1) as in segment_sum.cuh. Returns a cudaError_t (0 = success).
extern "C" int aero_segment_sum(const void* data, const void* ids,
                                const void* mask, const void* rows, void* out,
                                int64_t n_ids, int64_t n_nodes, int h,
                                int pad_sink, int dtype, void* stream) {
  return launch_dtype<false>(data, ids, mask, rows, nullptr, out, n_ids,
                             n_nodes, h, pad_sink, dtype, stream);
}
