// Weighted sorted segment sum (kernel K7 of the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_segment.py segment_agg_weighted_pallas
// -> _segment_sum_weighted_fwd (pallas_call of _agg_kernel_premask_weighted,
// a one-hot MXU contraction whose select value is the edge weight).
// Computes
//
//   out[n] = sum over i with ids[i] == n of mask[i] * w[i] * data[rows[i]]
//
// with ids ascending ([E] -> [N, h]), w fp32 rounded to the data's type
// before the product (the TPU kernel's where(..., w, 0).astype(msgs.dtype)),
// mask and rows optional. On the BSMS path it runs the WeightedEdgeConv of
// every hierarchy transfer: data = the node features, rows = senders, ids
// = receivers, w = conv_edge (or its reverse-edge permutation for the
// adjoint), so the [E, h] sender gather x[senders] is read here instead of
// being written out first.
//
// Bound on the H100 (fine BSMS level of the 65,536-node mesh: 313,344 rows
// before the pad-sink tail, N = 78,336, h = 128): bytes, each input read
// once (the node table, and ids, rows and weights of every live row) and
// the output written once: ~84 MB in fp32, 0.025 ms at 3.35 TB/s (~44 MB,
// 0.013 ms in bf16). The row gathers are what the schedule serves
// (segment_rows.cuh): a row pointer built first, then lane groups owning
// runs of nodes read each row as 4-value vectors with eight gathers in
// flight, their row indices and weights in registers, rows of weight 0
// not read, no shared memory and no CTA barrier. The sums keep the earlier
// schedule's order and arithmetic, so the output is the same bits for a
// finite node table; K10 (segment_sum_weighted2.cu, segment_pair.cuh)
// runs the pair on this machinery and matches two K7 launches bit for
// bit.

#include "segment_rows.cuh"

// dtype: 0 = float32, 1 = bfloat16; weights fp32; mask and rows may be
// null; offsets: scratch of n_nodes + 1 ints (the stream's row pointer is
// built there first); pad_sink (0/1) as in segment_rows.cuh. Returns a
// cudaError_t (0 = success).
extern "C" int aero_segment_sum_weighted(const void* data, const void* ids,
                                         const void* weights, const void* mask,
                                         const void* rows, void* offsets,
                                         void* out, int64_t n_ids,
                                         int64_t n_nodes, int h, int pad_sink,
                                         int dtype, void* stream) {
  auto off = static_cast<int*>(offsets);
  const int* id = static_cast<const int*>(ids);
  const int* rw = static_cast<const int*>(rows);
  const float* w = static_cast<const float*>(weights);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(segrows::launch<float, true>(
        static_cast<const float*>(data), id, static_cast<const float*>(mask),
        rw, w, off, static_cast<float*>(out), n_ids, n_nodes, h, pad_sink,
        s));
  if (dtype == 1)
    return int(segrows::launch<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(data), id,
        static_cast<const __nv_bfloat16*>(mask), rw, w, off,
        static_cast<__nv_bfloat16*>(out), n_ids, n_nodes, h, pad_sink, s));
  return int(cudaErrorInvalidValue);
}
