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
// being written out first. Schedule in segment_sum.cuh (K5's, the weight
// folded into the staged mask).
//
// Bound on the H100 (fine BSMS level of the 65,536-node mesh: 313,344 rows
// before the pad-sink tail, N = 78,336, h = 128): bytes, each input read
// once (the node table, and ids, rows and weights of every live row) and
// the output written once: ~84 MB in fp32, 0.025 ms at 3.35 TB/s (~44 MB,
// 0.013 ms in bf16).

#include "segment_sum.cuh"

// dtype: 0 = float32, 1 = bfloat16; weights fp32; mask and rows may be
// null; pad_sink (0/1) as in segment_sum.cuh. Returns a cudaError_t (0 =
// success).
extern "C" int aero_segment_sum_weighted(const void* data, const void* ids,
                                         const void* weights, const void* mask,
                                         const void* rows, void* out,
                                         int64_t n_ids, int64_t n_nodes, int h,
                                         int pad_sink, int dtype,
                                         void* stream) {
  return launch_dtype<true>(data, ids, mask, rows,
                            static_cast<const float*>(weights), out, n_ids,
                            n_nodes, h, pad_sink, dtype, stream);
}
