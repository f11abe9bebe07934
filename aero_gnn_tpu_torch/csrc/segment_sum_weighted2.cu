// Two weighted sorted segment sums over one receiver stream (kernel K10 of
// the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_segment.py segment_agg_weighted2_pallas
// (pallas_call at :282 of _agg_kernel_premask_weighted2, :210), the WEC
// pair probe of benchmarks/micro_wec2.py: two message streams with two
// weight vectors over the same receiver layout in one pass, forward only.
//
//   out1[n] = sum over i with ids[i] == n of rnd_T(w1[i]) * m1[i]
//   out2[n] = sum over i with ids[i] == n of rnd_T(w2[i]) * m2[i]
//
// with ids ascending ([E] -> [N, h]) and each fp32 weight rounded to the
// data's type before the product, as K7 and the TPU kernel do (pad edges
// carry zero weights: there is no mask).
//
// Bound on the H100 (micro_wec2's shapes: the flagship MGN graph, E =
// 264,192 rows, N = 66,048, h = 128, bf16): bytes, each input read once
// (the rows of m1 and m2 with a weight, ids, w1, w2) and each output
// written once: ~162 MB, 0.048 ms at 3.35 TB/s. The schedule
// (segment_pair.cuh) is K7's lane groups over one row pointer that both
// streams share, one walk of the ids for both sums, each in K7's order and
// arithmetic, so each output is the same bits as a K7 launch on its
// stream.

#include "segment_pair.cuh"

// dtype: 0 = float32, 1 = bfloat16 (m1, m2, out1, out2); ids int32
// ascending, w1 / w2 fp32; offsets: scratch of n_nodes + 1 ints (the
// stream's row pointer is built there first). Returns a cudaError_t
// (0 = success).
extern "C" int aero_segment_sum_weighted2(const void* m1, const void* m2,
                                          const void* ids, const void* w1,
                                          const void* w2, void* offsets,
                                          void* out1, void* out2,
                                          int64_t n_ids, int64_t n_nodes,
                                          int h, int dtype, void* stream) {
  const int* id = static_cast<const int*>(ids);
  auto a = static_cast<const float*>(w1);
  auto b = static_cast<const float*>(w2);
  auto off = static_cast<int*>(offsets);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(segpair::launch<float>(
        static_cast<const float*>(m1), static_cast<const float*>(m2), id, a,
        b, off, static_cast<float*>(out1), static_cast<float*>(out2), n_ids,
        n_nodes, h, s));
  if (dtype == 1)
    return int(segpair::launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(m1),
        static_cast<const __nv_bfloat16*>(m2), id, a, b, off,
        static_cast<__nv_bfloat16*>(out1), static_cast<__nv_bfloat16*>(out2),
        n_ids, n_nodes, h, s));
  return int(cudaErrorInvalidValue);
}
