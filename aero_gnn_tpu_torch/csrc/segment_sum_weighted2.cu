// Two weighted sorted segment sums over one receiver stream (kernel K10 of
// the port).
//
// Replaces: aero_gnn_tpu/ops/pallas_segment.py segment_agg_weighted2_pallas
// (pallas_call at :282 of _agg_kernel_premask_weighted2, :210), the WEC
// pair probe of benchmarks/micro_wec2.py: two message streams with two
// weight vectors over the same receiver layout in one pass, forward only.
//
//   out1[n] = sum over i with ids[i] == n of w1[i] * m1[i]
//   out2[n] = sum over i with ids[i] == n of w2[i] * m2[i]
//
// with ids ascending ([E] -> [N, h]) and each fp32 weight rounded to the
// data's type before the product, as K7 and the TPU kernel do (pad edges
// carry zero weights: there is no mask). Schedule and device code are K7's
// (segment_sum.cuh): one CTA per block of 32 nodes, its row range found by
// one binary search and shared by both streams, ids and both weights staged
// in shared memory 256 rows at a time, each thread owning one column of
// both outputs and carrying both segmented sums in fp32, one rounding per
// output row; every output row of the block written by that CTA alone
// (deterministic, exact zeros for empty nodes). What the pair shares
// against two K7 launches: the search, the id stream and the launch.
//
// Bound on the H100 (micro_wec2's shapes: the flagship MGN graph, E =
// 264,192 rows, N = 66,048, h = 128, bf16): bytes, each input read once
// (m1, m2, ids, w1, w2) and each output written once: ~172 MB, 0.05 ms at
// 3.35 TB/s.

#include "segment_sum.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_weighted2_kernel(const T* __restrict__ m1,
                             const T* __restrict__ m2,
                             const int* __restrict__ ids,
                             const float* __restrict__ w1,
                             const float* __restrict__ w2,
                             T* __restrict__ out1, T* __restrict__ out2,
                             int64_t n_ids, int n_nodes, int h) {
  __shared__ int64_t range_s[2];
  __shared__ int ids_s[kTile];
  __shared__ float w1_s[kTile], w2_s[kTile];
  const int node_lo = blockIdx.x * kNodes;
  const int node_hi = min(node_lo + kNodes, n_nodes);
  if (threadIdx.x == 0) {
    range_s[0] = lower_bound(ids, n_ids, node_lo);
    range_s[1] = lower_bound(ids, n_ids, node_hi);
  }
  __syncthreads();
  const int64_t lo = range_s[0], hi = range_s[1];

  for (int c0 = 0; c0 < h; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    int open = -1;        // node whose sums are being carried
    int next = node_lo;   // first output row not yet written
    float s1 = 0.f, s2 = 0.f;
    auto write = [&](int n, float a, float b) {
      put(out1 + int64_t(n) * h + c, a);
      put(out2 + int64_t(n) * h + c, b);
    };
    for (int64_t base = lo; base < hi; base += kTile) {
      const int cnt = int(min(int64_t(kTile), hi - base));
      __syncthreads();  // the previous tile has been read
      for (int i = threadIdx.x; i < cnt; i += kThreads) {
        ids_s[i] = ids[base + i];
        w1_s[i] = rnd<T>(w1[base + i]);
        w2_s[i] = rnd<T>(w2[base + i]);
      }
      __syncthreads();
      if (c >= h) continue;
      for (int i0 = 0; i0 < cnt; i0 += kUnroll) {
        float v1[kUnroll], v2[kUnroll];  // loads issued before the sums
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = min(i0 + u, cnt - 1);
          const int64_t off = (base + i) * h + c;
          v1[u] = to_f(m1[off]) * w1_s[i];
          v2[u] = to_f(m2[off]) * w2_s[i];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i0 + u >= cnt) break;
          const int n = ids_s[i0 + u];
          if (n != open) {
            if (open >= 0) {
              write(open, s1, s2);
              next = open + 1;
            }
            for (; next < n; ++next) write(next, 0.f, 0.f);
            open = n;
            s1 = s2 = 0.f;
          }
          s1 += v1[u];
          s2 += v2[u];
        }
      }
    }
    if (c < h) {
      if (open >= 0) {
        write(open, s1, s2);
        next = open + 1;
      }
      for (; next < node_hi; ++next) write(next, 0.f, 0.f);
    }
  }
}

template <typename T>
cudaError_t launch_pair(const void* m1, const void* m2, const int* ids,
                        const float* w1, const float* w2, void* out1,
                        void* out2, int64_t n_ids, int64_t n_nodes, int h,
                        cudaStream_t stream) {
  const int64_t grid = (n_nodes + kNodes - 1) / kNodes;
  if (grid == 0 || h == 0) return cudaSuccess;
  segment_sum_weighted2_kernel<T><<<unsigned(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(m1), static_cast<const T*>(m2), ids, w1, w2,
      static_cast<T*>(out1), static_cast<T*>(out2), n_ids, int(n_nodes), h);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (m1, m2, out1, out2); ids int32
// ascending, w1 / w2 fp32. Returns a cudaError_t (0 = success).
extern "C" int aero_segment_sum_weighted2(const void* m1, const void* m2,
                                          const void* ids, const void* w1,
                                          const void* w2, void* out1,
                                          void* out2, int64_t n_ids,
                                          int64_t n_nodes, int h, int dtype,
                                          void* stream) {
  const int* id = static_cast<const int*>(ids);
  auto a = static_cast<const float*>(w1);
  auto b = static_cast<const float*>(w2);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch_pair<float>(m1, m2, id, a, b, out1, out2, n_ids,
                                  n_nodes, h, s));
  if (dtype == 1)
    return int(launch_pair<__nv_bfloat16>(m1, m2, id, a, b, out1, out2,
                                          n_ids, n_nodes, h, s));
  return int(cudaErrorInvalidValue);
}
