// Sorted masked segment sum, optionally weighted: the device code of
// kernel K5 (segment_sum.cu), whose helpers and constants K10
// (segment_sum_weighted2.cu) shares. The weighted instance is the schedule
// K7 ran before segment_rows.cuh; K7 keeps its order and arithmetic, so
// K10 still matches two K7 launches bit for bit.
//
//   out[n] = sum over i with ids[i] == n of mask[i] * w(i) * data[rows[i]]
//
// with ids ascending ([E_s] -> [N, h]), mask optional (ones), rows optional
// (i), w(i) = 1 (K5) or weights[i] rounded to the data's type (K7): a
// template parameter, so K5's code carries nothing of the weights. With
// pad_sink the last node (N - 1) is the pad sink of an aligned stream: its
// rows, the Loader's pad tail, are pad rows adding zero, so the last CTA
// stops its range before them and writes the sink's row as 0.
//
// Schedule: one CTA per block of 32 nodes. Thread 0 finds the block's row
// range by binary search on the sorted ids, so nothing depends on the
// stream being tile-aligned (the sender stream of a graph without a masked
// edge row is not). The range's ids, rows and mask (times the weight) are
// staged in shared memory 256 at a time; each thread owns one column and
// walks the range in order, issuing the data loads of 8 rows before it
// adds them, a segmented row sum carried in fp32 and rounded once per
// output row. Every output row of the block, empty nodes included (exact
// zeros), is written by that CTA alone: no atomics, the same inputs give
// the same bits. The TPU kernels accumulate across tiles in the output
// dtype; these accumulate in fp32 (a known difference by design).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNodes = 32;   // nodes per CTA
constexpr int kTile = 256;   // ids / rows / mask staged in shared memory
constexpr int kUnroll = 8;   // data loads in flight per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ float rnd(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ int64_t lower_bound(const int* __restrict__ ids, int64_t n,
                               int key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ids[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// out[n] = sum over i with ids[i] == n of mask[i] * w(i) * data[rows[i]],
// w(i) = weights[i] rounded to T when kWeighted (K7), else 1 (K5).
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ ids,
                   const T* __restrict__ mask, const int* __restrict__ rows,
                   const float* __restrict__ weights, T* __restrict__ out,
                   int64_t n_ids, int n_nodes, int h, int pad_sink) {
  __shared__ int64_t range_s[2];
  __shared__ int ids_s[kTile], src_s[kTile];
  __shared__ float mask_s[kTile];
  const int node_lo = blockIdx.x * kNodes;
  const int node_hi = min(node_lo + kNodes, n_nodes);
  if (threadIdx.x == 0) {
    const int key_hi = pad_sink && node_hi == n_nodes ? n_nodes - 1 : node_hi;
    range_s[0] = lower_bound(ids, n_ids, node_lo);
    range_s[1] = lower_bound(ids, n_ids, key_hi);
  }
  __syncthreads();
  const int64_t lo = range_s[0], hi = range_s[1];

  for (int c0 = 0; c0 < h; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    int open = -1;        // node whose sum is being carried
    int next = node_lo;   // first output row not yet written
    float sum = 0.f;
    for (int64_t base = lo; base < hi; base += kTile) {
      const int cnt = int(min(int64_t(kTile), hi - base));
      __syncthreads();  // the previous tile has been read
      for (int i = threadIdx.x; i < cnt; i += kThreads) {
        ids_s[i] = ids[base + i];
        src_s[i] = rows ? rows[base + i] : int(base + i);
        const float m = mask ? to_f(mask[base + i]) : 1.f;
        // the weight takes the data's type first, as the TPU kernel casts
        // its weighted one-hot to the message dtype
        mask_s[i] = kWeighted ? m * rnd<T>(weights[base + i]) : m;
      }
      __syncthreads();
      if (c >= h) continue;
      for (int i0 = 0; i0 < cnt; i0 += kUnroll) {
        float v[kUnroll];  // independent loads, issued before the sums
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = min(i0 + u, cnt - 1);
          v[u] = to_f(data[int64_t(src_s[i]) * h + c]) * mask_s[i];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i0 + u >= cnt) break;
          const int n = ids_s[i0 + u];
          if (n != open) {
            if (open >= 0) {
              put(out + int64_t(open) * h + c, sum);
              next = open + 1;
            }
            for (; next < n; ++next) put(out + int64_t(next) * h + c, 0.f);
            open = n;
            sum = 0.f;
          }
          sum += v[u];
        }
      }
    }
    if (c < h) {
      if (open >= 0) {
        put(out + int64_t(open) * h + c, sum);
        next = open + 1;
      }
      for (; next < node_hi; ++next) put(out + int64_t(next) * h + c, 0.f);
    }
  }
}

template <typename T, bool kWeighted>
cudaError_t launch(const void* data, const int* ids, const void* mask,
                   const int* rows, const float* weights, void* out,
                   int64_t n_ids, int64_t n_nodes, int h, int pad_sink,
                   cudaStream_t stream) {
  const int64_t grid = (n_nodes + kNodes - 1) / kNodes;
  if (grid == 0 || h == 0) return cudaSuccess;
  segment_sum_kernel<T, kWeighted><<<unsigned(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(data), ids, static_cast<const T*>(mask), rows,
      weights, static_cast<T*>(out), n_ids, int(n_nodes), h, pad_sink);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
template <bool kWeighted>
int launch_dtype(const void* data, const void* ids, const void* mask,
                 const void* rows, const float* weights, void* out,
                 int64_t n_ids, int64_t n_nodes, int h, int pad_sink,
                 int dtype, void* stream) {
  const int* id = static_cast<const int*>(ids);
  const int* rw = static_cast<const int*>(rows);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch<float, kWeighted>(data, id, mask, rw, weights, out,
                                        n_ids, n_nodes, h, pad_sink, s));
  if (dtype == 1)
    return int(launch<__nv_bfloat16, kWeighted>(
        data, id, mask, rw, weights, out, n_ids, n_nodes, h, pad_sink, s));
  return int(cudaErrorInvalidValue);
}

}  // namespace
