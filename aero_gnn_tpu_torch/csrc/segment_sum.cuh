// The helpers and constants of the sorted segment sums' first schedule,
// which K5 and K7 ran before segment_rows.cuh and segment_bulk.cuh and
// which K10 (segment_sum_weighted2.cu) still runs; only K10 uses this file
// now. K5 and K7 keep that schedule's order and arithmetic (fp32 sums in
// stream order, the K7 weight rounded to the data's type first, one
// rounding per output row), so K10 still matches two K7 launches bit for
// bit.
//
// Schedule: one CTA per block of kNodes nodes. Thread 0 finds the block's
// row range by binary search on the sorted ids (lower_bound); the range's
// ids and weights are staged in shared memory kTile at a time; each thread
// owns one column and walks the range in order, issuing the data loads of
// kUnroll rows before it adds them. Every output row of the block, empty
// nodes included (exact zeros), is written by that CTA alone: no atomics.
// The TPU kernels accumulate across tiles in the output dtype; these
// accumulate in fp32 (a known difference by design).
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

}  // namespace
