// Sorted masked segment sum through a per-warp ring of bulk copies: the
// device code of kernel K5 (segment_sum.cu) for rows that are a whole
// number of 16-byte pieces.
//
//   out[n] = sum over i with ids[i] == n of mask[i] * data[rows[i]]
//
// with ids ascending ([E] -> [N, h]), mask optional (ones), rows optional
// (i). With pad_sink the last node (N - 1) is the pad sink of an aligned
// stream: its rows add zero, so they are never walked and its row is
// written as 0.
//
// What bounds it: bytes, and on the sender backward's stream they come from
// device memory: data is the [E, h] edge cotangent (68 MB bf16, 135 MB fp32 at
// the flagship, more than the 50 MB L2), read in the random order of rows =
// sender_perm. So the schedule keeps many rows in flight without holding them
// in registers. Each warp owns a run of kSpan nodes (its rows from the row
// pointer segment_rows.cuh builds) and a ring of two stages of R rows (R = 32
// rows of 256 bytes, 16 of 512, ...; 8 KB a stage) in shared memory. To fill a
// stage, lane k < R holds the id, row index and mask of the next row k of the
// run (loaded while the stage before was in flight), a ballot drops the rows
// of mask 0 (they add +-0, which leaves a sum started at +0 as it is), lane 0
// posts the stage's bytes on its mbarrier and the rows arrive by
// cp.async.bulk, completing on it: without rows, the batch's consecutive rows
// in one copy; with them, one copy a live row. Each filled slot's id and mask
// go to shared memory beside the ring. While one stage's copies are in flight
// the warp sums the other's rows in stream order, each lane 4 values of each
// row (8 bytes of bf16, 16 of fp32), kBatch rows (and their ids and masks, as
// broadcasts) read from shared memory before they are added, in fp32 with the
// mask folded as in segment_rows.cuh, one rounding per output row: the same
// bits as that schedule and as the first one (one thread a column) wherever
// the data is finite.
//
// Where the time goes is the runs of a thousand rows that an aligned stream
// puts on a few nodes (a node block's alignment rows): one warp walks each, so
// their per-row cost, not the bytes, is the critical path. Hence the batch's
// straight-line adds where it stays on one node, no per-row shuffles, a copy a
// batch rather than a copy a row where the rows are consecutive (a lane issues
// its bulk copies one after another), the 128-row skip of masked runs (one
// round trip of mask loads, not four) and the launch order: the node runs at
// the end of the range, where an aligned stream puts its pad nodes' runs,
// first. No CTA barrier, no atomics: every output row, empty nodes included
// (exact zeros), is written by its warp alone.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_rows.cuh"

namespace segbulk {

constexpr int kWarps = 4;             // warps per CTA
constexpr int kSpan = 8;              // nodes per warp
constexpr int kStageBytes = 8192;     // ring bytes per stage and warp
// shared memory: the mbarriers, the slots' ids and masks, then the rings
constexpr int kBarBytes = 128;
constexpr int kHeadBytes = kBarBytes + 2 * 2 * 32 * 4 * kWarps;
constexpr int kMaxKv = 4;             // 4-value vectors per lane and row
constexpr int kBatch = 8;             // rows read from the ring at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this thread's arrival, expecting `bytes` of copies in the phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// generic-proxy reads of shared memory ordered before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Four values of a ring row as fp32 (bf16 widened by its bits).
__device__ __forceinline__ void unpack4(const uint2& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void unpack4(const float4& u, float (&f)[4]) {
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

// Rows per stage for rows of `row_bytes`: up to 32, kStageBytes a stage.
__host__ __device__ inline int stage_rows(int row_bytes) {
  const int r = kStageBytes / row_bytes;
  return r < 32 ? r : 32;
}

template <typename T, int KV>
__global__ void __launch_bounds__(32 * kWarps)
segment_bulk_kernel(const T* __restrict__ data, const int* __restrict__ ids,
                    const T* __restrict__ mask, const int* __restrict__ rows,
                    const int* __restrict__ offsets, T* __restrict__ out,
                    int n_nodes, int h, int pad_sink) {
  using P = segrows::Pack<T, 4>;
  using U = typename P::U;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_bytes = h * int(sizeof(T));
  const int R = stage_rows(row_bytes), nvec = h / 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + 2 * warp;
  // per stage and ring slot: the row's id and mask ([2][32] each)
  int* slot_id = reinterpret_cast<int*>(smem + kBarBytes) + 64 * warp;
  float* slot_m = reinterpret_cast<float*>(smem + kBarBytes) +
                  64 * (kWarps + warp);
  unsigned char* ring = smem + kHeadBytes + size_t(warp) * 2 * R * row_bytes;
  // the last node runs first: an aligned stream puts its longest runs
  // (a thousand pad rows on the first node of a block without an edge) on
  // the pad nodes at the end, and their walk is the kernel's critical path
  const int64_t n0 =
      (int64_t(gridDim.x - 1 - blockIdx.x) * kWarps + warp) * kSpan;
  if (n0 >= n_nodes) return;  // the whole warp
  const int n_walk = pad_sink ? n_nodes - 1 : n_nodes;
  const int node_hi = int(min(n0 + kSpan, int64_t(n_nodes)));
  int bound = 0;  // lane 0: the run's first row, lane 1: its end
  if (lane < 2)
    bound = offsets[min(n0 + lane * kSpan, int64_t(n_walk))];
  const int lo = __shfl_sync(kFull, bound, 0);
  const int cnt = __shfl_sync(kFull, bound, 1) - lo;
  if (lane == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    fence_mbar_init();
  }
  __syncwarp();

  int next = 0;  // the run's first row not yet issued
  // lane k's row of the batch at `at`: its id, source row and mask
  auto load_meta = [&](int at, int& id, int& src, float& m) {
    const int i = at + lane;
    id = src = 0;
    m = 0.f;
    if (lane < R && i < cnt) {
      id = ids[lo + i];
      src = rows ? rows[lo + i] : lo + i;
      m = mask ? segrows::to_f(mask[lo + i]) : 1.f;
    }
  };
  // the next batch's, loaded while this one's copies are in flight
  int pf_at = -1, pf_id = 0, pf_src = 0;
  float pf_m = 0.f;
  // Fill stage st with the run's next R rows, n of its slots holding
  // rows; false when none is left.
  auto issue = [&](int st, int& n) -> bool {
    if (mask) {  // skip runs of 128 masked rows with one round trip
      while (next < cnt) {
        bool any = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = next + 32 * k + lane;
          if (i < cnt) any |= segrows::to_f(mask[lo + i]) != 0.f;
        }
        if (__ballot_sync(kFull, any)) break;
        next += 128;
      }
    }
    if (next >= cnt) return false;
    int id = 0, src = 0;
    float m = 0.f;
    if (pf_at == next) {
      id = pf_id;
      src = pf_src;
      m = pf_m;
    } else {
      load_meta(next, id, src, m);
    }
    pf_at = next + R;
    if (pf_at < cnt) load_meta(pf_at, pf_id, pf_src, pf_m);
    const bool take = m != 0.f;
    const unsigned live = __ballot_sync(kFull, take);
    const int at = next, n_rows = min(R, cnt - at);
    next += R;
    int* sid = slot_id + 32 * st;
    float* sm = slot_m + 32 * st;
    if (!rows) {
      // consecutive rows: the batch in one copy, row k in slot k (a row of
      // mask 0 keeps its slot and is passed over)
      if (lane < n_rows) {
        sid[lane] = id;
        sm[lane] = m;
      }
      n = live ? n_rows : 0;
      if (lane == 0) {
        mbar_expect_tx(bars + st, n * row_bytes);
        if (n) {
          fence_proxy_async();
          bulk_copy(ring + size_t(st) * R * row_bytes,
                    data + int64_t(lo + at) * h, n * row_bytes, bars + st);
        }
      }
      return true;
    }
    // one copy per live row, in the next free slot
    const int slot = __popc(live & ((1u << lane) - 1));
    if (take) {
      sid[slot] = id;
      sm[slot] = m;
    }
    n = __popc(live);
    if (lane == 0) mbar_expect_tx(bars + st, n * row_bytes);
    __syncwarp();
    if (take) {
      fence_proxy_async();
      bulk_copy(ring + size_t(st * R + slot) * row_bytes,
                data + int64_t(src) * h, row_bytes, bars + st);
    }
    return true;
  };

  float sum[KV][4];
  auto write = [&](int node, bool zero) {
#pragma unroll
    for (int kv = 0; kv < KV; ++kv) {
      const int cv = lane + 32 * kv;
      if (cv < nvec) {
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] = zero ? 0.f : sum[kv][e];
        reinterpret_cast<U*>(out + int64_t(node) * h)[cv] = P::pack(f);
      }
    }
  };
  int open = -1;             // node whose sum is being carried
  int node_next = int(n0);   // first output row not yet written
  // Add one ring row (4 values a lane) to the sums in stream order.
  auto add = [&](const U (&v)[KV], float m) {
#pragma unroll
    for (int kv = 0; kv < KV; ++kv) {
      if (lane + 32 * kv < nvec) {
        float f[4];
        unpack4(v[kv], f);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sum[kv][e] = segrows::madd(sum[kv][e], f[e], m);
      }
    }
  };
  // Sum the n slots of stage st (its `use`-th fill) in stream order,
  // kBatch rows at a time: their ids, masks and values read from shared
  // memory first, then added in order (straight through where the batch
  // stays on the open node).
  auto consume = [&](int st, int use, int n) {
    mbar_wait(bars + st, use & 1);
    __syncwarp();  // the slots' ids and masks are visible to every lane
    const unsigned char* base = ring + size_t(st) * R * row_bytes;
    const int* sid = slot_id + 32 * st;
    const float* sm = slot_m + 32 * st;
    for (int k0 = 0; k0 < n; k0 += kBatch) {
      int id[kBatch];
      float m[kBatch];
      U v[kBatch][KV];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        id[u] = sid[min(k0 + u, n - 1)];
        m[u] = sm[min(k0 + u, n - 1)];
        const U* row = reinterpret_cast<const U*>(
            base + size_t(k0 + u) * row_bytes);
#pragma unroll
        for (int kv = 0; kv < KV; ++kv)
          if (k0 + u < n && lane + 32 * kv < nvec)
            v[u][kv] = row[lane + 32 * kv];
      }
      bool same = k0 + kBatch <= n;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) same = same && id[u] == open;
      if (same) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (m[u] != 0.f) add(v[u], m[u]);
        continue;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u >= n) break;
        if (m[u] == 0.f) continue;
        if (id[u] != open) {
          if (open >= 0) {
            write(open, false);
            node_next = open + 1;
          }
          for (; node_next < id[u]; ++node_next) write(node_next, true);
          open = id[u];
#pragma unroll
          for (int kv = 0; kv < KV; ++kv)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[kv][e] = 0.f;
        }
        add(v[u], m[u]);
      }
    }
    __syncwarp();  // every lane has read the stage before it is refilled
  };

  int a = 0, b = 0;
  bool has_a = issue(0, a);
  bool has_b = has_a && issue(1, b);
  for (int use = 0; has_a; ++use) {
    consume(0, use, a);
    has_a = has_b && issue(0, a);
    if (!has_b) break;
    consume(1, use, b);
    has_b = has_a && issue(1, b);
  }
  if (open >= 0) {
    write(open, false);
    node_next = open + 1;
  }
  for (; node_next < node_hi; ++node_next) write(node_next, true);
}

// Whether rows of h elements of T take this schedule: a whole number of
// 16-byte pieces, at most kMaxKv 4-value vectors per lane.
template <typename T>
__host__ inline bool takes(int h) {
  return h > 0 && (h * sizeof(T)) % 16 == 0 && h <= 32 * 4 * kMaxKv;
}

template <typename T, int KV>
cudaError_t launch_kv(const T* data, const int* ids, const T* mask,
                      const int* rows, const int* offsets, T* out,
                      int64_t n_nodes, int h, int pad_sink,
                      cudaStream_t stream) {
  const int row_bytes = h * int(sizeof(T));
  const size_t smem =
      kHeadBytes + size_t(kWarps) * 2 * stage_rows(row_bytes) * row_bytes;
  auto kernel = segment_bulk_kernel<T, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int64_t per_cta = int64_t(kWarps) * kSpan;
  const int64_t grid = (n_nodes + per_cta - 1) / per_cta;
  kernel<<<unsigned(grid), 32 * kWarps, smem, stream>>>(
      data, ids, mask, rows, offsets, out, int(n_nodes), h, pad_sink);
  return cudaGetLastError();
}

// The sums over a built row pointer (rows of h with takes<T>(h)) on
// `stream`. Returns a cudaError_t.
template <typename T>
cudaError_t launch_sums(const T* data, const int* ids, const T* mask,
                        const int* rows, const int* offsets, T* out,
                        int64_t n_nodes, int h, int pad_sink,
                        cudaStream_t stream) {
  if (!takes<T>(h)) return cudaErrorInvalidValue;
  const int kv = (h / 4 + 31) / 32;
  if (kv == 1)
    return launch_kv<T, 1>(data, ids, mask, rows, offsets, out, n_nodes, h,
                           pad_sink, stream);
  if (kv == 2)
    return launch_kv<T, 2>(data, ids, mask, rows, offsets, out, n_nodes, h,
                           pad_sink, stream);
  return launch_kv<T, 4>(data, ids, mask, rows, offsets, out, n_nodes, h,
                         pad_sink, stream);
}

}  // namespace segbulk
