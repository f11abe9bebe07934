// Two weighted sorted segment sums over one id stream, the device code of
// kernel K10 (segment_sum_weighted2.cu):
//
//   out1[n] = sum over i with ids[i] == n of rnd_T(w1[i]) * m1[i]
//   out2[n] = sum over i with ids[i] == n of rnd_T(w2[i]) * m2[i]
//
// with ids ascending ([E] -> [N, h]), m1 and m2 [E, h] rows read in stream
// order (no gather), each fp32 weight rounded to the data's type first (as
// K7 and the TPU kernel do). Both streams share one row pointer
// (segment_rows.cuh row_offsets_kernel) and one walk of the ids; each keeps
// its own fp32 sums in stream order, one rounding per output row, so each
// output is the same bits as K7 (segment_sum_weighted.cu) gives on its
// stream wherever the data is finite. A row is dropped from a stream only
// where that stream's folded weight is 0 (it adds +-0, which leaves a sum
// started at +0 as it is); the two streams may differ there, so a node is
// opened where either stream adds, and a stream that added nothing to it
// writes the +0 it started from, the zero K7 writes for a node it never
// opened.
//
// The schedule is K7's (segment_rows.cuh): lane groups owning runs of
// kSpan nodes, the ids and both folded weights one row per lane in
// registers (the next batch's loaded while this one is summed), a ballot
// keeping the rows where either weight is not 0, kInFlight rows of both
// streams read before their sums. (K5's ring of bulk copies, each stage
// holding the same rows of both streams, measured slower per call on the
// H100 and was dropped; PERF.md.)
// No shared memory, no CTA barrier, no atomics: every output row, empty
// nodes included (exact zeros), is written by its lane group alone.
#pragma once

#include "segment_rows.cuh"

namespace segpair {

using segrows::kFull;
using segrows::madd;

constexpr int kWarps = 8;  // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMinCtas = 2;
constexpr int kSpan = 16;     // nodes per lane group
constexpr int kInFlight = 8;  // rows of both streams read before their sums

template <typename T, int V, int KV>
__global__ void __launch_bounds__(kThreads, kMinCtas)
pair_rows_kernel(const T* __restrict__ m1, const T* __restrict__ m2,
                 const int* __restrict__ ids, const float* __restrict__ w1,
                 const float* __restrict__ w2,
                 const int* __restrict__ offsets, T* __restrict__ out1,
                 T* __restrict__ out2, int n_nodes, int h, int ld, int G) {
  using P = segrows::Pack<T, V>;
  using U = typename P::U;
  const int lane = threadIdx.x & 31;
  const int R = 32 / G;  // groups per warp
  const int grp = lane / G, gl = lane % G;
  const int nvec = h / V;
  const int64_t n0 =
      (int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * R * kSpan;
  if (n0 >= n_nodes) return;  // the whole warp
  long long bound = 0;
  if (lane <= R)
    bound = offsets[min(n0 + int64_t(lane) * kSpan, int64_t(n_nodes))];
  const int64_t lo = __shfl_sync(kFull, bound, grp);
  const int64_t hi = __shfl_sync(kFull, bound, grp + 1);
  const int node_lo = int(min(n0 + int64_t(grp) * kSpan, int64_t(n_nodes)));
  const int node_hi =
      int(min(n0 + int64_t(grp + 1) * kSpan, int64_t(n_nodes)));
  const int cnt = int(hi - lo);
  int max_cnt = cnt;  // every group of the warp steps as far as the longest
#pragma unroll
  for (int o = 16; o; o >>= 1)
    max_cnt = max(max_cnt, __shfl_xor_sync(kFull, max_cnt, o));

  float s1[KV][V], s2[KV][V];
  auto write = [&](int node, bool zero) {
#pragma unroll
    for (int kv = 0; kv < KV; ++kv) {
      const int cv = gl + kv * G;
      if (cv < nvec) {
        float f1[V], f2[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          f1[e] = zero ? 0.f : s1[kv][e];
          f2[e] = zero ? 0.f : s2[kv][e];
        }
        reinterpret_cast<U*>(out1 + int64_t(node) * ld)[cv] = P::pack(f1);
        reinterpret_cast<U*>(out2 + int64_t(node) * ld)[cv] = P::pack(f2);
      }
    }
  };
  auto add = [&](float (&s)[KV][V], const U (&v)[KV], float w) {
#pragma unroll
    for (int kv = 0; kv < KV; ++kv) {
      if (gl + kv * G < nvec) {
        float f[V];
        P::unpack(v[kv], f);
#pragma unroll
        for (int e = 0; e < V; ++e) s[kv][e] = madd(s[kv][e], f[e], w);
      }
    }
  };
  int open = -1;       // node whose sums are being carried
  int next = node_lo;  // first output row not yet written
  // one row's id and folded weights per lane of the group; the next
  // batch's are loaded while this one's rows are read
  int id_n = 0;
  float a_n = 0.f, b_n = 0.f;
  auto load_meta = [&](int base) {
    const int64_t i = lo + base + gl;
    id_n = 0;
    a_n = b_n = 0.f;
    if (base + gl < cnt) {
      id_n = ids[i];
      a_n = segrows::rnd<T>(w1[i]);
      b_n = segrows::rnd<T>(w2[i]);
    }
  };
  load_meta(0);
  const unsigned group_bits = G == 32 ? kFull : ((1u << G) - 1) << (grp * G);
  for (int base = 0; base < max_cnt; base += G) {
    const int id_m = id_n;
    const float a_m = a_n, b_m = b_n;
    if (base + G < max_cnt) load_meta(base + G);
    const bool take = a_m != 0.f || b_m != 0.f;
    unsigned live = (__ballot_sync(kFull, take) & group_bits) >> (grp * G);
    int n_take = __popc(live);
#pragma unroll
    for (int o = 16; o; o >>= 1)
      n_take = max(n_take, __shfl_xor_sync(kFull, n_take, o));
    for (int k0 = 0; k0 < n_take; k0 += kInFlight) {
      int rr[kInFlight];  // the group lane holding each row, or -1
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        rr[u] = live ? __ffs(live) - 1 : -1;
        live &= live - 1;
      }
      float wa[kInFlight], wb[kInFlight];
      U v1[kInFlight][KV], v2[kInFlight][KV];  // issued before the sums
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int src = rr[u] & (G - 1);
        wa[u] = __shfl_sync(kFull, a_m, src, G);
        wb[u] = __shfl_sync(kFull, b_m, src, G);
        if (rr[u] >= 0) {
          const int64_t row = (lo + base + rr[u]) * ld;
          const U* r1 = reinterpret_cast<const U*>(m1 + row);
          const U* r2 = reinterpret_cast<const U*>(m2 + row);
#pragma unroll
          for (int kv = 0; kv < KV; ++kv) {
            if (gl + kv * G < nvec) {
              if (wa[u] != 0.f) v1[u][kv] = r1[gl + kv * G];
              if (wb[u] != 0.f) v2[u][kv] = r2[gl + kv * G];
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int id = __shfl_sync(kFull, id_m, rr[u] & (G - 1), G);
        if (rr[u] >= 0) {
          if (id != open) {
            if (open >= 0) {
              write(open, false);
              next = open + 1;
            }
            for (; next < id; ++next) write(next, true);
            open = id;
#pragma unroll
            for (int kv = 0; kv < KV; ++kv)
#pragma unroll
              for (int e = 0; e < V; ++e) s1[kv][e] = s2[kv][e] = 0.f;
          }
          if (wa[u] != 0.f) add(s1, v1[u], wa[u]);
          if (wb[u] != 0.f) add(s2, v2[u], wb[u]);
        }
      }
    }
  }
  if (open >= 0) {
    write(open, false);
    next = open + 1;
  }
  for (; next < node_hi; ++next) write(next, true);
}

template <typename T, int V, int KV>
cudaError_t launch_rows_v(const T* m1, const T* m2, const int* ids,
                          const float* w1, const float* w2,
                          const int* offsets, T* out1, T* out2,
                          int64_t n_nodes, int h, int ld, int G,
                          cudaStream_t stream) {
  const int64_t per_cta = int64_t(kWarps) * (32 / G) * kSpan;
  const int64_t grid = (n_nodes + per_cta - 1) / per_cta;
  pair_rows_kernel<T, V, KV><<<unsigned(grid), kThreads, 0, stream>>>(
      m1, m2, ids, w1, w2, offsets, out1, out2, int(n_nodes), h, ld, G);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_rows_shape(const T* m1, const T* m2, const int* ids,
                              const float* w1, const float* w2,
                              const int* offsets, T* out1, T* out2,
                              int64_t n_nodes, int h, int ld,
                              cudaStream_t stream) {
  int G = 0, KV = 0;
  if (!segrows::group_shape(h / V, &G, &KV)) return cudaErrorInvalidValue;
  if (KV == 1)
    return launch_rows_v<T, V, 1>(m1, m2, ids, w1, w2, offsets, out1, out2,
                                  n_nodes, h, ld, G, stream);
  if (KV == 2)
    return launch_rows_v<T, V, 2>(m1, m2, ids, w1, w2, offsets, out1, out2,
                                  n_nodes, h, ld, G, stream);
  return launch_rows_v<T, V, 4>(m1, m2, ids, w1, w2, offsets, out1, out2,
                                n_nodes, h, ld, G, stream);
}

// The lane groups over a built row pointer, in column blocks of at most
// segrows::max_cols(h) values.
template <typename T>
cudaError_t launch_rows(const T* m1, const T* m2, const int* ids,
                        const float* w1, const float* w2, const int* offsets,
                        T* out1, T* out2, int64_t n_nodes, int h,
                        cudaStream_t stream) {
  const int block = segrows::max_cols(h);
  for (int c0 = 0; c0 < h; c0 += block) {
    const int w = h - c0 < block ? h - c0 : block;
    const cudaError_t err =
        w % segrows::kVec == 0 && h % segrows::kVec == 0
            ? launch_rows_shape<T, segrows::kVec>(m1 + c0, m2 + c0, ids, w1,
                                                  w2, offsets, out1 + c0,
                                                  out2 + c0, n_nodes, w, h,
                                                  stream)
            : launch_rows_shape<T, 1>(m1 + c0, m2 + c0, ids, w1, w2, offsets,
                                      out1 + c0, out2 + c0, n_nodes, w, h,
                                      stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The pair on `stream`: the row pointer into `offsets` ([n_nodes + 1]
// ints of scratch), then the sums. Returns a cudaError_t.
template <typename T>
cudaError_t launch(const T* m1, const T* m2, const int* ids, const float* w1,
                   const float* w2, int* offsets, T* out1, T* out2,
                   int64_t n_ids, int64_t n_nodes, int h,
                   cudaStream_t stream) {
  if (n_nodes == 0 || h == 0) return cudaSuccess;
  const cudaError_t err =
      segrows::launch_offsets(ids, n_ids, n_nodes, offsets, stream);
  if (err != cudaSuccess) return err;
  return launch_rows<T>(m1, m2, ids, w1, w2, offsets, out1, out2, n_nodes, h,
                        stream);
}

}  // namespace segpair
