// Sorted masked segment sum on lane groups that own runs of nodes: the
// device code of kernel K7 (segment_sum_weighted.cu), of K2's d_dproj
// (fused_edge_bwd.cu) and of K5 (segment_sum.cu) where its rows are no
// whole number of 16-byte pieces or wider than its ring takes.
//
//   out[n] = sum over i with ids[i] == n of mask[i] * w(i) * data[rows[i]]
//
// with ids ascending ([E] -> [N, h]), mask optional (ones), rows optional
// (i), w(i) = weights[i] rounded to the data's type (kWeighted) or 1. With
// pad_sink the last node (N - 1) is the pad sink of an aligned stream: its
// rows, the Loader's pad tail, add zero, so they are never walked and the
// sink's row is written as 0.
//
// What bounds it: bytes. Each live row is one gather of h values from the
// node table (K7: the sender's row), so the schedule aims at gathers in
// flight. A first pass writes the stream's row pointer (offsets[n], the
// first row of node n), so no range needs a search. A row is read in
// vectors of 4 values (16 bytes of fp32, 8 of bf16) by a group of G lanes
// (G = 32 for a row of 128, fewer for narrower rows; 32 / G groups a
// warp), and each group owns a run of kSpan consecutive nodes. It walks
// its rows in stream order, G at a time: the row index, id and folded
// weight of each sit one per lane in registers (the next G loaded while
// these are gathered), a ballot drops the rows whose folded weight is 0
// (they add +-0, which leaves a sum started at +0 as it is: the pad rows
// of an aligned stream, a thousand of them on an empty node block's first
// node, cost no gather), and the rest reach the group by __shfl_sync,
// kInFlight gathers issued before their sums. Each node's rows are added
// in fp32 in stream order with the weight folded as m * rnd_T(w), one
// rounding per output row: the order and arithmetic of the first K5 / K7
// schedule (one thread a column walking a node block's rows), so the
// output is the same bits wherever the node table is finite. No shared memory, no CTA barrier,
// no atomics: every output row, empty nodes included (exact zeros), is
// written by its group alone.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace segrows {

constexpr int kWarps = 8;      // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMinCtas = 2;    // CTAs per SM the register budget allows
constexpr int kSpan = 16;      // nodes per lane group
constexpr int kInFlight = 8;   // row gathers issued before their sums
constexpr unsigned kFull = 0xffffffffu;

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

// sum + x * mw with two roundings, as the first K7 schedule computed it
// (a fused multiply-add would give other bits)
__device__ __forceinline__ float madd(float sum, float x, float mw) {
  return __fadd_rn(sum, __fmul_rn(x, mw));
}

// V consecutive elements of T as one load (V = 4: 16 bytes of fp32, 8 of
// bf16; V = 1 for rows that are no whole number of them)
template <typename T, int V>
struct Pack;

template <>
struct Pack<float, 4> {
  using U = float4;
  __device__ static void unpack(const U& u, float (&f)[4]) {
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  __device__ static U pack(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Pack<float, 1> {
  using U = float;
  __device__ static void unpack(const U& u, float (&f)[1]) { f[0] = u; }
  __device__ static U pack(const float (&f)[1]) { return f[0]; }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  using U = __nv_bfloat16;
  __device__ static void unpack(const U& u, float (&f)[1]) {
    f[0] = __bfloat162float(u);
  }
  __device__ static U pack(const float (&f)[1]) {
    return __float2bfloat16(f[0]);
  }
};

template <>
struct Pack<__nv_bfloat16, 4> {
  using U = uint2;
  __device__ static void unpack(const U& u, float (&f)[4]) {
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      __nv_bfloat162 b;
      *reinterpret_cast<uint32_t*>(&b) = w[k];
      const float2 p = __bfloat1622float2(b);
      f[2 * k] = p.x;
      f[2 * k + 1] = p.y;
    }
  }
  __device__ static U pack(const float (&f)[4]) {
    uint32_t w[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&b);
    }
    return make_uint2(w[0], w[1]);
  }
};

// offsets[n] = the first row i with ids[i] >= n, n = 0 .. n_nodes (the
// stream's CSR row pointer): row i writes the entries of the nodes after
// ids[i - 1] up to ids[i], so each entry is written once.
__global__ void __launch_bounds__(256)
row_offsets_kernel(const int* __restrict__ ids, int64_t n_ids, int n_nodes,
                   int* __restrict__ offsets) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i > n_ids) return;
  const int a = i == 0 ? -1 : ids[i - 1];
  const int b = i == n_ids ? n_nodes : ids[i];
  for (int n = a + 1; n <= b; ++n) offsets[n] = int(i);
}

// G lanes per group (a power of two up to 32), KV vectors of V elements
// per lane and row (row width h = up to G * KV * V elements).
template <typename T, bool kWeighted, int V, int KV>
__global__ void __launch_bounds__(kThreads, kMinCtas)
segment_rows_kernel(const T* __restrict__ data, const int* __restrict__ ids,
                    const T* __restrict__ mask, const int* __restrict__ rows,
                    const float* __restrict__ weights,
                    const int* __restrict__ offsets, T* __restrict__ out,
                    int64_t n_ids, int n_nodes, int h, int ld, int pad_sink,
                    int G) {
  using P = Pack<T, V>;
  using U = typename P::U;
  const int lane = threadIdx.x & 31;
  const int R = 32 / G;  // groups per warp
  const int grp = lane / G, gl = lane % G;
  const int nvec = h / V;
  const int64_t n0 =
      (int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * R * kSpan;
  if (n0 >= n_nodes) return;  // the whole warp
  // run boundaries: lane k <= R finds the first row of node n0 + k * kSpan
  // (rows of the pad sink excluded)
  const int n_walk = pad_sink ? n_nodes - 1 : n_nodes;
  long long bound = 0;
  if (lane <= R) {
    const int key = int(min(n0 + int64_t(lane) * kSpan, int64_t(n_walk)));
    bound = offsets[key];
  }
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

  float sum[KV][V];
  auto write = [&](int node, bool zero) {
#pragma unroll
    for (int kv = 0; kv < KV; ++kv) {
      const int cv = gl + kv * G;
      if (cv < nvec) {
        float f[V];
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = zero ? 0.f : sum[kv][e];
        reinterpret_cast<U*>(out + int64_t(node) * ld)[cv] = P::pack(f);
      }
    }
  };
  int open = -1;       // node whose sum is being carried
  int next = node_lo;  // first output row not yet written
  // one row's index, id and folded weight per lane of the group; the next
  // batch's are loaded while this one's rows are gathered
  int id_n = 0, src_n = 0;
  float mw_n = 0.f;
  auto load_meta = [&](int base) {
    const int64_t i = lo + base + gl;
    id_n = src_n = 0;
    mw_n = 0.f;
    if (base + gl < cnt) {
      id_n = ids[i];
      src_n = rows ? rows[i] : int(i);
      const float m = mask ? to_f(mask[i]) : 1.f;
      // the weight takes the data's type first, as the TPU kernel casts its
      // weighted one-hot to the message dtype
      mw_n = kWeighted ? m * rnd<T>(weights[i]) : m;
    }
  };
  load_meta(0);
  const unsigned group_bits = G == 32 ? kFull : ((1u << G) - 1) << (grp * G);
  for (int base = 0; base < max_cnt; base += G) {
    const int id_m = id_n, src_m = src_n;
    const float mw_m = mw_n;
    if (base + G < max_cnt) load_meta(base + G);
    // the group's rows of this batch that add something, in stream order: a
    // row whose folded weight is 0 adds +-0, which leaves a sum started at
    // +0 as it is, so it is neither read nor added
    const bool take = mw_m != 0.f;
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
      U v[kInFlight][KV];  // independent gathers, issued before the sums
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int src = __shfl_sync(kFull, src_m, rr[u] & (G - 1), G);
        if (rr[u] >= 0) {
          const U* row = reinterpret_cast<const U*>(data + int64_t(src) * ld);
#pragma unroll
          for (int kv = 0; kv < KV; ++kv)
            if (gl + kv * G < nvec) v[u][kv] = row[gl + kv * G];
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int id = __shfl_sync(kFull, id_m, rr[u] & (G - 1), G);
        const float mw = __shfl_sync(kFull, mw_m, rr[u] & (G - 1), G);
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
              for (int e = 0; e < V; ++e) sum[kv][e] = 0.f;
          }
#pragma unroll
          for (int kv = 0; kv < KV; ++kv) {
            if (gl + kv * G < nvec) {
              float f[V];
              P::unpack(v[u][kv], f);
#pragma unroll
              for (int e = 0; e < V; ++e)
                sum[kv][e] = madd(sum[kv][e], f[e], mw);
            }
          }
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

template <typename T, bool kWeighted, int V, int KV>
cudaError_t launch_v(const T* data, const int* ids, const T* mask,
                     const int* rows, const float* weights,
                     const int* offsets, T* out,
                     int64_t n_ids, int64_t n_nodes, int h, int ld,
                     int pad_sink, int G, cudaStream_t stream) {
  const int64_t nodes_per_cta = int64_t(kWarps) * (32 / G) * kSpan;
  const int64_t grid = (n_nodes + nodes_per_cta - 1) / nodes_per_cta;
  segment_rows_kernel<T, kWeighted, V, KV>
      <<<unsigned(grid), kThreads, 0, stream>>>(data, ids, mask, rows,
                                                weights, offsets, out, n_ids,
                                                int(n_nodes), h, ld, pad_sink,
                                                G);
  return cudaGetLastError();
}

// The lane-group shape for rows of `nvec` vectors: G lanes (a power of two
// from 2 to 32, so a warp's 32 / G + 1 run boundaries fit its lanes) and KV
// vectors per lane (1, 2 or 4); false when a row is too wide.
__host__ inline bool group_shape(int nvec, int* G, int* KV) {
  if (nvec > 32) {
    *G = 32;
    const int kv = (nvec + 31) / 32;
    *KV = kv <= 2 ? 2 : 4;
    return kv <= 4;
  }
  *KV = 1;
  *G = 2;
  while (*G < nvec) *G *= 2;
  return true;
}

template <typename T, bool kWeighted, int V>
cudaError_t launch_shape(const T* data, const int* ids, const T* mask,
                         const int* rows, const float* weights,
                         const int* offsets, T* out, int64_t n_ids,
                         int64_t n_nodes, int h, int ld, int pad_sink,
                         cudaStream_t stream) {
  int G = 0, KV = 0;
  if (!group_shape(h / V, &G, &KV)) return cudaErrorInvalidValue;
  if (KV == 1)
    return launch_v<T, kWeighted, V, 1>(data, ids, mask, rows, weights,
                                        offsets, out, n_ids, n_nodes, h, ld,
                                        pad_sink, G, stream);
  if (KV == 2)
    return launch_v<T, kWeighted, V, 2>(data, ids, mask, rows, weights,
                                        offsets, out, n_ids, n_nodes, h, ld,
                                        pad_sink, G, stream);
  return launch_v<T, kWeighted, V, 4>(data, ids, mask, rows, weights,
                                      offsets, out, n_ids, n_nodes, h, ld,
                                      pad_sink, G, stream);
}

// The stream's row pointer into `offsets` ([n_nodes + 1] ints of scratch)
// on `stream`. Returns a cudaError_t.
inline cudaError_t launch_offsets(const int* ids, int64_t n_ids,
                                  int64_t n_nodes, int* offsets,
                                  cudaStream_t stream) {
  const int64_t threads = n_ids + 1;
  row_offsets_kernel<<<unsigned((threads + 255) / 256), 256, 0, stream>>>(
      ids, n_ids, int(n_nodes), offsets);
  return cudaGetLastError();
}

// 16-byte vectors for fp32, 8-byte ones for bf16: a bf16 row of 128 then
// takes a whole warp, one group, which measured faster on the H100 than
// two groups of 16 lanes with 16-byte vectors
constexpr int kVec = 4;

// The widest column block one launch of the sums takes: 4 vectors for
// each of 32 lanes, 4-value vectors where a row of h is a whole number of
// them, else single values.
__host__ inline int max_cols(int h) {
  return 32 * 4 * (h % kVec ? 1 : kVec);
}

// The sums over a built row pointer, columns [0, h) of rows of stride ld
// (data and out advanced to the block's first column by the caller):
// 4-element vectors where h and ld are whole numbers of them, else one
// element per load. Returns a cudaError_t.
template <typename T, bool kWeighted>
cudaError_t launch_sums(const T* data, const int* ids, const T* mask,
                        const int* rows, const float* weights,
                        const int* offsets, T* out, int64_t n_ids,
                        int64_t n_nodes, int h, int ld, int pad_sink,
                        cudaStream_t stream) {
  if (h % kVec == 0 && ld % kVec == 0)
    return launch_shape<T, kWeighted, kVec>(data, ids, mask, rows, weights,
                                            offsets, out, n_ids, n_nodes, h,
                                            ld, pad_sink, stream);
  return launch_shape<T, kWeighted, 1>(data, ids, mask, rows, weights,
                                       offsets, out, n_ids, n_nodes, h, ld,
                                       pad_sink, stream);
}

// The segment sum on `stream`: the row pointer into `offsets` ([n_nodes +
// 1] ints of scratch), then the sums (rows of h <= max_cols(h)). Returns a
// cudaError_t.
template <typename T, bool kWeighted>
cudaError_t launch(const T* data, const int* ids, const T* mask,
                   const int* rows, const float* weights, int* offsets,
                   T* out, int64_t n_ids, int64_t n_nodes, int h,
                   int pad_sink, cudaStream_t stream) {
  if (n_nodes == 0 || h == 0) return cudaSuccess;
  const cudaError_t err = launch_offsets(ids, n_ids, n_nodes, offsets,
                                         stream);
  if (err != cudaSuccess) return err;
  return launch_sums<T, kWeighted>(data, ids, mask, rows, weights, offsets,
                                   out, n_ids, n_nodes, h, h, pad_sink,
                                   stream);
}

}  // namespace segrows
