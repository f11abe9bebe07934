// One CTA a node block: the pieces K9-fwd (fused_mgn_fwd.cu) and K9-bwd
// (fused_mgn_bwd.cu) share. A node block is node_block nodes; in the
// block-aligned layout (graph/padded.py _align_edge_blocks) its edge rows
// are a run of whole tiles, the live ones (first row real) before its pad
// tiles (chain.cuh "Pad tiles"), and every live row's receiver is one of
// its nodes.
//
//  * block_tiles: the block's live tiles, counted over all tiles by one
//    warp (independent loads, kTileLoads a lane in flight, not a binary
//    search's dependent ones), and each node's live-row bounds reset;
//  * node_bounds: each node's first and last live row of mask != 0, by
//    shared-memory integer atomics (they decide bounds, never the order of
//    a sum), each thread's rows loaded a few at a time before their
//    atomics;
//  * block_sum: out[n] = the fp32 sum of mask * data over node n's rows in
//    stream order, rounded once, for the block's nodes (4 lanes a node, 4
//    values a lane and vector, rows read a few at a time), the rows of
//    mask 0 passed over, the pad sink (the last node) 0, nodes without a
//    row 0 -- the sum K5's ring (segment_bulk.cuh) and K7's lane groups
//    (segment_rows.cuh) take with segrows::madd, so the same bits;
//  * pad_chunks: each warp's share of the pad tiles' chunks, dst = src and
//    dst2 = 0, so the Loader's pad-sink tail is no CTA's alone and
//    needs no launch of its own.
#pragma once

#include "chain.cuh"
#include "segment_rows.cuh"

namespace chain {

// The block's live tiles [lo, lo + live) into range_s[0..1], and s_lo /
// s_hi ([node_block] each) reset; ends with a CTA barrier.
template <typename T>
__device__ __forceinline__ void block_tiles(const int* __restrict__ recv,
                                            const T* __restrict__ mask,
                                            int n_tiles, int edge_tile,
                                            int node_block, int b, int* s_lo,
                                            int* s_hi, int* range_s) {
  constexpr int kTileLoads = 16;  // a lane's tiles in flight
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    // tiles are in block order (a tile's block is its first receiver's),
    // and a block's live tiles come before its pad tiles
    int below = 0, live = 0;
    for (int t0 = lane; t0 < n_tiles; t0 += 32 * kTileLoads) {
      int blk[kTileLoads];
      float m[kTileLoads];
#pragma unroll
      for (int k = 0; k < kTileLoads; ++k) {
        const int t = t0 + 32 * k;
        blk[k] = t < n_tiles ? recv[int64_t(t) * edge_tile] / node_block
                             : 0x7fffffff;
        m[k] = t < n_tiles ? Num<T>::load1(mask + int64_t(t) * edge_tile)
                           : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kTileLoads; ++k) {
        below += blk[k] < b;
        live += blk[k] == b && m[k] != 0.f;
      }
    }
    below = __reduce_add_sync(0xffffffffu, below);
    live = __reduce_add_sync(0xffffffffu, live);
    if (lane == 0) {
      range_s[0] = below;
      range_s[1] = below + live;
    }
  }
  for (int i = threadIdx.x; i < node_block; i += kThreads) {
    s_lo[i] = 0x7fffffff;
    s_hi[i] = 0;
  }
  __syncthreads();
}

// Each node's first and last live row of mask != 0 in [row_lo, row_hi),
// into s_lo / s_hi (visible after the caller's next CTA barrier).
template <typename T>
__device__ __forceinline__ void node_bounds(const int* __restrict__ recv,
                                            const T* __restrict__ mask,
                                            int64_t row_lo, int64_t row_hi,
                                            int node_lo, int node_block,
                                            int* s_lo, int* s_hi) {
  constexpr int kRowLoads = 4;  // a thread's rows in flight
  for (int64_t r0 = row_lo + threadIdx.x; r0 < row_hi;
       r0 += kRowLoads * kThreads) {
    float m[kRowLoads];
    int n[kRowLoads];
#pragma unroll
    for (int k = 0; k < kRowLoads; ++k) {
      const int64_t r = r0 + int64_t(k) * kThreads;
      m[k] = r < row_hi ? Num<T>::load1(mask + r) : 0.f;
      n[k] = r < row_hi ? recv[r] : 0;
    }
#pragma unroll
    for (int k = 0; k < kRowLoads; ++k) {
      const int i = n[k] - node_lo;
      const int r = int(r0 + int64_t(k) * kThreads);
      if (m[k] != 0.f && i >= 0 && i < node_block) {
        atomicMin(s_lo + i, r);
        atomicMax(s_hi + i, r + 1);
      }
    }
  }
}

// out rows node_lo .. node_lo + node_block - 1 (module comment): lane
// `sub` of a node's 4 owns the 4-value vectors sub, sub + 4, ... of a row.
template <typename T, int H>
__device__ void block_sum(const T* __restrict__ data,
                          const T* __restrict__ mask, int n_nodes,
                          int node_block, int node_lo, const int* s_lo,
                          const int* s_hi, T* __restrict__ out) {
  using P = segrows::Pack<T, 4>;
  using U = typename P::U;
  constexpr int kG = 4;                       // lanes a node
  constexpr int NV = H / 4 / kG;              // vectors a lane and row
  constexpr int kB = sizeof(T) == 2 ? 4 : 2;  // rows in flight
  const int sub = threadIdx.x % kG;
  for (int i = threadIdx.x / kG; i < node_block; i += kThreads / kG) {
    const int node = node_lo + i;
    float sum[NV][4];
#pragma unroll
    for (int q = 0; q < NV; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[q][c] = 0.f;
    if (node != n_nodes - 1) {
      const int hi = s_hi[i];
      for (int r = s_lo[i]; r < hi; r += kB) {
        U v[kB][NV];
        float m[kB];
#pragma unroll
        for (int k = 0; k < kB; ++k) {
          const int rr = min(r + k, hi - 1);
          m[k] = r + k < hi ? segrows::to_f(mask[rr]) : 0.f;
          const U* row = reinterpret_cast<const U*>(data + int64_t(rr) * H);
#pragma unroll
          for (int q = 0; q < NV; ++q) v[k][q] = row[sub + kG * q];
        }
#pragma unroll
        for (int k = 0; k < kB; ++k) {
          if (m[k] == 0.f) continue;
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            float f[4];
            P::unpack(v[k][q], f);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              sum[q][c] = segrows::madd(sum[q][c], f[c], m[k]);
          }
        }
      }
    }
    U* dst = reinterpret_cast<U*>(out + int64_t(node) * H);
#pragma unroll
    for (int q = 0; q < NV; ++q) dst[sub + kG * q] = P::pack(sum[q]);
  }
}

// This warp's share of the pad tiles' chunks (first row of the tile
// masked) among the grid's warps: dst = src and, if given, dst2 = 0, 16
// bytes a lane and copy.
template <typename T, int H>
__device__ __forceinline__ void pad_chunks(const T* __restrict__ mask,
                                           int n_chunks, int edge_tile,
                                           const T* __restrict__ src,
                                           T* __restrict__ dst,
                                           T* __restrict__ dst2) {
  constexpr int kVecs = kRows * H * int(sizeof(T)) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int c = blockIdx.x * kWarps + warp; c < n_chunks;
       c += gridDim.x * kWarps) {
    const int64_t r0 = int64_t(c) * kRows;
    if (Num<T>::load1(mask + r0 / edge_tile * edge_tile) != 0.f) continue;
    const uint4* s = reinterpret_cast<const uint4*>(src + r0 * H);
    uint4* d = reinterpret_cast<uint4*>(dst + r0 * H);
    uint4* d2 = dst2 ? reinterpret_cast<uint4*>(dst2 + r0 * H) : nullptr;
#pragma unroll
    for (int k0 = 0; k0 < kVecs / 32; k0 += 8) {
      uint4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = s[(k0 + k) * 32 + lane];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        d[(k0 + k) * 32 + lane] = v[k];
        if (d2) d2[(k0 + k) * 32 + lane] = zero4;
      }
    }
  }
}

}  // namespace chain
