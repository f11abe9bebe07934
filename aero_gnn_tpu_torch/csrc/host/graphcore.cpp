// graphcore: the port's native host-side graph preprocessing (a copy of
// the JAX package's native/graphcore.cpp, which the port does not import).
//
// At production mesh sizes (10^6-10^8 edges) the per-batch lexsort and
// layout passes dominate input-pipeline latency. This library provides
// O(E + N) counting-sort based implementations, exposed through a plain C
// ABI consumed via ctypes (aero_gnn_tpu_torch/graph/native.py); the numpy
// versions stay as the plain versions the tests compare against.
//
// A fifth entry point, gc_balance_slots, is the BSMS hierarchy's greedy
// degree-balanced relabelling of coarse nodes (graph/hierarchy.py
// align_hierarchy); its plain version is graph/hierarchy.py
// _balance_block_slots_ref, a Python heap loop.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC at first use
// (aero_gnn_tpu_torch/ops/_build.py host_library).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// Stable destination-major edge sort: permutation such that
// (receivers[perm], senders[perm]) is lexicographically ascending.
// Two-pass counting sort (sender key first, then receiver key) — stable,
// O(E + N), no comparisons.
void gc_sort_edges_by_receiver(const int32_t* senders,
                               const int32_t* receivers,
                               int64_t num_edges, int32_t num_nodes,
                               int32_t* perm_out) {
  std::vector<int64_t> count(static_cast<size_t>(num_nodes) + 1, 0);
  std::vector<int32_t> tmp(static_cast<size_t>(num_edges));

  // pass 1: stable counting sort by sender
  for (int64_t i = 0; i < num_edges; ++i) count[senders[i] + 1]++;
  for (int32_t v = 0; v < num_nodes; ++v) count[v + 1] += count[v];
  for (int64_t i = 0; i < num_edges; ++i)
    tmp[count[senders[i]]++] = static_cast<int32_t>(i);

  // pass 2: stable counting sort by receiver (applied to pass-1 order)
  std::fill(count.begin(), count.end(), 0);
  for (int64_t i = 0; i < num_edges; ++i) count[receivers[i] + 1]++;
  for (int32_t v = 0; v < num_nodes; ++v) count[v + 1] += count[v];
  for (int64_t i = 0; i < num_edges; ++i) {
    int32_t e = tmp[i];
    perm_out[count[receivers[e]]++] = e;
  }
}

// Stable argsort of an int32 key array with values in [0, num_keys).
void gc_argsort_i32(const int32_t* keys, int64_t n, int32_t num_keys,
                    int32_t* perm_out) {
  std::vector<int64_t> count(static_cast<size_t>(num_keys) + 1, 0);
  for (int64_t i = 0; i < n; ++i) count[keys[i] + 1]++;
  for (int32_t v = 0; v < num_keys; ++v) count[v + 1] += count[v];
  for (int64_t i = 0; i < n; ++i)
    perm_out[count[keys[i]]++] = static_cast<int32_t>(i);
}

// CSR row offsets from a sorted id stream: offsets[v] = first index with
// ids[i] >= v; offsets has num_segments + 1 entries.
void gc_csr_offsets(const int32_t* sorted_ids, int64_t n,
                    int32_t num_segments, int64_t* offsets_out) {
  int64_t i = 0;
  for (int32_t v = 0; v <= num_segments; ++v) {
    while (i < n && sorted_ids[i] < v) ++i;
    offsets_out[v] = i;
  }
}

// Block-aligned edge layout (the Pallas aggregation layout): given edges
// sorted by receiver, emit a row index per OUTPUT slot — either the source
// edge row, or -1 for an inserted pad slot — such that each
// node-block's range is a whole number of edge tiles and every block has
// at least one tile. Returns the number of output slots (call with
// out == nullptr to query the size first).
int64_t gc_align_blocks(const int32_t* receivers, int64_t num_edges,
                        int32_t num_nodes_pad, int32_t node_block,
                        int32_t edge_tile, int32_t* out_rows,
                        int32_t* out_tile_block, int32_t* out_tile_first,
                        int64_t* out_num_tiles) {
  int32_t n_blocks = num_nodes_pad / node_block;
  int64_t pos = 0;     // read cursor into the edge stream
  int64_t slot = 0;    // write cursor into the output layout
  int64_t tile = 0;
  for (int32_t b = 0; b < n_blocks; ++b) {
    int64_t start = pos;
    while (pos < num_edges && receivers[pos] / node_block == b) ++pos;
    int64_t cnt = pos - start;
    int64_t tiles = (cnt + edge_tile - 1) / edge_tile;
    if (tiles == 0) tiles = 1;
    int64_t total = tiles * edge_tile;
    if (out_rows != nullptr) {
      for (int64_t k = 0; k < total; ++k)
        out_rows[slot + k] =
            (k < cnt) ? static_cast<int32_t>(start + k) : -1;
      for (int64_t t = 0; t < tiles; ++t) {
        out_tile_block[tile + t] = b;
        out_tile_first[tile + t] = (t == 0) ? 1 : 0;
      }
    }
    slot += total;
    tile += tiles;
  }
  if (out_num_tiles != nullptr) *out_num_tiles = tile;
  return slot;
}

// Greedy block balance: a slot in [0, n_blocks * nb) for each of n weighted
// items so that per-block weight sums are even. Items are taken heaviest
// first, ties in index order; each goes to the block with the least
// (load, block id) among the blocks with room, and takes that block's next
// slot. Loads are double sums in the order items arrive. The last slot of
// the last block is left free when reserve_last. Returns 0, or -1 (nothing
// written) when the items exceed the capacity.
int32_t gc_balance_slots(const double* weights, int64_t n, int32_t n_blocks,
                         int32_t nb, int32_t reserve_last,
                         int64_t* slots_out) {
  std::vector<int64_t> cap(static_cast<size_t>(n_blocks), nb);
  if (reserve_last && n_blocks > 0) cap[n_blocks - 1] -= 1;
  int64_t total = 0;
  for (int64_t c : cap) total += c;
  if (n > total) return -1;

  std::vector<int64_t> order(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [weights](int64_t a,
                                                         int64_t b) {
    return weights[a] > weights[b];
  });

  using Entry = std::pair<double, int32_t>;  // (load, block): a min-heap
  std::vector<Entry> init;
  init.reserve(static_cast<size_t>(n_blocks));
  for (int32_t b = 0; b < n_blocks; ++b) init.emplace_back(0.0, b);
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap(
      std::greater<Entry>(), std::move(init));
  std::vector<int64_t> count(static_cast<size_t>(n_blocks), 0);
  for (int64_t i : order) {
    Entry top = heap.top();
    heap.pop();
    while (count[top.second] >= cap[top.second]) {  // a block of no room
      top = heap.top();
      heap.pop();
    }
    int32_t b = top.second;
    slots_out[i] = static_cast<int64_t>(b) * nb + count[b];
    if (++count[b] < cap[b]) heap.emplace(top.first + weights[i], b);
  }
  return 0;
}

}  // extern "C"
