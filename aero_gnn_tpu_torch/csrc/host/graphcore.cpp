// graphcore: the port's native host-side graph preprocessing (its first
// four entry points are a copy of the JAX package's native/graphcore.cpp,
// which the port does not import).
//
// At production mesh sizes (10^6-10^8 edges) the per-batch lexsort and
// layout passes dominate input-pipeline latency. This library provides
// O(E + N) counting-sort based implementations, exposed through a plain C
// ABI consumed via ctypes (aero_gnn_tpu_torch/graph/native.py); the numpy
// versions stay as the plain versions the tests compare against.
//
// The port's own entry points, each with the plain version the tests hold
// it to:
//   gc_balance_slots: the BSMS hierarchy's greedy degree-balanced
//     relabelling of coarse nodes (graph/hierarchy.py align_hierarchy;
//     plain version _balance_block_slots_ref, a Python heap loop);
//   gc_edge_layout: a graph's whole padded edge layout in one pass, the
//     receiver sort, the block alignment, the pad tail, the tiles and the
//     sender stream (graph/padded.py build_graph_batch, and each BSMS
//     coarse level in graph/hierarchy.py align_host; plain version
//     _edge_layout_ref, a numpy composition);
//   gc_chunk_plan: the plan of the per-graph pools and the BSMS unpool
//     (graph/padded.py chunk_plan; plain version chunk_plan_ref).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC at first use
// (aero_gnn_tpu_torch/ops/_build.py host_library).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <utility>
#include <vector>

namespace {

// The start of each node block's run in a block-aligned stream that holds
// counts[b] rows of block b: each block takes whole tiles of edge_tile
// slots, at least one. starts gets counts.size() + 1 entries; the last is
// the stream's length.
void block_starts(const std::vector<int64_t>& counts, int64_t edge_tile,
                  std::vector<int64_t>* starts) {
  starts->assign(counts.size() + 1, 0);
  for (size_t b = 0; b < counts.size(); ++b) {
    int64_t tiles = std::max<int64_t>(1, (counts[b] + edge_tile - 1) /
                                             edge_tile);
    (*starts)[b + 1] = (*starts)[b] + tiles * edge_tile;
  }
}

// From the rows of each key (count, over the node pad): the rows of each
// node block, and its fill key, its last key with a row, else its first
// node.
void block_counts(const std::vector<int64_t>& count, int32_t node_block,
                  std::vector<int64_t>* counts, std::vector<int32_t>* fill) {
  const size_t n_blocks = count.size() / node_block;
  counts->assign(n_blocks, 0);
  fill->resize(n_blocks);
  for (size_t b = 0; b < n_blocks; ++b) {
    (*fill)[b] = static_cast<int32_t>(b * node_block);
    for (size_t v = b * node_block; v < (b + 1) * node_block; ++v) {
      if (count[v] == 0) continue;
      (*counts)[b] += count[v];
      (*fill)[b] = static_cast<int32_t>(v);
    }
  }
}

// The first slot of each key's rows in a counting sort: keys in order,
// each node block's from its start when starts is given (block-aligned).
void key_slots(const std::vector<int64_t>& count, int32_t node_block,
               const std::vector<int64_t>* starts,
               std::vector<int64_t>* next) {
  next->resize(count.size());
  int64_t at = 0;
  for (size_t v = 0; v < count.size(); ++v) {
    if (starts != nullptr && v % node_block == 0)
      at = (*starts)[v / node_block];
    (*next)[v] = at;
    at += count[v];
  }
}

// The pad slots of a block-aligned sender stream: block b's slots after its
// counts[b] rows take pad_row and the block's fill key.
void fill_sender_pads(const std::vector<int64_t>& counts,
                      const std::vector<int64_t>& starts,
                      const std::vector<int32_t>& fill, int32_t pad_row,
                      int32_t* perm_out, int32_t* keys_out) {
  for (size_t b = 0; b < counts.size(); ++b) {
    std::fill(perm_out + starts[b] + counts[b], perm_out + starts[b + 1],
              pad_row);
    std::fill(keys_out + starts[b] + counts[b], keys_out + starts[b + 1],
              fill[b]);
  }
}

}  // namespace

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

// The padded edge layout of a graph in one pass: the edges in stable
// receiver-major order (gc_sort_edges_by_receiver's), then the pad tail up
// to num_edges_pad rows, each pad row an edge of the sink num_nodes_pad - 1
// with zero features and mask. Ids lie in [0, num_nodes_pad); an edge's
// features are attr_bytes bytes, its mask mask_bytes (one for a real edge,
// zero bytes for a pad row).
//
// With node_block > 0 the stream is block-aligned first (gc_align_blocks'
// layout: each node block a whole number of edge_tile tiles, at least one;
// its pad slots repeat the block's last receiver, else its first node, on
// both endpoints), tile_block / tile_first name each of the
// num_edges_pad / edge_tile tiles' block and whether it opens one (the pad
// tail's tiles on the last block), and align_src, unless null, maps each
// row to its receiver-sorted edge, -1 for a pad row.
//
// The sender stream: the rows in a stable sort by sender (sender_perm,
// senders_sorted); aligned, when node_block > 0 and some row is masked,
// by sender block as the edges are by receiver block, each block's pad
// slots taking the last masked row and the block's last sender, else its
// first node (plain version _align_sender_stream_ref). Its buffers hold num_edges_pad + (num_nodes_pad / node_block) * edge_tile
// slots; sender_info gets its length and 1 iff it was aligned.
//
// Returns the rows the layout fills before the pad tail. Nothing is
// written when they exceed num_edges_pad, when an aligned num_edges_pad is
// not a whole number of tiles, or when senders_out is null (a query).
int64_t gc_edge_layout(const int32_t* senders, const int32_t* receivers,
                       const uint8_t* edge_attr, int64_t attr_bytes,
                       int64_t num_edges, int32_t num_nodes_pad,
                       int64_t num_edges_pad, int32_t node_block,
                       int32_t edge_tile, const uint8_t* one,
                       int64_t mask_bytes, int32_t* senders_out,
                       int32_t* receivers_out, uint8_t* edge_attr_out,
                       uint8_t* edge_mask_out, int32_t* tile_block_out,
                       int32_t* tile_first_out, int64_t* align_src_out,
                       int32_t* sender_perm_out, int32_t* senders_sorted_out,
                       int64_t* sender_info) {
  const bool align = node_block > 0;
  const int32_t sink = num_nodes_pad - 1;

  // edges per receiver; aligned: rows per node block and each block's start
  std::vector<int64_t> count(static_cast<size_t>(num_nodes_pad), 0);
  for (int64_t i = 0; i < num_edges; ++i) count[receivers[i]]++;
  std::vector<int64_t> counts, starts;
  std::vector<int32_t> fill;
  int64_t rows = num_edges;
  if (align) {
    block_counts(count, node_block, &counts, &fill);
    block_starts(counts, edge_tile, &starts);
    rows = starts.back();
  }
  if (senders_out == nullptr || rows > num_edges_pad ||
      (align && num_edges_pad % edge_tile))
    return rows;

  // the edges in a stable sort by sender, then each to its receiver's next
  // slot: a stable receiver-major order
  std::vector<int64_t> next;
  key_slots(count, node_block, align ? &starts : nullptr, &next);
  std::vector<int32_t> by_sender(static_cast<size_t>(num_edges));
  gc_argsort_i32(senders, num_edges, num_nodes_pad, by_sender.data());
  for (int32_t e : by_sender) {
    const int64_t slot = next[receivers[e]]++;
    senders_out[slot] = senders[e];
    receivers_out[slot] = receivers[e];
    std::memcpy(edge_attr_out + slot * attr_bytes, edge_attr + e * attr_bytes,
                attr_bytes);
    std::memcpy(edge_mask_out + slot * mask_bytes, one, mask_bytes);
  }

  // pad rows, kept as runs of (first row, end, node) in row order
  std::vector<std::array<int64_t, 3>> pad_runs;
  auto put_pads = [&](int64_t lo, int64_t hi, int32_t node) {
    if (lo >= hi) return;
    std::fill(senders_out + lo, senders_out + hi, node);
    std::fill(receivers_out + lo, receivers_out + hi, node);
    std::memset(edge_attr_out + lo * attr_bytes, 0, (hi - lo) * attr_bytes);
    std::memset(edge_mask_out + lo * mask_bytes, 0, (hi - lo) * mask_bytes);
    if (align_src_out != nullptr)
      std::fill(align_src_out + lo, align_src_out + hi, int64_t{-1});
    pad_runs.push_back({lo, hi, node});
  };
  if (align) {
    const int32_t last_block = static_cast<int32_t>(counts.size()) - 1;
    int64_t tile = 0, edge = 0;
    for (int32_t b = 0; b <= last_block; ++b) {
      const int64_t real_end = starts[b] + counts[b];
      for (int64_t k = starts[b]; k < real_end && align_src_out; ++k)
        align_src_out[k] = edge++;
      put_pads(real_end, starts[b + 1], fill[b]);
      for (int64_t t = starts[b]; t < starts[b + 1]; t += edge_tile, ++tile) {
        tile_block_out[tile] = b;
        tile_first_out[tile] = t == starts[b] ? 1 : 0;
      }
    }
    // the pad tail's tiles belong to the last block
    const int64_t n_tiles = num_edges_pad / edge_tile;
    std::fill(tile_block_out + tile, tile_block_out + n_tiles, last_block);
    std::fill(tile_first_out + tile, tile_first_out + n_tiles, 0);
    if (tile < n_tiles &&
        (tile == 0 || tile_block_out[tile - 1] != last_block))
      tile_first_out[tile] = 1;
  }
  put_pads(rows, num_edges_pad, sink);

  // the sender stream: a stable counting sort of senders_out, each pad run
  // taken whole, into the aligned slots when it is aligned
  const bool align_senders = align && !pad_runs.empty();
  auto real_rows = [&](size_t r) {  // the real rows before pad run r
    return std::make_pair(r ? pad_runs[r - 1][1] : 0,
                          r < pad_runs.size() ? pad_runs[r][0]
                                              : num_edges_pad);
  };
  std::fill(count.begin(), count.end(), 0);
  for (size_t r = 0; r <= pad_runs.size(); ++r) {
    auto [lo, hi] = real_rows(r);
    for (int64_t i = lo; i < hi; ++i) count[senders_out[i]]++;
    if (r < pad_runs.size()) count[pad_runs[r][2]] += pad_runs[r][1] - hi;
  }
  int64_t length = num_edges_pad;
  if (align_senders) {
    block_counts(count, node_block, &counts, &fill);
    block_starts(counts, edge_tile, &starts);
    key_slots(count, node_block, &starts, &next);
    const int32_t pad_row = static_cast<int32_t>(pad_runs.back()[1] - 1);
    fill_sender_pads(counts, starts, fill, pad_row, sender_perm_out,
                     senders_sorted_out);
    length = starts.back();
  } else {
    key_slots(count, node_block, nullptr, &next);
  }
  for (size_t r = 0; r <= pad_runs.size(); ++r) {
    auto [lo, hi] = real_rows(r);
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t p = next[senders_out[i]]++;
      sender_perm_out[p] = static_cast<int32_t>(i);
      senders_sorted_out[p] = senders_out[i];
    }
    if (r == pad_runs.size()) break;
    const int64_t end = pad_runs[r][1];
    const int32_t node = static_cast<int32_t>(pad_runs[r][2]);
    const int64_t p = next[node];
    next[node] += end - hi;
    for (int64_t i = hi; i < end; ++i)
      sender_perm_out[p + i - hi] = static_cast<int32_t>(i);
    std::fill(senders_sorted_out + p, senders_sorted_out + p + end - hi, node);
  }
  sender_info[0] = length;
  sender_info[1] = align_senders ? 1 : 0;
  return rows;
}

// The chunk plan of a segment sum (graph/padded.py chunk_plan): perm, the
// rows in a stable sort by id (ids in [0, num_segments)); chunk, the chunk
// of each sorted row, each id's run cut into chunks of at most size rows;
// chunk_seg, the id of each chunk, and num_segments - 1 past the last, to
// its length n_chunk_seg (at least the chunks' count).
void gc_chunk_plan(const int32_t* ids, int64_t n, int32_t num_segments,
                   int64_t size, int64_t n_chunk_seg, int32_t* perm_out,
                   int32_t* chunk_out, int32_t* chunk_seg_out) {
  gc_argsort_i32(ids, n, num_segments, perm_out);
  std::vector<int64_t> count(static_cast<size_t>(num_segments), 0);
  for (int64_t i = 0; i < n; ++i) count[ids[i]]++;
  int64_t row = 0, chunk = 0;
  for (int32_t v = 0; v < num_segments; ++v) {
    for (int64_t k = 0; k < count[v]; ++k)
      chunk_out[row++] = static_cast<int32_t>(chunk + k / size);
    const int64_t chunks = (count[v] + size - 1) / size;
    std::fill(chunk_seg_out + chunk, chunk_seg_out + chunk + chunks, v);
    chunk += chunks;
  }
  std::fill(chunk_seg_out + chunk, chunk_seg_out + n_chunk_seg,
            num_segments - 1);
}

}  // extern "C"
