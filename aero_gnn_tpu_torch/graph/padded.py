"""Padded, receiver-sorted graph container (counterpart of
aero_gnn_tpu.graph.padded).

Conventions the kernels and models rely on:

  * ``receivers`` is sorted ascending, so aggregation is a segment reduction
    over contiguous runs of rows;
  * pad edges point at the last pad node (``num_nodes_pad - 1``) on both
    endpoints and have ``edge_mask == 0``; pad nodes have ``node_mask == 0``;
  * with ``align_edges=True`` every ALIGN_NODE_BLOCK-node block owns a
    contiguous run of whole ALIGN_EDGE_TILE-row tiles (at least one), which
    is the layout the fused edge kernel (``ops.hopper_fused``) consumes;
  * ``sender_perm`` sorts the edge rows by sender (``senders_sorted`` =
    ``senders[sender_perm]``), the stream of the sender gather's backward
    (a sorted segment sum, ``ops.scatter.gather_senders``). With
    ``align_edges`` it is block-aligned too when the graph has a masked
    edge row for its pad slots to point at (``senders_aligned``);
  * every row of either stream keyed by the pad sink (``num_nodes_pad - 1``)
    is a pad row, and those rows form the stream's tail; in the aligned
    layout a node block's alignment rows follow its real rows, so a tile
    whose first row is masked holds pad rows only. The kernels skip such
    tiles and the sink's rows (``ops.hopper_fused``,
    ``ops.hopper_segment``), so a padded batch's tail does not all land on
    the last node block's CTA.

Host-side construction runs on the port's native graph core
(``graph.native``): the whole edge layout of a batch (the receiver sort,
the block alignment, the pad tail, the tiles and the sender stream) in one
pass, ``_edge_layout``, and the chunk plan's stable sort; the node-side
pads are numpy. ``_edge_layout_ref`` and the other ``*_ref`` functions are
the numpy plain versions the tests hold the graph core to. The result is a
dataclass of tensors on the requested device.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Dict, Optional

import numpy as np
import torch

from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.graph import native
from aero_gnn_tpu_torch.utils.profiling import annotate, count

ALIGN_NODE_BLOCK = 256
ALIGN_EDGE_TILE = 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_size(n: int, multiple: int = 128, growth: float = 1.3) -> int:
    """Geometric padded-size buckets quantized to ``multiple``."""
    if n <= 0:
        return multiple
    size = multiple
    while size < n:
        size = _round_up(int(size * growth) + 1, multiple)
    return size


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A padded graph. N = padded nodes, E = padded edges, G = padded graphs."""

    senders: torch.Tensor  # i32[E]
    receivers: torch.Tensor  # i32[E], ascending
    sender_perm: torch.Tensor  # i32[E_s], edge rows in sender order
    senders_sorted: torch.Tensor  # i32[E_s] == senders[sender_perm]
    x: torch.Tensor  # f[N, Dn]
    edge_attr: torch.Tensor  # f[E, De]
    pos: torch.Tensor  # f[N, dim]
    y: torch.Tensor  # f[N, Dy]
    node_mask: torch.Tensor  # f[N]
    edge_mask: torch.Tensor  # f[E]
    node_graph: torch.Tensor  # i32[N]
    graph_mask: torch.Tensor  # f[G]
    n_node: int
    n_edge: int
    # aligned layout only: node block of each tile / first tile of a block
    tile_block: Optional[torch.Tensor] = None  # i32[T]
    tile_first: Optional[torch.Tensor] = None  # i32[T]
    # True iff the sender-sorted stream was block-aligned (pad slots added)
    senders_aligned: bool = False
    # the per-graph pools' plan (chunk_plan): node rows sorted by graph,
    # the ascending chunk of each, the ascending graph of each chunk
    graph_perm: Optional[torch.Tensor] = None  # i32[N]
    graph_chunk: Optional[torch.Tensor] = None  # i32[N]
    chunk_graph: Optional[torch.Tensor] = None  # i32[C]

    @property
    def edges_aligned(self) -> bool:
        """True iff built with align_edges=True (the fused-kernel layout)."""
        return self.tile_block is not None

    @property
    def graph_chunks(self):
        """(graph_perm, graph_chunk, chunk_graph), the plan of
        ``ops.graph_pool`` / ``graph_broadcast``; None where not built."""
        if self.graph_perm is None:
            return None
        return (self.graph_perm, self.graph_chunk, self.chunk_graph)

    @property
    def num_nodes_pad(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges_pad(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs_pad(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device: DeviceLike) -> "GraphBatch":
        dev = resolve_device(device)
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return GraphBatch(**{
            k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in kw.items()})


def sort_edges_by_receiver(senders: np.ndarray,
                           receivers: np.ndarray) -> np.ndarray:
    """Stable destination-major (receiver, then sender) permutation, by the
    graph core's O(E + N) counting sort (``graph.native``); the same
    permutation as ``sort_edges_by_receiver_ref``."""
    if len(senders) == 0:
        return np.zeros(0, dtype=np.int64)
    num_nodes = int(max(senders.max(), receivers.max())) + 1
    return native.sort_edges_by_receiver(senders, receivers, num_nodes)


def sort_edges_by_receiver_ref(senders: np.ndarray,
                               receivers: np.ndarray) -> np.ndarray:
    """The plain version of sort_edges_by_receiver: ``np.lexsort``."""
    if len(senders) == 0:
        return np.zeros(0, dtype=np.int64)
    return np.lexsort((senders, receivers))


def chunk_plan(ids: np.ndarray, num_segments: int):
    """The host plan of a segment sum without long runs
    (``ops.gather_chunked``, the per-graph pools, the BSMS unpool):
    ``perm``, the rows in a stable sort by id; ``chunk``, the ascending
    chunk of each sorted row, runs of at most ``size`` rows of one id;
    ``chunk_seg``, the ascending id of each chunk. A segment sum is then two
    sorted sums, rows into chunks and chunks into segments. A warp of K5
    walks 8 segments' rows in turn: 8 chunks in the first pass, every chunk
    of 8 ids in the second; ``size`` ~ sqrt(N / 8) keeps each near
    sqrt(8 N) rows where one id's run (a single graph, a pad tail) would
    give one warp up to N. The chunk count is fixed by N and
    ``num_segments``, so batches of one padded shape stack: chunks past the
    last hold no row and belong to the last id. Ids lie in [0,
    num_segments). int32 arrays, from the graph core
    (``native.chunk_plan``); the plain version is ``chunk_plan_ref``."""
    return native.chunk_plan(ids, num_segments, _chunk_size(len(ids)))


def _chunk_size(n: int) -> int:
    return max(16, int(np.ceil(np.sqrt(n / 8))))


def chunk_plan_ref(ids: np.ndarray, num_segments: int):
    """The plain version of chunk_plan (numpy)."""
    ids = np.asarray(ids)
    n = ids.shape[0]
    perm = np.argsort(ids, kind="stable")
    g = ids[perm]
    size = _chunk_size(n)
    first = np.ones(n, dtype=bool)
    first[1:] = g[1:] != g[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    local = (np.arange(n) - run_start) // size
    new = first.copy()
    new[1:] |= local[1:] != local[:-1]
    chunk = np.cumsum(new) - 1
    chunk_seg = np.full(-(-n // size) + num_segments, num_segments - 1,
                        dtype=np.int32)
    chunk_seg[:int(new.sum())] = g[new]
    return perm.astype(np.int32), chunk.astype(np.int32), chunk_seg


def build_graph_batch(
    *,
    senders: np.ndarray,
    receivers: np.ndarray,
    x: np.ndarray,
    edge_attr: np.ndarray,
    pos: np.ndarray,
    y: Optional[np.ndarray] = None,
    num_nodes_pad: Optional[int] = None,
    num_edges_pad: Optional[int] = None,
    num_graphs_pad: int = 1,
    node_graph: Optional[np.ndarray] = None,
    align_edges: bool = False,
    dtype: np.dtype = np.float32,
    return_align_map: bool = False,
    device: DeviceLike = None,
):
    """Sort edges by receiver, pad nodes/edges, route pad edges to the last
    pad node and (``align_edges``) pad every node block's edges to whole
    tiles. The tensors land on ``device`` (CUDA unless ``"cpu"``).

    ``return_align_map=True`` returns ``(GraphBatch, align_src)``:
    ``align_src`` (int64 numpy, one entry per edge row) maps each aligned
    row to its plain receiver-sorted row, -1 for pad slots; None without
    ``align_edges``. It re-indexes the fine-edge-row artifacts of a BSMS
    hierarchy (``graph.hierarchy.align_hierarchy``)."""
    dev = resolve_device(device)
    senders = np.asarray(senders, dtype=np.int32)
    receivers = np.asarray(receivers, dtype=np.int32)
    x = np.asarray(x, dtype=dtype)
    edge_attr = np.asarray(edge_attr, dtype=dtype)
    pos = np.asarray(pos, dtype=dtype)
    n, e = x.shape[0], senders.shape[0]
    if y is None:
        y = np.zeros((n, 1), dtype=dtype)
    y = np.asarray(y, dtype=dtype)

    node_multiple = ALIGN_NODE_BLOCK if align_edges else 128
    np_pad = (num_nodes_pad if num_nodes_pad is not None
              else bucket_size(n + 1, multiple=node_multiple))
    ep_pad = num_edges_pad if num_edges_pad is not None else bucket_size(e)
    if align_edges and np_pad % ALIGN_NODE_BLOCK:
        raise ValueError(
            f"align_edges requires num_nodes_pad ({np_pad}) to be a "
            f"multiple of {ALIGN_NODE_BLOCK}")
    if np_pad <= n:
        raise ValueError(
            f"num_nodes_pad={np_pad} must exceed num_nodes={n} "
            "(one pad node is reserved as the pad-edge sink)")
    if ep_pad < e:
        raise ValueError(f"num_edges_pad={ep_pad} < num_edges={e}")

    lay = _edge_layout(senders, receivers, edge_attr, np_pad,
                       None if align_edges and num_edges_pad is None
                       else ep_pad, align_edges, return_align_map)
    ep_pad = lay["senders"].shape[0]

    def pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
        out = np.zeros((rows,) + a.shape[1:], dtype=dtype)
        out[: a.shape[0]] = a
        return out

    ng = (np.zeros(n, dtype=np.int32) if node_graph is None
          else np.asarray(node_graph, dtype=np.int32))
    ng_p = np.full(np_pad, num_graphs_pad - 1, dtype=np.int32)
    ng_p[:n] = ng
    node_mask = np.zeros(np_pad, dtype=dtype)
    node_mask[:n] = 1.0
    n_real_graphs = int(ng.max()) + 1 if n else 0
    graph_mask = np.zeros(num_graphs_pad, dtype=dtype)
    graph_mask[:n_real_graphs] = 1.0

    graph_perm, graph_chunk, chunk_graph = chunk_plan(ng_p, num_graphs_pad)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tile_block, tile_first = lay["tile_block"], lay["tile_first"]
    with annotate("aero.graph.to_device"):
        gb = GraphBatch(
            senders=t(lay["senders"]), receivers=t(lay["receivers"]),
            sender_perm=t(lay["sender_perm"]),
            senders_sorted=t(lay["senders_sorted"]),
            x=t(pad_rows(x, np_pad)), edge_attr=t(lay["edge_attr"]),
            pos=t(pad_rows(pos, np_pad)), y=t(pad_rows(y, np_pad)),
            node_mask=t(node_mask), edge_mask=t(lay["edge_mask"]),
            node_graph=t(ng_p), graph_mask=t(graph_mask),
            n_node=n, n_edge=e,
            tile_block=None if tile_block is None else t(tile_block),
            tile_first=None if tile_first is None else t(tile_first),
            senders_aligned=lay["senders_aligned"], graph_perm=t(graph_perm),
            graph_chunk=t(graph_chunk), chunk_graph=t(chunk_graph),
        )
    count("graph.nodes", n)
    count("graph.node_rows", np_pad)
    count("graph.edges", e)
    count("graph.edge_rows", ep_pad)
    return (gb, lay["align_src"]) if return_align_map else gb


def batch_graphs(graphs: list, *, num_nodes_pad: Optional[int] = None,
                 num_edges_pad: Optional[int] = None,
                 num_graphs_pad: Optional[int] = None,
                 align_edges: bool = False, dtype: np.dtype = np.float32,
                 return_align_map: bool = False, device: DeviceLike = None):
    """Disjoint union of host graphs (dicts of numpy arrays: senders,
    receivers, x, edge_attr, pos, y) in one padded GraphBatch, sample i's
    nodes after those of samples < i and ``node_graph`` = i
    (``return_align_map`` as in build_graph_batch)."""
    sizes = [g["x"].shape[0] for g in graphs]
    n_tot = sum(sizes)
    e_tot = sum(g["senders"].shape[0] for g in graphs)
    # ids offset straight into int32 (an id past int32 wraps, as a cast
    # would); one graph's float arrays are passed on without a copy
    senders = _host_buffers.empty("batch_senders", e_tot, np.int32)
    receivers = _host_buffers.empty("batch_receivers", e_tot, np.int32)
    node_graph = np.empty(n_tot, np.int32)
    e0 = n0 = 0
    for i, (g, n_i) in enumerate(zip(graphs, sizes)):
        e1 = e0 + g["senders"].shape[0]
        for ids, key in ((senders[e0:e1], "senders"),
                         (receivers[e0:e1], "receivers")):
            np.copyto(ids, g[key], casting="unsafe")
            if n0:
                ids += n0
        node_graph[n0:n0 + n_i] = i
        e0, n0 = e1, n0 + n_i

    def cat(key):
        arrays = [g[key] for g in graphs]
        return arrays[0] if len(arrays) == 1 else np.concatenate(arrays)

    return build_graph_batch(
        senders=senders, receivers=receivers, x=cat("x"),
        edge_attr=cat("edge_attr"), pos=cat("pos"), y=cat("y"),
        num_nodes_pad=(num_nodes_pad if num_nodes_pad is not None
                       else bucket_size(n_tot + 1)),
        num_edges_pad=(num_edges_pad if num_edges_pad is not None
                       else bucket_size(e_tot)),
        num_graphs_pad=(num_graphs_pad if num_graphs_pad is not None
                        else max(len(graphs) + 1, 2)),
        node_graph=node_graph,
        align_edges=align_edges, dtype=dtype,
        return_align_map=return_align_map, device=device)


class _HostBuffers:
    """The per-batch host arrays of a build (the edge layout's outputs, the
    ids batch_graphs offsets): one buffer kept per role and handed out again
    once nothing else holds it (a batch copied to the card drops its host
    arrays; one left on the CPU keeps them), so the next batch writes pages
    the last one already faulted in: a fresh page costs about as much as
    the layout pass's writes to it. A role's buffer grows to the largest
    batch seen; a busy role gets a fresh array."""

    def __init__(self):
        self._held: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()

    def empty(self, role: str, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        with self._lock:
            buf = self._held.get(role)
            # free: held by the dict, by buf and by getrefcount's argument
            if buf is not None and sys.getrefcount(buf) > 3:
                return np.empty(shape, dtype)
            if buf is None or buf.nbytes < nbytes:
                buf = self._held[role] = np.empty(nbytes, np.uint8)
            return buf[:nbytes].view(dtype).reshape(shape)


_host_buffers = _HostBuffers()


def _edge_layout(senders, receivers, edge_attr, num_nodes_pad,
                 num_edges_pad, align_edges, align_map):
    """A graph's padded edge layout, the edge fields of build_graph_batch
    (a dict: ``senders``, ``receivers``, ``edge_attr``, ``edge_mask``,
    ``tile_block``, ``tile_first``, ``align_src``, ``sender_perm``,
    ``senders_sorted``, ``senders_aligned``), in one pass of the graph core
    (``native.edge_layout``); ``num_edges_pad`` None takes the aligned row
    count, and ``align_src`` is left out (None) unless ``align_map``. The
    result equals ``_edge_layout_ref``'s."""
    nb, et = (ALIGN_NODE_BLOCK, ALIGN_EDGE_TILE) if align_edges else (0, 0)
    return native.edge_layout(senders, receivers, edge_attr, num_nodes_pad,
                              num_edges_pad, nb, et, align_map,
                              empty=_host_buffers.empty)


def _edge_layout_ref(senders, receivers, edge_attr, num_nodes_pad,
                     num_edges_pad, align_edges, align_map):
    """The plain version of _edge_layout: numpy (the receiver lexsort,
    ``_align_edge_blocks_ref``, the pad tail, a stable sender argsort,
    ``_align_sender_stream_ref``); ``align_src`` whatever ``align_map``
    says."""
    del align_map
    dtype, e = edge_attr.dtype, len(senders)
    ep_pad = num_edges_pad
    perm = sort_edges_by_receiver_ref(senders, receivers)
    senders, receivers = senders[perm], receivers[perm]
    edge_attr = edge_attr[perm]

    tile_block = tile_first = align_src = None
    edge_valid = np.ones(e, dtype=bool)
    if align_edges:
        senders, receivers, edge_attr, edge_valid, tile_block, tile_first = \
            _align_edge_blocks_ref(senders, receivers, edge_attr,
                                   num_nodes_pad, dtype)
        e_aligned = senders.shape[0]
        if ep_pad is None:
            ep_pad = _round_up(e_aligned, ALIGN_EDGE_TILE)
        if ep_pad < e_aligned or ep_pad % ALIGN_EDGE_TILE:
            raise ValueError(
                f"num_edges_pad={ep_pad} incompatible with aligned edge "
                f"count {e_aligned} (tile {ALIGN_EDGE_TILE})")
        # the pad tail forms whole tiles assigned to the last node block
        n_tiles = ep_pad // ALIGN_EDGE_TILE
        last_block = num_nodes_pad // ALIGN_NODE_BLOCK - 1
        tb = np.full(n_tiles, last_block, dtype=np.int32)
        tf = np.zeros(n_tiles, dtype=np.int32)
        tb[: len(tile_block)] = tile_block
        tf[: len(tile_first)] = tile_first
        if len(tile_block) < n_tiles and (
                len(tile_block) == 0 or tile_block[-1] != last_block):
            tf[len(tile_block)] = 1
        tile_block, tile_first = tb, tf
        align_src = np.full(ep_pad, -1, dtype=np.int64)
        valid_rows = np.flatnonzero(edge_valid)
        align_src[valid_rows] = np.arange(len(valid_rows), dtype=np.int64)

    pad_node = num_nodes_pad - 1
    n_rows = senders.shape[0]
    s_p = np.full(ep_pad, pad_node, dtype=np.int32)
    r_p = np.full(ep_pad, pad_node, dtype=np.int32)
    s_p[:n_rows], r_p[:n_rows] = senders, receivers
    ea_p = np.zeros((ep_pad, edge_attr.shape[1]), dtype=dtype)
    ea_p[:n_rows] = edge_attr
    edge_mask = np.zeros(ep_pad, dtype=dtype)
    edge_mask[:n_rows] = edge_valid.astype(dtype)

    sender_perm = np.argsort(s_p, kind="stable").astype(np.int32)
    senders_sorted = s_p[sender_perm]
    senders_aligned = False
    if align_edges:
        sender_perm, senders_sorted, senders_aligned = \
            _align_sender_stream_ref(sender_perm, senders_sorted, edge_mask,
                                     num_nodes_pad)
    return dict(senders=s_p, receivers=r_p, edge_attr=ea_p,
                edge_mask=edge_mask, tile_block=tile_block,
                tile_first=tile_first, align_src=align_src,
                sender_perm=sender_perm, senders_sorted=senders_sorted,
                senders_aligned=senders_aligned)


def _align_sender_stream_ref(sender_perm, senders_sorted, edge_mask,
                             num_nodes_pad):
    """Block-align a sender-sorted stream, the plain version of
    ``native.edge_layout``'s aligned sender stream (numpy, a loop over the
    node blocks): each ALIGN_NODE_BLOCK sender block padded to whole
    ALIGN_EDGE_TILE tiles. Pad slots index the last masked edge row, whose
    cotangent is exactly zero, so no extra mask is needed downstream.
    Without a masked edge row the stream stays as it is (third result
    False)."""
    nb, et = ALIGN_NODE_BLOCK, ALIGN_EDGE_TILE
    masked_rows = np.nonzero(edge_mask == 0.0)[0]
    if len(masked_rows) == 0:
        return sender_perm, senders_sorted, False
    pad_row = np.int32(masked_rows[-1])
    n_blocks = num_nodes_pad // nb
    block_of = senders_sorted // nb
    starts = np.searchsorted(block_of, np.arange(n_blocks))
    ends = np.searchsorted(block_of, np.arange(n_blocks) + 1)
    perm_out, keys_out = [], []
    for b in range(n_blocks):
        lo, hi = int(starts[b]), int(ends[b])
        cnt = hi - lo
        pad = max(1, -(-cnt // et)) * et - cnt
        perm_out.append(sender_perm[lo:hi])
        keys_out.append(senders_sorted[lo:hi])
        if pad:
            fill_k = (senders_sorted[hi - 1] if cnt
                      else min(b * nb, num_nodes_pad - 1))
            perm_out.append(np.full(pad, pad_row, dtype=np.int32))
            keys_out.append(np.full(pad, fill_k, dtype=senders_sorted.dtype))
    perm_a = np.concatenate(perm_out)
    keys_a = np.concatenate(keys_out)
    extra = _round_up(len(perm_a), et) - len(perm_a)
    if extra:
        perm_a = np.concatenate([perm_a, np.full(extra, pad_row, np.int32)])
        keys_a = np.concatenate(
            [keys_a, np.full(extra, num_nodes_pad - 1, keys_a.dtype)])
    return perm_a.astype(np.int32), keys_a, True


def _align_edge_blocks(senders, receivers, edge_attr, num_nodes_pad, dtype):
    """Insert masked pad edges so each ALIGN_NODE_BLOCK-node block's edge
    range is a whole number of ALIGN_EDGE_TILE-edge tiles; every node block
    gets at least one tile. Pad edges repeat the block's last receiver (its
    first node when the block has no edge), with sender = receiver and zero
    features, so receivers stay ascending. The layout comes from the graph
    core (``native.align_blocks``, as JAX's padded.py:559-561); the result
    equals ``_align_edge_blocks_ref``'s, which also lays out a stream
    without edges (all pad slots: no row to index). The fine graph and the
    BSMS coarse levels are laid out by ``native.edge_layout`` instead; this
    is kept for ``parallel.spatial.pack_aligned_edges`` alone, whose shard
    streams carry global sender ids outside the layout's [0,
    num_nodes_pad) bound."""
    if len(receivers) == 0:
        return _align_edge_blocks_ref(senders, receivers, edge_attr,
                                      num_nodes_pad, dtype)
    nb, et = ALIGN_NODE_BLOCK, ALIGN_EDGE_TILE
    rows, tile_block, tile_first = native.align_blocks(
        receivers, num_nodes_pad, nb, et)
    valid = rows >= 0
    pad_slots = np.flatnonzero(~valid)
    # each block's pad receiver: its last receiver, else its first node
    n_blocks = num_nodes_pad // nb
    ends = np.searchsorted(receivers, np.arange(1, n_blocks + 1) * nb)
    starts = np.concatenate([[0], ends[:-1]])
    fill = np.where(ends > starts, receivers[np.maximum(ends - 1, 0)],
                    np.minimum(np.arange(n_blocks) * nb, num_nodes_pad - 1))
    fill = fill[tile_block[pad_slots // et]]
    s_slot = np.empty(len(rows), senders.dtype)
    r_slot = np.empty(len(rows), receivers.dtype)
    s_slot[valid], s_slot[pad_slots] = senders, fill
    r_slot[valid], r_slot[pad_slots] = receivers, fill
    ea = np.ascontiguousarray(edge_attr,
                              dtype=np.result_type(edge_attr.dtype, dtype))
    ea_slot = np.zeros((len(rows),) + ea.shape[1:], ea.dtype)
    if ea.size:
        # each row one item of a void view: one scatter pass, not per value
        row = np.dtype((np.void, ea[:1].nbytes))
        ea_slot.reshape(len(rows), -1).view(row)[:, 0][valid] = \
            ea.reshape(len(ea), -1).view(row)[:, 0]
    return s_slot, r_slot, ea_slot, valid, tile_block, tile_first


def _align_edge_blocks_ref(senders, receivers, edge_attr, num_nodes_pad,
                           dtype):
    """The plain version of _align_edge_blocks (numpy, a loop over the node
    blocks)."""
    nb, et = ALIGN_NODE_BLOCK, ALIGN_EDGE_TILE
    n_blocks = num_nodes_pad // nb
    block_of_edge = receivers // nb
    starts = np.searchsorted(block_of_edge, np.arange(n_blocks))
    ends = np.searchsorted(block_of_edge, np.arange(n_blocks) + 1)
    s_out, r_out, ea_out, valid = [], [], [], []
    tile_block, tile_first = [], []
    for b in range(n_blocks):
        lo, hi = int(starts[b]), int(ends[b])
        cnt = hi - lo
        n_tiles = max(1, -(-cnt // et))
        pad = n_tiles * et - cnt
        s_out.append(senders[lo:hi])
        r_out.append(receivers[lo:hi])
        ea_out.append(edge_attr[lo:hi])
        valid.append(np.ones(cnt, dtype=bool))
        if pad:
            fill_r = (receivers[hi - 1] if cnt
                      else min(b * nb, num_nodes_pad - 1))
            s_out.append(np.full(pad, fill_r, dtype=senders.dtype))
            r_out.append(np.full(pad, fill_r, dtype=receivers.dtype))
            ea_out.append(np.zeros((pad, edge_attr.shape[1]), dtype=dtype))
            valid.append(np.zeros(pad, dtype=bool))
        tile_block.extend([b] * n_tiles)
        tile_first.extend([1] + [0] * (n_tiles - 1))
    return (np.concatenate(s_out), np.concatenate(r_out),
            np.concatenate(ea_out), np.concatenate(valid),
            np.asarray(tile_block, np.int32), np.asarray(tile_first, np.int32))


def derive_tiles(receivers: torch.Tensor):
    """(tile_block, tile_first) from a block-aligned receiver stream: each
    tile's first receiver names its node block; pad tails point at the last
    pad node, i.e. the last block. The fused edge kernel derives the same."""
    tile_block = torch.div(receivers[::ALIGN_EDGE_TILE], ALIGN_NODE_BLOCK,
                           rounding_mode="floor").to(torch.int32)
    prev = torch.cat([tile_block.new_full((1,), -1), tile_block[:-1]])
    return tile_block, (tile_block != prev).to(torch.int32)
