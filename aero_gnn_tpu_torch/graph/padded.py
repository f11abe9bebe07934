"""Padded, receiver-sorted graph container (counterpart of
aero_gnn_tpu.graph.padded).

Conventions the kernels and models rely on:

  * ``receivers`` is sorted ascending, so aggregation is a segment reduction
    over contiguous runs of rows;
  * pad edges point at the last pad node (``num_nodes_pad - 1``) on both
    endpoints and have ``edge_mask == 0``; pad nodes have ``node_mask == 0``;
  * with ``align_edges=True`` every ALIGN_NODE_BLOCK-node block owns a
    contiguous run of whole ALIGN_EDGE_TILE-row tiles (at least one), which
    is the layout the fused edge kernel (``ops.hopper_fused``) consumes.

Host-side construction is numpy; the result is a dataclass of tensors on
the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from aero_gnn_tpu_torch.device import DeviceLike, resolve_device

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

    @property
    def edges_aligned(self) -> bool:
        """True iff built with align_edges=True (the fused-kernel layout)."""
        return self.tile_block is not None

    @property
    def num_nodes_pad(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges_pad(self) -> int:
        return self.senders.shape[0]

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
    """Stable destination-major (receiver, then sender) permutation."""
    if len(senders) == 0:
        return np.zeros(0, dtype=np.int64)
    return np.lexsort((senders, receivers))


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
    device: DeviceLike = None,
) -> GraphBatch:
    """Sort edges by receiver, pad nodes/edges, route pad edges to the last
    pad node and (``align_edges``) pad every node block's edges to whole
    tiles. The tensors land on ``device`` (CUDA unless ``"cpu"``)."""
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

    perm = sort_edges_by_receiver(senders, receivers)
    senders, receivers = senders[perm], receivers[perm]
    edge_attr = edge_attr[perm]

    tile_block = tile_first = None
    edge_valid = np.ones(e, dtype=bool)
    if align_edges:
        senders, receivers, edge_attr, edge_valid, tile_block, tile_first = \
            _align_edge_blocks(senders, receivers, edge_attr, np_pad, dtype)
        e_aligned = senders.shape[0]
        if num_edges_pad is None:
            ep_pad = _round_up(e_aligned, ALIGN_EDGE_TILE)
        if ep_pad < e_aligned or ep_pad % ALIGN_EDGE_TILE:
            raise ValueError(
                f"num_edges_pad={ep_pad} incompatible with aligned edge "
                f"count {e_aligned} (tile {ALIGN_EDGE_TILE})")
        # the pad tail forms whole tiles assigned to the last node block
        n_tiles = ep_pad // ALIGN_EDGE_TILE
        last_block = np_pad // ALIGN_NODE_BLOCK - 1
        tb = np.full(n_tiles, last_block, dtype=np.int32)
        tf = np.zeros(n_tiles, dtype=np.int32)
        tb[: len(tile_block)] = tile_block
        tf[: len(tile_first)] = tile_first
        if len(tile_block) < n_tiles and (
                len(tile_block) == 0 or tile_block[-1] != last_block):
            tf[len(tile_block)] = 1
        tile_block, tile_first = tb, tf

    pad_node = np_pad - 1
    n_rows = senders.shape[0]
    s_p = np.full(ep_pad, pad_node, dtype=np.int32)
    r_p = np.full(ep_pad, pad_node, dtype=np.int32)
    s_p[:n_rows], r_p[:n_rows] = senders, receivers
    ea_p = np.zeros((ep_pad, edge_attr.shape[1]), dtype=dtype)
    ea_p[:n_rows] = edge_attr

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
    edge_mask = np.zeros(ep_pad, dtype=dtype)
    edge_mask[:n_rows] = edge_valid.astype(dtype)
    n_real_graphs = int(ng.max()) + 1 if n else 0
    graph_mask = np.zeros(num_graphs_pad, dtype=dtype)
    graph_mask[:n_real_graphs] = 1.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return GraphBatch(
        senders=t(s_p), receivers=t(r_p),
        x=t(pad_rows(x, np_pad)), edge_attr=t(ea_p),
        pos=t(pad_rows(pos, np_pad)), y=t(pad_rows(y, np_pad)),
        node_mask=t(node_mask), edge_mask=t(edge_mask),
        node_graph=t(ng_p), graph_mask=t(graph_mask),
        n_node=n, n_edge=e,
        tile_block=None if tile_block is None else t(tile_block),
        tile_first=None if tile_first is None else t(tile_first),
    )


def _align_edge_blocks(senders, receivers, edge_attr, num_nodes_pad, dtype):
    """Insert masked pad edges so each ALIGN_NODE_BLOCK-node block's edge
    range is a whole number of ALIGN_EDGE_TILE-edge tiles; every node block
    gets at least one tile. Pad edges repeat the block's last receiver (its
    first node when the block has no edge), with sender = receiver and zero
    features, so receivers stay ascending."""
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
