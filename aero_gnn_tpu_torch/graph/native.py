"""ctypes bindings of the port's native host graph core (counterpart of
aero_gnn_tpu.graph.native).

``csrc/host/graphcore.cpp`` is built with g++ at first use
(``ops._build.host_library``, into the git-ignored ``_kernels_build/``); a
failed build raises, there is no quiet fallback. Its entry points:

  * the O(E + N) counting sorts and the block alignment of the JAX
    package's graph core (``sort_edges_by_receiver``, ``argsort_i32``,
    ``csr_offsets``, ``align_blocks``), used by ``graph.padded``,
    ``graph.hierarchy`` and ``parallel`` (``align_blocks`` by
    ``parallel.spatial`` alone);
  * ``balance_slots``, the BSMS hierarchy's greedy degree-balanced
    relabelling of coarse nodes (``graph.hierarchy.align_hierarchy``);
  * ``edge_layout``, a graph's whole padded edge layout in one pass (the
    receiver sort, the block alignment, the pad tail, the tiles, the
    sender stream): every block-aligned stream but ``parallel``'s shards,
    the fine graph's (``graph.padded.build_graph_batch``) and each BSMS
    coarse level's (``graph.hierarchy.align_host``);
  * ``chunk_plan``, the plan of a segment sum without long runs
    (``graph.padded.chunk_plan``: the per-graph pools, the BSMS unpool).

The versions they replace stay as the plain versions the tests hold them
to: ``np.lexsort``, a stable ``np.argsort``, ``np.searchsorted``,
``graph.padded._align_edge_blocks_ref``, ``graph.padded._edge_layout_ref``
(with ``_align_sender_stream_ref``, its aligned sender stream),
``graph.padded.chunk_plan_ref`` and
``graph.hierarchy._balance_block_slots_ref``.

Every pointer handed to the library is a contiguous array this module
made or checked; keys and sizes are checked against their
bound first, since the counting sorts index their count arrays with them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np

from aero_gnn_tpu_torch.ops import _build

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "gc_sort_edges_by_receiver": (
        [_I32P, _I32P, ctypes.c_int64, ctypes.c_int32, _I32P], None),
    "gc_argsort_i32": (
        [_I32P, ctypes.c_int64, ctypes.c_int32, _I32P], None),
    "gc_csr_offsets": (
        [_I32P, ctypes.c_int64, ctypes.c_int32, _I64P], None),
    "gc_align_blocks": (
        [_I32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
         ctypes.c_int32, _I32P, _I32P, _I32P, _I64P], ctypes.c_int64),
    "gc_balance_slots": (
        [_F64P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
         ctypes.c_int32, _I64P], ctypes.c_int32),
    "gc_edge_layout": (
        [_I32P, _I32P, _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
         ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _U8P,
         ctypes.c_int64, _I32P, _I32P, _U8P, _U8P, _I32P, _I32P, _I64P,
         _I32P, _I32P, _I64P], ctypes.c_int64),
    "gc_chunk_plan": (
        [_I32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
         ctypes.c_int64, _I32P, _I32P, _I32P], None),
}
_I32_MAX = np.iinfo(np.int32).max


def _function(symbol: str):
    fn = getattr(_build.host_library("graphcore"), symbol)
    fn.argtypes, fn.restype = _SIGNATURES[symbol]
    return fn


def _ptr(a: np.ndarray):
    return a.ctypes.data_as({np.dtype(np.int32): _I32P,
                             np.dtype(np.int64): _I64P,
                             np.dtype(np.float64): _F64P}[a.dtype])


def _bytes(a: np.ndarray):
    """A C-contiguous array's buffer as bytes."""
    return a.ctypes.data_as(_U8P)


def _bound(name: str, n: int) -> int:
    n = int(n)
    if not 0 <= n <= _I32_MAX:
        raise ValueError(f"{name}={n} outside [0, {_I32_MAX}]")
    return n


def _keys(name: str, a, bound: int) -> np.ndarray:
    """``a`` as contiguous int32, every value in [0, bound)."""
    a = np.asarray(a)
    if len(a) > _I32_MAX:
        raise ValueError(f"{name} has {len(a)} entries; int32 permutations "
                         f"hold at most {_I32_MAX}")
    if len(a) and (a.min() < 0 or a.max() >= bound):
        raise ValueError(f"{name} holds values outside [0, {bound})")
    return np.ascontiguousarray(a, dtype=np.int32)


def sort_edges_by_receiver(senders: np.ndarray, receivers: np.ndarray,
                           num_nodes: int) -> np.ndarray:
    """Stable receiver-major permutation (int32): (receivers[perm],
    senders[perm]) ascending, ties in edge order; ``np.lexsort((senders,
    receivers))``'s permutation. Ids must lie in [0, num_nodes)."""
    num_nodes = _bound("num_nodes", num_nodes)
    s = _keys("senders", senders, num_nodes)
    r = _keys("receivers", receivers, num_nodes)
    if s.shape != r.shape:
        raise ValueError(f"senders {s.shape} and receivers {r.shape} differ")
    perm = np.empty(len(s), dtype=np.int32)
    _function("gc_sort_edges_by_receiver")(_ptr(s), _ptr(r), len(s),
                                           num_nodes, _ptr(perm))
    return perm


def argsort_i32(keys: np.ndarray, num_keys: int) -> np.ndarray:
    """Stable argsort (int32) of keys in [0, num_keys); ``np.argsort(keys,
    kind="stable")``."""
    num_keys = _bound("num_keys", num_keys)
    k = _keys("keys", keys, num_keys)
    perm = np.empty(len(k), dtype=np.int32)
    _function("gc_argsort_i32")(_ptr(k), len(k), num_keys, _ptr(perm))
    return perm


def csr_offsets(sorted_ids: np.ndarray, num_segments: int) -> np.ndarray:
    """offsets[v] = the first index whose id is >= v, v in [0,
    num_segments] (int64); ``np.searchsorted(sorted_ids,
    np.arange(num_segments + 1))``."""
    num_segments = _bound("num_segments", num_segments)
    ids = np.ascontiguousarray(sorted_ids, dtype=np.int32)
    out = np.empty(num_segments + 1, dtype=np.int64)
    _function("gc_csr_offsets")(_ptr(ids), len(ids), num_segments, _ptr(out))
    return out


def align_blocks(receivers_sorted: np.ndarray, num_nodes_pad: int,
                 node_block: int, edge_tile: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The block-aligned layout of a receiver-sorted edge stream: (rows,
    tile_block, tile_first), int32. ``rows`` holds one entry per output
    slot, the source edge row or -1 for a pad slot; every node block of
    ``node_block`` nodes owns a whole number of ``edge_tile``-slot tiles,
    at least one, and ``tile_block`` / ``tile_first`` name each tile's block
    and whether it is the block's first."""
    if node_block <= 0 or edge_tile <= 0:
        raise ValueError(f"node_block={node_block} and edge_tile={edge_tile}"
                         " must be positive")
    num_nodes_pad = _bound("num_nodes_pad", num_nodes_pad)
    r = np.ascontiguousarray(receivers_sorted, dtype=np.int32)
    fn = _function("gc_align_blocks")
    null32, null64 = _I32P(), _I64P()
    args = (_ptr(r), len(r), num_nodes_pad, int(node_block), int(edge_tile))
    total = fn(*args, null32, null32, null32, null64)
    rows = np.empty(total, dtype=np.int32)
    tile_block = np.empty(total // edge_tile, dtype=np.int32)
    tile_first = np.empty(total // edge_tile, dtype=np.int32)
    n_tiles = ctypes.c_int64(0)
    fn(*args, _ptr(rows), _ptr(tile_block), _ptr(tile_first),
       ctypes.byref(n_tiles))
    k = int(n_tiles.value)
    return rows, tile_block[:k], tile_first[:k]


def balance_slots(weights: np.ndarray, n_blocks: int, nb: int,
                  reserve_last: bool = True) -> np.ndarray:
    """A slot in [0, n_blocks * nb) for each weighted item (int64) so that
    per-block weight sums are balanced: greedy min-load, heaviest first,
    the last slot (the pad-edge sink) reserved when ``reserve_last``;
    ``graph.hierarchy._balance_block_slots_ref``'s slots. Raises ValueError
    when the items exceed the capacity."""
    n_blocks, nb = _bound("n_blocks", n_blocks), _bound("nb", nb)
    if n_blocks < 1 or nb < 1 or n_blocks * nb > _I32_MAX:
        raise ValueError(f"n_blocks={n_blocks} and nb={nb} must be positive "
                         f"with n_blocks * nb <= {_I32_MAX}")
    w = np.ascontiguousarray(weights, dtype=np.float64)
    if w.ndim != 1 or not np.isfinite(w).all():
        raise ValueError("weights must be a 1-D array of finite values")
    slots = np.empty(len(w), dtype=np.int64)
    if _function("gc_balance_slots")(_ptr(w), len(w), n_blocks, nb,
                                     int(bool(reserve_last)), _ptr(slots)):
        raise ValueError(f"balance: {len(w)} items exceed capacity "
                         f"{n_blocks * nb - int(bool(reserve_last))}")
    return slots


def edge_layout(senders: np.ndarray, receivers: np.ndarray,
                edge_attr: np.ndarray, num_nodes_pad: int,
                num_edges_pad: Optional[int], node_block: int = 0,
                edge_tile: int = 0, align_map: bool = True,
                empty: Optional[Callable] = None) -> dict:
    """A graph's padded edge layout in one pass (``_edge_layout_ref``'s
    arrays in ``graph.padded``): ``senders``, ``receivers``, ``edge_attr``
    and ``edge_mask`` (the features' dtype) of ``num_edges_pad`` rows in
    stable receiver-major order, pad rows on the sink ``num_nodes_pad - 1``;
    ``sender_perm`` / ``senders_sorted``, the rows in a stable sort by
    sender, and ``senders_aligned``. With ``node_block`` > 0 the layout is
    block-aligned (``align_blocks``), the sender stream too when a row is
    masked, and ``tile_block`` / ``tile_first`` are set, and ``align_src``
    (int64) with ``align_map``; ``num_edges_pad`` None then takes the
    aligned row count. Ids must lie in [0, num_nodes_pad). ``empty(role,
    shape, dtype)`` allocates each output (an uninitialised array; a fresh
    one by default)."""
    align = node_block != 0
    num_nodes_pad = _bound("num_nodes_pad", num_nodes_pad)
    if num_nodes_pad < 1:
        raise ValueError("num_nodes_pad must hold the pad sink")
    if align:
        if node_block <= 0 or edge_tile <= 0:
            raise ValueError(f"node_block={node_block} and edge_tile="
                             f"{edge_tile} must be positive")
        if num_nodes_pad % node_block:
            raise ValueError(f"num_nodes_pad={num_nodes_pad} is not a "
                             f"multiple of node_block={node_block}")
        node_block, edge_tile = int(node_block), int(edge_tile)
    s = _keys("senders", senders, num_nodes_pad)
    r = _keys("receivers", receivers, num_nodes_pad)
    ea = np.ascontiguousarray(edge_attr)
    if s.shape != r.shape or ea.ndim != 2 or len(ea) != len(s):
        raise ValueError(f"senders {s.shape}, receivers {r.shape} and "
                         f"edge_attr {ea.shape} differ in rows")
    fn = _function("gc_edge_layout")
    args = (_ptr(s), _ptr(r), _bytes(ea), ea.shape[1] * ea.itemsize, len(s),
            num_nodes_pad)
    if num_edges_pad is None and align:  # the aligned row count
        num_edges_pad = fn(*args, 0, node_block, edge_tile, _U8P(), 0,
                           _I32P(), _I32P(), _U8P(), _U8P(), _I32P(),
                           _I32P(), _I64P(), _I32P(), _I32P(), _I64P())
    ep = _bound("num_edges_pad", num_edges_pad)
    one = np.ones(1, dtype=ea.dtype)
    if empty is None:
        def empty(role, shape, dtype):
            return np.empty(shape, dtype)
    out = dict(senders=empty("senders", ep, np.int32),
               receivers=empty("receivers", ep, np.int32),
               edge_attr=empty("edge_attr", (ep, ea.shape[1]), ea.dtype),
               edge_mask=empty("edge_mask", ep, ea.dtype))
    n_tiles = ep // edge_tile if align else 0
    tiles = (empty("tile_block", n_tiles, np.int32),
             empty("tile_first", n_tiles, np.int32))
    align_src = (empty("align_src", ep, np.int64) if align and align_map
                 else None)
    cap = ep + (num_nodes_pad // node_block) * edge_tile if align else ep
    sender_perm = empty("sender_perm", cap, np.int32)
    senders_sorted = empty("senders_sorted", cap, np.int32)
    info = np.zeros(2, np.int64)
    rows = fn(*args, ep, node_block, edge_tile, _bytes(one), one.nbytes,
              _ptr(out["senders"]), _ptr(out["receivers"]),
              _bytes(out["edge_attr"]), _bytes(out["edge_mask"]),
              _ptr(tiles[0]), _ptr(tiles[1]),
              _I64P() if align_src is None else _ptr(align_src),
              _ptr(sender_perm), _ptr(senders_sorted), _ptr(info))
    if align and (rows > ep or ep % edge_tile):
        raise ValueError(f"num_edges_pad={ep} incompatible with aligned "
                         f"edge count {rows} (tile {edge_tile})")
    if rows > ep:
        raise ValueError(f"num_edges_pad={ep} < num_edges={rows}")
    n = int(info[0])
    out.update(tile_block=tiles[0] if align else None,
               tile_first=tiles[1] if align else None, align_src=align_src,
               sender_perm=sender_perm[:n], senders_sorted=senders_sorted[:n],
               senders_aligned=bool(info[1]))
    return out


def chunk_plan(ids: np.ndarray, num_segments: int, size: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(perm, chunk, chunk_seg), int32: the rows in a stable sort by id,
    the chunk of each sorted row (each id's run cut into chunks of at most
    ``size`` rows), and the id of each chunk, ``num_segments - 1`` past the
    last, ceil(len(ids) / size) + num_segments in all
    (``graph.padded.chunk_plan_ref``'s). Ids must lie in [0,
    num_segments)."""
    num_segments = _bound("num_segments", num_segments)
    if size < 1:
        raise ValueError(f"size={size} must be positive")
    k = _keys("ids", ids, num_segments)
    n_chunk_seg = -(-len(k) // size) + num_segments
    perm = np.empty(len(k), np.int32)
    chunk = np.empty(len(k), np.int32)
    chunk_seg = np.empty(n_chunk_seg, np.int32)
    _function("gc_chunk_plan")(_ptr(k), len(k), num_segments, int(size),
                               n_chunk_seg, _ptr(perm), _ptr(chunk),
                               _ptr(chunk_seg))
    return perm, chunk, chunk_seg
