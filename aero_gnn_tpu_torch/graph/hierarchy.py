"""Multi-scale graph hierarchies for BSMS, built on the host (the port's own
copy of aero_gnn_tpu.graph.hierarchy).

A hierarchy is built once per mesh with numpy, collated and padded to
static sizes per batch; the model's forward is then segment reductions and
gathers over the precomputed index arrays. Two builder modes:

  * "stride"   — per graph, sort nodes by x-coordinate and group each
    consecutive ``stride`` nodes into one coarse node; coarse edges are the
    deduplicated (c_row, c_col) keys, self-loops retained;
  * "bistride" — BFS 2-colouring from a min-degree seed, the even-frontier
    nodes kept, coarse connectivity from the fine edges through the
    assignment.

One path makes a batch's levels: ``build_hierarchy_real`` (each sample's
unpadded levels, cached) -> ``collate_host`` (the batch's padded levels as
numpy arrays) -> with the aligned layout ``align_host`` (every level
block-aligned for the fused kernels, as ``graph.padded.build_graph_batch(
align_edges=True)`` does the fine graph: each coarse edge stream laid out
by the same one pass of the native graph core, ``native.edge_layout``).
``collate_hierarchies`` and ``align_hierarchy`` are their forms over
``HierarchyLevel``: a dataclass of tensors (int32 index fields, float32
weights and masks, as the JAX package stores them) plus host ints, on
``device`` (CUDA unless ``"cpu"``). The alignment's greedy block balance
(``native.balance_slots``; the plain version ``_balance_block_slots_ref``)
and its stable sorts of bounded int32 keys run on the graph core too. A
level's arrays stay on the host until its one copy to the device.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional

import numpy as np
import torch

from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.graph import native
from aero_gnn_tpu_torch.graph.padded import (
    ALIGN_EDGE_TILE,
    ALIGN_NODE_BLOCK,
    _round_up,
    chunk_plan,
    sort_edges_by_receiver,
)
from aero_gnn_tpu_torch.utils.profiling import annotate, count

_INT_FIELDS = ("fine_to_coarse", "edge_to_coarse", "senders", "receivers",
               "sender_perm", "senders_sorted", "node_graph", "tile_block",
               "tile_first", "node_pool_perm", "node_pool_sorted",
               "edge_pool_perm", "edge_pool_sorted", "unpool_chunk",
               "unpool_chunk_node")


@dataclasses.dataclass(frozen=True)
class HierarchyLevel:
    """Transition fine level s -> coarse level s+1 plus the coarse graph.

    Nf/Ef = padded fine node/edge counts, Nc/Ec = padded coarse counts. Pad
    entries route to the last pad slot of their target so masked segment
    ops stay exact. Field meanings as in the JAX package."""

    fine_to_coarse: torch.Tensor  # i32[Nf]
    edge_to_coarse: torch.Tensor  # i32[Ef]
    senders: torch.Tensor  # i32[Ec], coarse graph, receiver-sorted
    receivers: torch.Tensor  # i32[Ec]
    sender_perm: torch.Tensor  # i32[Ec_s]
    senders_sorted: torch.Tensor  # i32[Ec_s]
    node_mask: torch.Tensor  # f32[Nc]
    edge_mask: torch.Tensor  # f32[Ec]
    node_graph: torch.Tensor  # i32[Nc]
    n_node: int
    n_edge: int
    node_weights: torch.Tensor  # f32[Nf] geometric mass of each fine node
    edge_weights: torch.Tensor  # f32[Ef] geometric weight of each fine edge
    tile_block: Optional[torch.Tensor] = None  # i32[T], aligned levels
    tile_first: Optional[torch.Tensor] = None  # i32[T]
    # WeightedEdgeConv operator on the FINE streams (transfer="weighted")
    rep_mask: Optional[torch.Tensor] = None  # f32[Nf]
    conv_self: Optional[torch.Tensor] = None  # f32[Nf]
    conv_edge: Optional[torch.Tensor] = None  # f32[Ef]
    # conv_edge through the reverse-edge map; None if the stream is not
    # symmetric (then the adjoint runs on the sender-sorted stream)
    conv_edge_t: Optional[torch.Tensor] = None  # f32[Ef]
    node_pool_perm: Optional[torch.Tensor] = None  # i32[Nf]
    node_pool_sorted: Optional[torch.Tensor] = None  # i32[Nf]
    edge_pool_perm: Optional[torch.Tensor] = None  # i32[Ef]
    edge_pool_sorted: Optional[torch.Tensor] = None  # i32[Ef]
    # rows of each sorted pool stream before the run of pad rows keyed by
    # a pad last coarse id (_pool_fields); the whole stream where the
    # last coarse id is real
    node_pool_live: Optional[int] = None
    edge_pool_live: Optional[int] = None
    # the unpool's chunk plan over node_pool_perm (graph.padded.chunk_plan:
    # the chunk of each sorted fine row, the coarse node of each chunk)
    unpool_chunk: Optional[torch.Tensor] = None  # i32[Nf]
    unpool_chunk_node: Optional[torch.Tensor] = None  # i32[C]

    @property
    def edges_aligned(self) -> bool:
        """True iff the coarse streams carry the block-aligned layout."""
        return self.tile_block is not None

    @property
    def unpool_chunks(self):
        """(node_pool_perm, unpool_chunk, unpool_chunk_node): the plan of
        the unpool's ``ops.gather_chunked``; None where not built."""
        if self.unpool_chunk is None:
            return None
        return (self.node_pool_perm, self.unpool_chunk,
                self.unpool_chunk_node)

    @property
    def num_coarse_nodes_pad(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_coarse_edges_pad(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_mask.device

    def to(self, device: DeviceLike) -> "HierarchyLevel":
        dev = resolve_device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _host(**fields) -> dict:
    """Level fields on the host as a HierarchyLevel stores them: numpy
    index fields int32, the other arrays float32, contiguous (a cast only
    where the dtype differs); other values as given."""
    out = {}
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            dt = np.int32 if k in _INT_FIELDS else np.float32
            v = np.ascontiguousarray(v.astype(dt, copy=False))
        out[k] = v
    return out


def _to_level(device: torch.device, host: dict) -> HierarchyLevel:
    """A HierarchyLevel on ``device`` from ``_host`` fields: one copy of
    each array."""
    return HierarchyLevel(**{
        k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v
        for k, v in host.items()})


def _level(device: torch.device, **fields) -> HierarchyLevel:
    """A HierarchyLevel from numpy fields: index fields int32, the rest
    float32, on ``device``."""
    return _to_level(device, _host(**fields))


def _fields(level: HierarchyLevel) -> dict:
    """Every field of ``level``, its tensors as host numpy arrays."""
    out = {}
    for f in dataclasses.fields(level):
        v = getattr(level, f.name)
        out[f.name] = (v.detach().cpu().numpy()
                       if isinstance(v, torch.Tensor) else v)
    return out


# ---------------------------------------------------------------------------
# host-side builders (numpy)
# ---------------------------------------------------------------------------

def _pool_live(ids_sorted: np.ndarray, coarse_mask: np.ndarray) -> int:
    """Rows of a sorted pool stream before its pad rows: every pad fine row
    routes to the last coarse slot, so where that slot is itself a pad (no
    real fine row maps there) its run ends the stream and adds nothing to
    a masked operand; else the whole stream."""
    n = coarse_mask.shape[0]
    if coarse_mask[-1] != 0:
        return len(ids_sorted)
    return int(np.searchsorted(ids_sorted, n - 1))


def _pool_fields(host: dict) -> dict:
    """The sorted-pooling fields of a level's ``_host`` fields: the stable
    argsorts of the final fine_to_coarse / edge_to_coarse, the rows of each
    before its pad tail, and the unpool's chunk plan (its backward sums
    every fine row, the pad tail's long run too, in chunks)."""
    f2c, e2c = host["fine_to_coarse"], host["edge_to_coarse"]
    node_mask, edge_mask = host["node_mask"], host["edge_mask"]
    npp, chunk, chunk_node = chunk_plan(f2c, len(node_mask))
    epp = native.argsort_i32(e2c, len(edge_mask))
    nps, eps = f2c[npp].astype(np.int32), e2c[epp]
    return dict(node_pool_perm=npp, node_pool_sorted=nps,
                edge_pool_perm=epp, edge_pool_sorted=eps,
                node_pool_live=_pool_live(nps, node_mask),
                edge_pool_live=_pool_live(eps, edge_mask),
                unpool_chunk=chunk, unpool_chunk_node=chunk_node)



def _geometric_weights(senders: np.ndarray, receivers: np.ndarray,
                       pos: Optional[np.ndarray], num_nodes: int) -> tuple:
    """Node mass = half the total incident edge length, edge weight = edge
    length; uniform without positions. float64 (node_w, edge_w)."""
    if pos is not None and len(senders):
        el = np.linalg.norm(
            pos[senders].astype(np.float64) - pos[receivers], axis=1)
        el = np.maximum(el, 1e-12)
        nw = np.zeros(num_nodes, dtype=np.float64)
        np.add.at(nw, receivers, el / 2.0)
        nw = np.maximum(nw, 1e-12)
    else:
        el = np.ones(len(senders), dtype=np.float64)
        nw = np.ones(num_nodes, dtype=np.float64)
    return nw, el


def _conv_weights(senders: np.ndarray, receivers: np.ndarray,
                  node_w: np.ndarray, num_nodes: int) -> tuple:
    """Receiver-normalised WeightedEdgeConv weights: conv_self[i] =
    w_i/denom_i, conv_edge[e] = w_send(e)/denom_recv(e); rows sum to 1."""
    denom = node_w.astype(np.float64).copy()
    np.add.at(denom, receivers, node_w[senders])
    denom = np.maximum(denom, 1e-12)
    conv_self = node_w / denom
    conv_edge = node_w[senders] / denom[receivers]
    return conv_self, conv_edge


def _reverse_edge_map(senders: np.ndarray,
                      receivers: np.ndarray) -> np.ndarray:
    """rev[i] = row of the opposite edge, -1 where none; self-loops map to
    themselves (at most one edge per (s, r) pair)."""
    if not len(senders):
        return np.zeros(0, np.int64)
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    n = int(max(s.max(), r.max())) + 1
    key_fwd = s * n + r
    order = np.argsort(key_fwd, kind="stable")
    key_rev = r * n + s
    pos = np.searchsorted(key_fwd[order], key_rev)
    cand = order[np.clip(pos, 0, len(order) - 1)]
    return np.where(key_fwd[cand] == key_rev, cand, -1)


def _conv_edge_transposed(conv_edge: np.ndarray, senders: np.ndarray,
                          receivers: np.ndarray) -> Optional[np.ndarray]:
    """conv_edge[rev(e)]; None when the stream is not symmetric."""
    rev = _reverse_edge_map(senders, receivers)
    if len(rev) and (rev < 0).any():
        return None
    return np.asarray(conv_edge)[rev] if len(rev) else np.zeros(0)


def _rep_mask_first(fine_to_coarse: np.ndarray, num_nodes: int) -> np.ndarray:
    """1.0 at the first (stable-order) fine node of each coarse segment."""
    mask = np.zeros(num_nodes, dtype=np.float64)
    if num_nodes:
        order = np.argsort(fine_to_coarse[:num_nodes], kind="stable")
        sorted_ids = fine_to_coarse[order]
        first = np.ones(num_nodes, dtype=bool)
        first[1:] = sorted_ids[1:] != sorted_ids[:-1]
        mask[order[first]] = 1.0
    return mask


def _assign_stride(pos: np.ndarray, node_graph: np.ndarray,
                   stride: int) -> tuple:
    """Per graph, rank nodes by x then group by ``rank // stride``. Returns
    (fine_to_coarse, coarse_node_graph, rep_mask), rep = the min-x member."""
    n = pos.shape[0]
    fine_to_coarse = np.empty(n, dtype=np.int64)
    rep_mask = np.zeros(n, dtype=np.float64)
    coarse_graph_ids: List[np.ndarray] = []
    offset = 0
    for gid in np.unique(node_graph):
        idx = np.nonzero(node_graph == gid)[0]
        order = np.argsort(pos[idx, 0], kind="stable")
        ranks = np.empty(len(idx), dtype=np.int64)
        ranks[order] = np.arange(len(idx))
        local = ranks // stride
        n_coarse = int(local.max()) + 1 if len(idx) else 0
        fine_to_coarse[idx] = local + offset
        rep_mask[idx[ranks % stride == 0]] = 1.0
        coarse_graph_ids.append(np.full(n_coarse, gid, dtype=np.int64))
        offset += n_coarse
    coarse_node_graph = (np.concatenate(coarse_graph_ids)
                         if coarse_graph_ids else np.zeros(0, np.int64))
    return fine_to_coarse, coarse_node_graph, rep_mask


def _csr_expand(front: np.ndarray, indptr: np.ndarray, deg: np.ndarray,
                r_sorted: np.ndarray) -> tuple:
    """The CSR adjacency rows of ``front`` concatenated: (neighbors, owner),
    owner[k] = the index into ``front`` whose row gave neighbors[k]."""
    cnt = deg[front]
    total = int(cnt.sum())
    if total == 0:
        return (np.empty(0, dtype=r_sorted.dtype),
                np.empty(0, dtype=np.int64))
    excl = np.cumsum(cnt) - cnt
    base = np.repeat(indptr[front] - excl, cnt)
    nbrs = r_sorted[base + np.arange(total)]
    owner = np.repeat(np.arange(len(front), dtype=np.int64), cnt)
    return nbrs, owner


def _assign_bistride(senders: np.ndarray, receivers: np.ndarray,
                     node_graph: np.ndarray, num_nodes: int) -> tuple:
    """Bi-stride assignment: BFS 2-colouring per graph from the min-degree
    lowest-index seed of each component; kept (even-frontier) nodes become
    coarse nodes, each dropped node attaches to its minimum-index kept
    neighbour. Returns (fine_to_coarse, coarse_node_graph, rep_mask)."""
    order = np.argsort(senders, kind="stable")
    s_sorted, r_sorted = senders[order], receivers[order]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, s_sorted + 1, 1)
    indptr = np.cumsum(indptr)
    deg = np.diff(indptr)

    color = np.full(num_nodes, -1, dtype=np.int64)  # 0 = kept, 1 = dropped
    for gid in np.unique(node_graph):
        nodes = np.nonzero(node_graph == gid)[0]
        remaining = nodes
        while len(remaining):
            dmin = deg[remaining].min()
            seed = int(remaining[deg[remaining] == dmin].min())
            color[seed] = 0
            frontier = np.array([seed], dtype=np.int64)
            parity = 0
            while len(frontier):
                nbrs, _ = _csr_expand(frontier, indptr, deg, r_sorted)
                nbrs = nbrs[color[nbrs] == -1]
                if not len(nbrs):
                    break
                frontier = np.unique(nbrs)
                parity ^= 1
                color[frontier] = parity
            remaining = remaining[color[remaining] == -1]
    kept = np.nonzero(color == 0)[0]
    coarse_id_of = np.full(num_nodes, -1, dtype=np.int64)
    kept_sorted = kept[np.lexsort((kept, node_graph[kept]))]
    coarse_id_of[kept_sorted] = np.arange(len(kept_sorted))
    coarse_node_graph = node_graph[kept_sorted].astype(np.int64)

    fine_to_coarse = np.full(num_nodes, -1, dtype=np.int64)
    fine_to_coarse[kept] = coarse_id_of[kept]
    dropped = np.nonzero(color != 0)[0]
    if len(dropped):
        nbrs, owner = _csr_expand(dropped, indptr, deg, r_sorted)
        val = np.where(color[nbrs] == 0, nbrs, num_nodes)
        best = np.full(len(dropped), num_nodes, dtype=np.int64)
        cnt = deg[dropped]
        nz = cnt > 0
        if len(val):
            starts = (np.cumsum(cnt) - cnt)[nz]
            best[nz] = np.minimum.reduceat(val, starts)
        has = best < num_nodes
        fine_to_coarse[dropped[has]] = coarse_id_of[best[has]]
        # isolated dropped nodes attach to the first coarse node of their
        # own graph
        iso = dropped[~has]
        if len(iso):
            g = node_graph[iso]
            first_in_graph = np.searchsorted(coarse_node_graph, g)
            bad = (first_in_graph >= len(coarse_node_graph))
            ok_idx = np.where(bad, 0, first_in_graph)
            bad |= coarse_node_graph[ok_idx] != g
            if bad.any():
                raise ValueError(
                    f"bistride pooling: graph {g[bad][0]} kept no "
                    "coarse nodes")
            fine_to_coarse[iso] = first_in_graph
    rep_mask = np.zeros(num_nodes, dtype=np.float64)
    rep_mask[kept] = 1.0
    return fine_to_coarse, coarse_node_graph, rep_mask


def _coarse_edges(senders: np.ndarray, receivers: np.ndarray,
                  fine_to_coarse: np.ndarray, num_coarse: int) -> tuple:
    """Deduplicated (c_row, c_col) pairs sorted by key, self-loops kept:
    (c_senders, c_receivers, edge_to_coarse_edge)."""
    c_row = fine_to_coarse[senders]
    c_col = fine_to_coarse[receivers]
    keys = c_row * max(num_coarse, 1) + c_col
    unique_keys, inverse = np.unique(keys, return_inverse=True)
    c_senders = (unique_keys // max(num_coarse, 1)).astype(np.int64)
    c_receivers = (unique_keys % max(num_coarse, 1)).astype(np.int64)
    return c_senders, c_receivers, inverse


def _assign(mode: str, senders, receivers, node_graph, num_nodes, pos,
            stride: int) -> tuple:
    if mode == "stride":
        if pos is None:
            pos = np.arange(num_nodes, dtype=np.float64)[:, None]
        return _assign_stride(pos, node_graph, stride)
    if mode == "bistride":
        return _assign_bistride(senders, receivers, node_graph, num_nodes)
    raise ValueError(f"Unknown hierarchy mode: {mode}")


def build_hierarchy_real(
    *,
    senders: np.ndarray,
    receivers: np.ndarray,
    node_graph: np.ndarray,
    num_nodes: int,
    pos: Optional[np.ndarray] = None,
    num_scales: int,
    mode: str = "stride",
    stride: int = 2,
) -> List[dict]:
    """Unpadded per-level hierarchy arrays (cached per sample, collated per
    batch). Each level dict: {fine_to_coarse, edge_to_coarse, senders,
    receivers, node_graph, num_nodes, num_edges, num_fine_nodes,
    num_fine_edges, pos, node_weights, edge_weights, rep_mask, conv_self,
    conv_edge, conv_edge_t}; coarse edges receiver-sorted."""
    levels: List[dict] = []
    perm0 = sort_edges_by_receiver(np.asarray(senders),
                                   np.asarray(receivers))
    cur_s = np.asarray(senders, dtype=np.int64)[perm0]
    cur_r = np.asarray(receivers, dtype=np.int64)[perm0]
    cur_ng = np.asarray(node_graph, dtype=np.int64)
    cur_n = num_nodes
    cur_pos = None if pos is None else np.asarray(pos, dtype=np.float64)
    for _ in range(num_scales - 1):
        f2c, c_ng, rep = _assign(mode, cur_s, cur_r, cur_ng, cur_n, cur_pos,
                                 stride)
        n_coarse = len(c_ng)
        c_s, c_r, e2c = _coarse_edges(cur_s, cur_r, f2c, n_coarse)
        perm = sort_edges_by_receiver(c_s, c_r)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        c_s, c_r, e2c = c_s[perm], c_r[perm], inv[e2c]
        c_pos = None
        if cur_pos is not None and n_coarse > 0:
            c_pos = np.zeros((n_coarse, cur_pos.shape[1]))
            cnt = np.zeros(n_coarse)
            np.add.at(c_pos, f2c, cur_pos)
            np.add.at(cnt, f2c, 1.0)
            c_pos /= np.maximum(cnt, 1.0)[:, None]
        nw, ew = _geometric_weights(cur_s, cur_r, cur_pos, cur_n)
        cself, cedge = _conv_weights(cur_s, cur_r, nw, cur_n)
        levels.append({
            "fine_to_coarse": f2c, "edge_to_coarse": e2c,
            "senders": c_s, "receivers": c_r, "node_graph": c_ng,
            "num_nodes": n_coarse, "num_edges": len(c_s),
            "num_fine_nodes": cur_n, "num_fine_edges": len(cur_s),
            "pos": c_pos, "node_weights": nw, "edge_weights": ew,
            "rep_mask": rep, "conv_self": cself, "conv_edge": cedge,
            "conv_edge_t": _conv_edge_transposed(cedge, cur_s, cur_r),
        })
        cur_s, cur_r, cur_ng, cur_n, cur_pos = c_s, c_r, c_ng, n_coarse, c_pos
    return levels


def collate_hierarchies(
    per_sample: List[List[dict]],
    *,
    num_fine_nodes_pad: int,
    num_fine_edges_pad: int,
    pad_plan: List[tuple],
    dtype=np.float32,
    device: DeviceLike = None,
) -> List[HierarchyLevel]:
    """Merge per-sample real hierarchies into padded batch levels
    (``collate_host``'s, with their sorted-pooling fields) on ``device``."""
    dev = resolve_device(device)
    return [_level(dev, **host, **_pool_fields(host))
            for host in collate_host(
                per_sample, num_fine_nodes_pad=num_fine_nodes_pad,
                num_fine_edges_pad=num_fine_edges_pad, pad_plan=pad_plan,
                dtype=dtype)]


def collate_host(per_sample: List[List[dict]], *, num_fine_nodes_pad: int,
                 num_fine_edges_pad: int, pad_plan: List[tuple],
                 dtype=np.float32) -> List[dict]:
    """Per-sample real hierarchies (``build_hierarchy_real``) merged into
    padded batch levels, as ``_host`` fields without the sorted-pooling
    fields (``align_host`` builds its own): coarse ids of sample g offset by
    the coarse counts of samples < g at every level, so each level's real
    coarse edges stay in (receiver, sender) order; ``pad_plan[s] =
    (Nc_pad, Ec_pad)``."""
    num_scales_m1 = len(per_sample[0])
    out: List[dict] = []
    nf_pad, ef_pad = num_fine_nodes_pad, num_fine_edges_pad
    for s in range(num_scales_m1):
        nc_pad, ec_pad = pad_plan[s]
        f2c_p = np.full(nf_pad, nc_pad - 1, dtype=np.int32)
        e2c_p = np.full(ef_pad, ec_pad - 1, dtype=np.int32)
        cs_p = np.full(ec_pad, nc_pad - 1, dtype=np.int32)
        cr_p = np.full(ec_pad, nc_pad - 1, dtype=np.int32)
        nm = np.zeros(nc_pad, dtype=dtype)
        em = np.zeros(ec_pad, dtype=dtype)
        ng_p = np.zeros(nc_pad, dtype=np.int32)
        nw = np.zeros(nf_pad, dtype=dtype)
        ew = np.zeros(ef_pad, dtype=dtype)
        rep_p = np.zeros(nf_pad, dtype=dtype)
        cself_p = np.zeros(nf_pad, dtype=dtype)
        cedge_p = np.zeros(ef_pad, dtype=dtype)
        cedge_t_p = np.zeros(ef_pad, dtype=dtype)
        all_sym = True
        fn_off = fe_off = cn_off = ce_off = 0
        for gi, levels in enumerate(per_sample):
            lvl = levels[s]
            nf, ef = lvl["num_fine_nodes"], lvl["num_fine_edges"]
            nc, ec = lvl["num_nodes"], lvl["num_edges"]
            f2c_p[fn_off:fn_off + nf] = lvl["fine_to_coarse"] + cn_off
            e2c_p[fe_off:fe_off + ef] = lvl["edge_to_coarse"] + ce_off
            cs_p[ce_off:ce_off + ec] = lvl["senders"] + cn_off
            cr_p[ce_off:ce_off + ec] = lvl["receivers"] + cn_off
            nm[cn_off:cn_off + nc] = 1.0
            em[ce_off:ce_off + ec] = 1.0
            ng_p[cn_off:cn_off + nc] = gi
            nw[fn_off:fn_off + nf] = lvl.get(
                "node_weights", np.ones(nf))[:nf]
            ew[fe_off:fe_off + ef] = lvl.get(
                "edge_weights", np.ones(ef))[:ef]
            rep = lvl.get("rep_mask")
            if rep is None:
                rep = _rep_mask_first(lvl["fine_to_coarse"], nf)
            rep_p[fn_off:fn_off + nf] = rep[:nf]
            cself_p[fn_off:fn_off + nf] = lvl.get(
                "conv_self", np.ones(nf))[:nf]
            cedge_p[fe_off:fe_off + ef] = lvl.get(
                "conv_edge", np.zeros(ef))[:ef]
            ct = lvl.get("conv_edge_t")
            if ct is None:
                all_sym = False
            else:
                cedge_t_p[fe_off:fe_off + ef] = ct[:ef]
            fn_off += nf
            fe_off += ef
            cn_off += nc
            ce_off += ec
        if cn_off >= nc_pad or ce_off > ec_pad:
            raise ValueError(
                f"hierarchy pad_plan level {s} too small: need "
                f"({cn_off + 1}, {ce_off}), have ({nc_pad}, {ec_pad})")
        sperm = native.argsort_i32(cs_p, nc_pad)
        out.append(_host(
            fine_to_coarse=f2c_p, edge_to_coarse=e2c_p, senders=cs_p,
            receivers=cr_p, sender_perm=sperm, senders_sorted=cs_p[sperm],
            node_mask=nm, edge_mask=em, node_graph=ng_p, n_node=cn_off,
            n_edge=ce_off, node_weights=nw, edge_weights=ew,
            rep_mask=rep_p, conv_self=cself_p, conv_edge=cedge_p,
            conv_edge_t=cedge_t_p if all_sym else None))
        nf_pad, ef_pad = nc_pad, ec_pad
    return out


def _balance_block_slots_ref(weights: np.ndarray, n_blocks: int, nb: int,
                             reserve_last: bool = True) -> np.ndarray:
    """The plain version of ``native.balance_slots`` (a Python heap loop):
    a slot in [0, n_blocks*nb) for each weighted item so that per-block
    weight sums are balanced (greedy min-load, heaviest first); the last
    slot (the pad-edge sink) is reserved when ``reserve_last``."""
    n = len(weights)
    caps = np.full(n_blocks, nb, np.int64)
    if reserve_last:
        caps[-1] -= 1
    if n > int(caps.sum()):
        raise ValueError(
            f"balance: {n} items exceed capacity {int(caps.sum())}")
    order = np.argsort(-weights, kind="stable")
    heap = [(0.0, b) for b in range(n_blocks)]
    heapq.heapify(heap)
    count = np.zeros(n_blocks, np.int64)
    slots = np.empty(n, np.int64)
    for i in order:
        while True:
            load, b = heapq.heappop(heap)
            if count[b] < caps[b]:
                break
        slots[i] = b * nb + count[b]
        count[b] += 1
        if count[b] < caps[b]:
            heapq.heappush(heap, (load + float(weights[i]), b))
    return slots


def align_hierarchy(
    levels: List[HierarchyLevel],
    align_src0: Optional[np.ndarray] = None,
    *,
    edge_pad_targets: Optional[List[int]] = None,
    balance_blocks: bool = True,
    device: DeviceLike = None,
) -> List[HierarchyLevel]:
    """Block-align EVERY level for the fused kernels, level by level:

      1. level s's fine-row artifacts follow the alignment of the stream
         they index (level 0: ``align_src0`` from build_graph_batch(
         return_align_map=True); level s>0: the alignment given to level
         s-1's coarse stream);
      2. (``balance_blocks``) coarse node ids relabelled so per-block
         degree sums are even, the pad sink pinned at the last slot;
      3. the coarse node padding extended to a block multiple and the
         coarse streams laid out in whole tiles per node block, the
         sender-sorted view too, in one pass of the graph core
         (``native.edge_layout``, as ``build_graph_batch`` lays out the
         fine stream).

    ``edge_pad_targets[s]`` optionally fixes the aligned coarse edge count
    of level s (a tile multiple at least the aligned stream's). The levels
    land on ``device`` (CUDA unless ``"cpu"``)."""
    return align_host([_fields(lv) for lv in levels], align_src0,
                      edge_pad_targets=edge_pad_targets,
                      balance_blocks=balance_blocks, device=device)


def align_host(
    levels: List[dict],
    align_src0: Optional[np.ndarray] = None,
    *,
    edge_pad_targets: Optional[List[int]] = None,
    balance_blocks: bool = True,
    device: DeviceLike = None,
) -> List[HierarchyLevel]:
    """align_hierarchy over levels given as ``_host`` fields (the
    sorted-pooling fields may be absent: they are built anew). Reads its
    inputs and writes none of them; each level's arrays are copied to
    ``device`` once, at the end of its alignment. Counts
    ``hierarchy.levels_balanced`` once for each level the balance
    relabels."""
    dev = resolve_device(device)
    NB, ET = ALIGN_NODE_BLOCK, ALIGN_EDGE_TILE
    out: List[HierarchyLevel] = []
    prev_src = None if align_src0 is None else np.asarray(align_src0)
    prev_node_map: Optional[np.ndarray] = None
    prev_nf_new: Optional[int] = None
    for s, level in enumerate(levels):
        f2c = level["fine_to_coarse"]
        e2c = level["edge_to_coarse"]
        nw = level["node_weights"]
        ew = level["edge_weights"]
        has_conv = level["conv_edge"] is not None
        rep = level["rep_mask"] if has_conv else np.zeros_like(nw)
        cself = level["conv_self"] if has_conv else np.zeros_like(nw)
        cedge = level["conv_edge"] if has_conv else np.zeros_like(ew)
        cedge_t = level["conv_edge_t"]
        node_mask = level["node_mask"]
        node_graph = level["node_graph"]
        nc_pad = len(node_mask)
        ec_pad = len(level["edge_mask"])

        # ---- 1. re-index fine rows through the previous alignment ----
        if prev_src is not None:
            ok = prev_src >= 0
            idx = np.where(ok, prev_src, 0)
            e2c = np.where(ok, e2c[idx], ec_pad - 1).astype(np.int32)
            ew = np.where(ok, ew[idx], 0.0).astype(ew.dtype)
            cedge = np.where(ok, cedge[idx], 0.0).astype(cedge.dtype)
            if cedge_t is not None:
                cedge_t = np.where(ok, cedge_t[idx],
                                   0.0).astype(cedge_t.dtype)
        if prev_node_map is not None:
            f2c_new = np.full(prev_nf_new, nc_pad - 1, f2c.dtype)
            nw_new = np.zeros(prev_nf_new, nw.dtype)
            rep_new = np.zeros(prev_nf_new, rep.dtype)
            cself_new = np.zeros(prev_nf_new, cself.dtype)
            f2c_new[prev_node_map] = f2c[:len(prev_node_map)]
            nw_new[prev_node_map] = nw[:len(prev_node_map)]
            rep_new[prev_node_map] = rep[:len(prev_node_map)]
            cself_new[prev_node_map] = cself[:len(prev_node_map)]
            f2c, nw, rep, cself = f2c_new, nw_new, rep_new, cself_new
        elif prev_nf_new is not None and prev_nf_new > len(f2c):
            extra = prev_nf_new - len(f2c)
            f2c = np.concatenate(
                [f2c, np.full(extra, nc_pad - 1, f2c.dtype)])
            nw = np.concatenate([nw, np.zeros(extra, nw.dtype)])
            rep = np.concatenate([rep, np.zeros(extra, rep.dtype)])
            cself = np.concatenate([cself, np.zeros(extra, cself.dtype)])

        # ---- 2a. extend coarse node padding to a block multiple ----
        nc2 = max(_round_up(nc_pad, NB), NB)
        if nc2 != nc_pad:
            node_mask = np.concatenate(
                [node_mask, np.zeros(nc2 - nc_pad, node_mask.dtype)])
            fill_g = node_graph[-1] if len(node_graph) else 0
            node_graph = np.concatenate(
                [node_graph, np.full(nc2 - nc_pad, fill_g,
                                     node_graph.dtype)])

        n_real = int(level["n_edge"])
        s_real = level["senders"][:n_real]
        r_real = level["receivers"][:n_real]
        nc_real = int(level["n_node"])

        # ---- 2b. degree-balanced coarse node relabelling ----
        node_map: Optional[np.ndarray] = None  # old coarse id -> new id
        if balance_blocks and nc_real > 0:
            deg = (np.bincount(r_real, minlength=nc_pad)
                   + np.bincount(s_real, minlength=nc_pad))
            node_map = np.empty(nc_pad, np.int64)
            node_map[:nc_real] = native.balance_slots(
                deg[:nc_real].astype(np.float64), nc2 // NB, NB)
            count("hierarchy.levels_balanced")
            used = np.zeros(nc2, bool)
            used[node_map[:nc_real]] = True
            free = np.flatnonzero(~used)  # the unused slots, ascending
            take = nc_pad - nc_real
            node_map[nc_real:] = free[-take:] if take else free[:0]
            if nc_real >= nc_pad:
                raise ValueError(
                    "align_hierarchy(balance_blocks=True) requires a pad "
                    f"sink node (nc_real={nc_real} == nc_pad={nc_pad})")
            node_map[nc_pad - 1] = nc2 - 1
            f2c = node_map[np.clip(f2c, 0, nc_pad - 1)].astype(f2c.dtype)
            s_real = node_map[s_real]
            r_real = node_map[r_real]
            nm2 = np.zeros(nc2, node_mask.dtype)
            ng2 = np.full(nc2, node_graph[-1] if len(node_graph) else 0,
                          node_graph.dtype)
            nm2[node_map[:nc_real]] = 1.0
            ng2[node_map] = node_graph[:nc_pad]
            node_mask, node_graph = nm2, ng2
            # np.lexsort((s_real, r_real))'s permutation
            sort_perm = native.sort_edges_by_receiver(s_real, r_real, nc2)
        else:
            sort_perm = np.arange(n_real, dtype=np.int64)

        # ---- 2c. lay out the coarse edge stream ----
        # the layout puts the real edges in stable (receiver, sender) order,
        # which is sort_perm's (the relabelled edges' sort, or without the
        # balance their own: collate_host joins each sample's sorted edges
        # at rising id offsets), so its k-th real row is old row sort_perm[k]
        target = None if edge_pad_targets is None else edge_pad_targets[s]
        try:
            lay = native.edge_layout(
                s_real, r_real, np.zeros((n_real, 0), np.float32), nc2,
                target, NB, ET, align_map=True)
        except ValueError as err:
            if target is None:
                raise
            raise ValueError(f"edge_pad_targets[{s}]: {err}") from err
        new_rows = np.flatnonzero(lay["align_src"] >= 0)
        ec2 = len(lay["align_src"])
        # old coarse edge row -> aligned row, through the balance resort
        aligned_of_old = np.full(ec_pad, ec2 - 1, np.int64)
        aligned_of_old[sort_perm] = new_rows
        e2c = aligned_of_old[np.clip(e2c, 0, ec_pad - 1)].astype(np.int32)

        fields = dict(
            fine_to_coarse=f2c, edge_to_coarse=e2c, node_mask=node_mask,
            node_graph=node_graph, node_weights=nw, edge_weights=ew,
            **{k: lay[k] for k in ("senders", "receivers", "sender_perm",
                                   "senders_sorted", "edge_mask",
                                   "tile_block", "tile_first")})
        if has_conv:
            fields.update(rep_mask=rep, conv_self=cself, conv_edge=cedge)
            if cedge_t is not None:
                fields["conv_edge_t"] = cedge_t
        host = _host(**{**level, **fields})
        host.update(_pool_fields(host))
        with annotate("aero.hierarchy.to_device"):
            out.append(_to_level(dev, host))

        # maps for the NEXT level's fine side
        prev_src = np.full(ec2, -1, np.int64)
        prev_src[new_rows] = sort_perm
        prev_node_map = node_map
        prev_nf_new = nc2
    return out
