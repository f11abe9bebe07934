"""Spatially partitioned BSMS (multi-scale U-Net) training and serving
(counterpart of aero_gnn_tpu.parallel.bsms_spatial, bsms_spatial.py:61-1056).

Two partition schemes:

  * ``partition_bsms`` / ``make_bsms_spatial_*`` — the all_gather
    baseline: the fine level partitioned as ``parallel.spatial`` with a
    per-layer all_gather of the projected sender features, the coarse
    levels replicated (every rank runs the same coarse stacks); the fine ->
    level-1 transfer is a local masked partial reduction and one psum.
  * ``partition_bsms_halo`` / ``make_bsms_halo_*`` — the flagship: EVERY
    hierarchy level is its own split halo shard
    (``halo.partition_graph_halo_split``, ``halo._halo_split_layer``: on
    the fused kernels K1-K5 with ``align_interior``), so all processor
    compute scales 1/P. Transfers between levels are owner-routed
    (``TransferPlan``): down, one segment sum into local rows plus a
    staging block per peer, an all_to_all of the staging blocks and a
    scatter-add; up, an all_to_all of the rows each peer asks for and a
    local gather. The WeightedEdgeConv transfer (``transfer="weighted"``)
    runs sharded: the down conv reads remote senders through the level's
    halo exchange; the up adjoint ships the boundary contributions back
    with the reverse all_to_all (bsms_spatial.py:640-686). Its sums are
    segment sums, as JAX's ``jax.ops.segment_sum`` there (no K7).

On the cuda backend every sum of both schemes adds in an order fixed on
the host: each id table the forward sums or gathers by has a stable sort
(``spatial.SortOrder``, built by the partitioners), the sums run as
``ops.segment_pool_sum`` / ``ops.segment_sum_sorted`` and the gathers as
``ops.gather_senders`` / ``gather_receivers`` on K5. A pool over a table
with many masked rows (an aligned edge stream's pads) keys them one past
its last segment, where K5 skips them.

Host side numpy, bit-equal to the JAX package's; ``.shard(p, device)`` is
rank p's part (``spatial.Sharded``; the replicated arrays whole).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from aero_gnn_tpu_torch import ops
from aero_gnn_tpu_torch.graph import hierarchy as H
from aero_gnn_tpu_torch.graph.order import morton_order
from aero_gnn_tpu_torch.graph.padded import _round_up, sort_edges_by_receiver
from aero_gnn_tpu_torch.models.mgn import _cast, run_processor
from aero_gnn_tpu_torch.nn import mlp as M
from aero_gnn_tpu_torch.parallel import collectives as C
from aero_gnn_tpu_torch.parallel.halo import (
    HaloSplitGraph,
    _assign_parts,
    _exchange_start,
    _halo_rows,
    _remat_kw,
    cast_split_graph,
    halo_split_stack,
    partition_graph_halo_split,
)
from aero_gnn_tpu_torch.parallel.mesh import Mesh
from aero_gnn_tpu_torch.parallel.spatial import (
    Sharded,
    SortOrder,
    SpatialGraph,
    _spatial_layer,
    make_sharded_step,
    partition_graph,
    sender_sort,
    sort_order,
    with_compute_params,
)


@dataclasses.dataclass(frozen=True)
class BSMSSpatialGraph(Sharded):
    """Fine level sharded ([P, ...]), coarse structure replicated."""

    fine: SpatialGraph
    # fine -> level-1 transfer, in SHARD-LOCAL fine order
    fine_to_coarse: np.ndarray  # i32[P, Nl] global coarse node ids
    edge_to_coarse: np.ndarray  # i32[P, El] global coarse edge ids
    # replicated coarse levels (padded arrays, the same on every shard)
    coarse_senders: Tuple[np.ndarray, ...]
    coarse_receivers: Tuple[np.ndarray, ...]
    coarse_edge_mask: Tuple[np.ndarray, ...]
    coarse_node_mask: Tuple[np.ndarray, ...]
    # transitions between coarse levels s -> s+1 (replicated)
    coarse_f2c: Tuple[np.ndarray, ...]
    coarse_e2c: Tuple[np.ndarray, ...]
    # the port's sorts of those tables (sort_order; the edge table's
    # masked rows keyed past its last coarse edge)
    f2c_order: Optional[SortOrder] = None
    e2c_order: Optional[SortOrder] = None
    # replicated: (perm, sorted) of each coarse level's senders and of each
    # transition's tables
    coarse_sender_sort: Tuple[Tuple[np.ndarray, np.ndarray], ...] = ()
    coarse_f2c_sort: Tuple[Tuple[np.ndarray, np.ndarray], ...] = ()
    coarse_e2c_sort: Tuple[Tuple[np.ndarray, np.ndarray], ...] = ()


def _replicated_sort(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, sorted): the stable sort of a replicated id array."""
    perm, srt = sender_sort(ids[None])
    return perm[0], srt[0]


def _hierarchy(senders, receivers, n, pos, num_scales, mode, stride):
    return H.build_hierarchy_real(
        senders=senders, receivers=receivers,
        node_graph=np.zeros(n, np.int64), num_nodes=n,
        pos=pos.astype(np.float64), num_scales=num_scales, mode=mode,
        stride=stride)


def partition_bsms(
    *,
    senders: np.ndarray,
    receivers: np.ndarray,
    x: np.ndarray,
    edge_attr: np.ndarray,
    pos: np.ndarray,
    y: Optional[np.ndarray],
    num_parts: int,
    num_scales: int,
    mode: str = "stride",
    stride: int = 2,
    edges_pad_multiple: int = 128,
    align_interior: bool = False,
) -> BSMSSpatialGraph:
    levels = _hierarchy(senders, receivers, x.shape[0], pos, num_scales,
                        mode, stride)
    fine = partition_graph(
        senders=senders, receivers=receivers, x=x, edge_attr=edge_attr,
        pos=pos, y=y, num_parts=num_parts,
        edges_pad_multiple=edges_pad_multiple,
        align_interior=align_interior)

    n = x.shape[0]
    order = morton_order(pos)
    n_local = fine.nodes_per_part  # PADDED per-shard rows (node stride)
    n_chunk = -(-n // num_parts)   # real nodes assigned per shard
    el = fine.senders_global.shape[1]

    # the hierarchy's level-0 arrays are in receiver-sorted GLOBAL edge
    # order; the composite key recv * n + send is strictly ascending in it,
    # so each shard edge's hierarchy row is one searchsorted
    lvl0 = levels[0]
    perm0 = sort_edges_by_receiver(senders, receivers)
    gkey = receivers[perm0].astype(np.int64) * n + senders[perm0]

    nc1 = _round_up(lvl0["num_nodes"] + 1, 128)
    ec1 = _round_up(max(lvl0["num_edges"], 1), 128)

    f2c = np.full((num_parts, n_local), nc1 - 1, dtype=np.int32)
    e2c = np.full((num_parts, el), ec1 - 1, dtype=np.int32)
    old_of_new = np.full(num_parts * n_local, -1, dtype=np.int64)
    for p in range(num_parts):
        chunk = order[p * n_chunk:(p + 1) * n_chunk]
        old_of_new[p * n_local: p * n_local + len(chunk)] = chunk
        f2c[p, : len(chunk)] = lvl0["fine_to_coarse"][chunk]
    sg = fine.senders_global
    rl = fine.receivers_local
    valid = fine.edge_mask > 0
    part_of = np.repeat(np.arange(num_parts), el).reshape(num_parts, el)
    old_s = old_of_new[sg[valid]]
    old_r = old_of_new[part_of[valid] * n_local + rl[valid]]
    rows = np.searchsorted(gkey, old_r * n + old_s)
    e2c[valid] = lvl0["edge_to_coarse"][rows]

    cs, cr, cem, cnm, cf2c, ce2c = [], [], [], [], [], []
    for s, lvl in enumerate(levels):
        nc = _round_up(lvl["num_nodes"] + 1, 128)
        ec = _round_up(max(lvl["num_edges"], 1), 128)
        s_p = np.full(ec, nc - 1, np.int32)
        r_p = np.full(ec, nc - 1, np.int32)
        s_p[: lvl["num_edges"]] = lvl["senders"]
        r_p[: lvl["num_edges"]] = lvl["receivers"]
        m = np.zeros(ec, np.float32)
        m[: lvl["num_edges"]] = 1.0
        nm = np.zeros(nc, np.float32)
        nm[: lvl["num_nodes"]] = 1.0
        cs.append(s_p)
        cr.append(r_p)
        cem.append(m)
        cnm.append(nm)
        if s + 1 < len(levels):
            nxt = levels[s + 1]
            nc2 = _round_up(nxt["num_nodes"] + 1, 128)
            ec2 = _round_up(max(nxt["num_edges"], 1), 128)
            f = np.full(nc, nc2 - 1, np.int32)
            f[: lvl["num_nodes"]] = nxt["fine_to_coarse"]
            e = np.full(ec, ec2 - 1, np.int32)
            e[: lvl["num_edges"]] = nxt["edge_to_coarse"]
            cf2c.append(f)
            ce2c.append(e)

    return BSMSSpatialGraph(
        fine=fine, fine_to_coarse=f2c, edge_to_coarse=e2c,
        coarse_senders=tuple(cs), coarse_receivers=tuple(cr),
        coarse_edge_mask=tuple(cem), coarse_node_mask=tuple(cnm),
        coarse_f2c=tuple(cf2c), coarse_e2c=tuple(ce2c),
        f2c_order=sort_order(f2c),
        e2c_order=sort_order(e2c, fine.edge_mask > 0, ec1),
        coarse_sender_sort=tuple(_replicated_sort(a) for a in cs),
        coarse_f2c_sort=tuple(_replicated_sort(a) for a in cf2c),
        coarse_e2c_sort=tuple(_replicated_sort(a) for a in ce2c))


def _pool(data, ids, perm, srt, num_segments: int, sink: bool = False):
    """The segment sum of ``data`` by ``ids`` through their sort (perm,
    srt): K5 on the cuda backend (``ops.segment_pool_sum``). ``sink``: the
    sort keys the rows of a zero operand ``num_segments`` (``sort_order``),
    which K5 skips."""
    if not sink:
        return ops.segment_pool_sum(data, ids, num_segments, perm=perm,
                                    seg_sorted=srt)
    return ops.segment_pool_sum(data, ids, num_segments + 1, perm=perm,
                                seg_sorted=srt, pad_sink=True)[:num_segments]


def _psum_segment_mean(vals, mask, ids, order: SortOrder, num_segments,
                       group: C.Group, sink: bool = False):
    """Cross-shard segment mean: local masked partials (summed through
    ``order``), one psum each."""
    w = mask.to(vals.dtype)
    s = _pool(vals * w[:, None], ids, order.perm, order.ids, num_segments,
              sink)
    c = ops.degree(ids, num_segments, mask=w, dtype=vals.dtype)
    s = C.all_reduce_sum(s, group)
    c = C.all_reduce_raw(c, group)
    return s / torch.clamp(c, min=1.0)[:, None]


def _coarse_mean(x, mask, ids, sort, num_segments):
    """Replicated segment mean of the masked rows, the sum through
    ``sort`` (perm, sorted)."""
    s = _pool(x * mask.to(x.dtype)[:, None], ids, *sort, num_segments)
    c = ops.degree(ids, num_segments, mask=mask, dtype=x.dtype)
    return s / torch.clamp(c, min=1.0)[:, None]


def bsms_spatial_forward(params, cfg, bg: BSMSSpatialGraph,
                         group: C.Group) -> torch.Tensor:
    """Per-shard BSMS forward of the all_gather baseline (BSMSConfig
    parameters) -> [Nl, Dy]."""
    fine = bg.fine
    act = cfg.activation
    x = M.mlp_apply(params.node_encoder, fine.x, activation=act)
    e = M.mlp_apply(params.edge_encoder, fine.edge_attr, activation=act)
    layer_cfg = cfg.layer_cfg
    n_levels = len(bg.coarse_senders)

    def fine_stack(layers, x, e):
        for layer in layers:
            x, e = _spatial_layer(layer, layer_cfg, x, e, fine, group)
        return x, e

    def coarse_stack(layers, x, e, s):
        return run_processor(layers, layer_cfg, x, e, bg.coarse_senders[s],
                             bg.coarse_receivers[s], bg.coarse_edge_mask[s],
                             sender_perm=bg.coarse_sender_sort[s][0],
                             senders_sorted=bg.coarse_sender_sort[s][1],
                             remat=False)

    skips = []
    x, e = fine_stack(params.down[0], x, e)
    skip_fine = (x, e)
    x = _psum_segment_mean(x, fine.node_mask, bg.fine_to_coarse,
                           bg.f2c_order, bg.coarse_node_mask[0].shape[0],
                           group)
    e = _psum_segment_mean(e, fine.edge_mask, bg.edge_to_coarse,
                           bg.e2c_order, bg.coarse_edge_mask[0].shape[0],
                           group, sink=True)
    for s in range(1, n_levels):
        x, e = coarse_stack(params.down[s], x, e, s - 1)
        skips.append((x, e))
        x = _coarse_mean(x, bg.coarse_node_mask[s - 1], bg.coarse_f2c[s - 1],
                         bg.coarse_f2c_sort[s - 1],
                         bg.coarse_node_mask[s].shape[0])
        e = _coarse_mean(e, bg.coarse_edge_mask[s - 1], bg.coarse_e2c[s - 1],
                         bg.coarse_e2c_sort[s - 1],
                         bg.coarse_edge_mask[s].shape[0])

    x, e = coarse_stack(params.bottleneck, x, e, n_levels - 1)

    for i in range(n_levels - 1):
        s = n_levels - 1 - i
        skip_x, skip_e = skips[-(i + 1)]
        x = ops.gather_senders(x, bg.coarse_f2c[s - 1],
                               *bg.coarse_f2c_sort[s - 1]) + skip_x
        x, e = coarse_stack(params.up[i], x, skip_e, s - 1)
    sx, se = skip_fine
    x = ops.gather_senders(x, bg.fine_to_coarse, bg.f2c_order.perm,
                           bg.f2c_order.ids) + sx
    x, e = fine_stack(params.up[n_levels - 1], x, se)
    return M.mlp_apply(params.decoder, x, activation=act)


def make_bsms_spatial_forward(model_cfg, mesh: Mesh, *,
                              axis: str = "graph"):
    """``fwd(params, bg)`` -> this shard's [Nl, Dy] predictions."""
    group = mesh.group(axis)

    def fwd(params, bg):
        with torch.no_grad():
            return bsms_spatial_forward(params, model_cfg, bg, group)

    return fwd


def make_bsms_spatial_train_step(model_cfg, optimizer: torch.optim.Optimizer,
                                 mesh: Mesh, *, axis: str = "graph"):
    """``step(params, bg)`` -> the global loss; gradients summed over the
    axis (``spatial.shard_loss`` on the fine level)."""
    group = mesh.group(axis)
    return make_sharded_step(
        lambda params, bg: bsms_spatial_forward(params, model_cfg, bg, group),
        optimizer, group, group)


# ---------------------------------------------------------------------------
# halo-split BSMS (the flagship scheme): EVERY level sharded
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransferPlan(Sharded):
    """Host-built routing for one level boundary k -> k+1 ([P, ...]).

    DOWN (reduce to owners): every source row / slot gets a combined
    destination slot in [0, D + P*Ht): its owner-local destination row
    when the owner is this shard, else a per-peer staging slot; one
    segment sum into the combined space, an all_to_all of the staging
    block, a scatter-add of the received rows at ``recv_rows``.

    UP (fetch from owners): each shard ships ``up_send_rows`` of its local
    next-level rows to each peer (all_to_all); every source row then reads
    ``up_fetch`` from [local rows; received table]."""

    node_slot: np.ndarray       # i32[P, Nl_k] combined dst slot
    node_recv_rows: np.ndarray  # i32[P, P, Htn] local k+1 rows to add into
    edge_slot_int: np.ndarray   # i32[P, Ei_k]
    edge_slot_bnd: np.ndarray   # i32[P, Eb_k]
    edge_recv_rows: np.ndarray  # i32[P, P, Hte] combined local k+1 edges
    up_send_rows: np.ndarray    # i32[P, P, Htu] local k+1 rows to ship
    up_fetch: np.ndarray        # i32[P, Nl_k] into [Nl_next + P*Htu]
    # the port's sorts of each table (sort_order; the node and edge slots'
    # masked rows keyed past the combined space)
    node_slot_order: Optional[SortOrder] = None
    node_recv_order: Optional[SortOrder] = None
    edge_slot_int_order: Optional[SortOrder] = None
    edge_slot_bnd_order: Optional[SortOrder] = None
    edge_recv_order: Optional[SortOrder] = None
    up_send_order: Optional[SortOrder] = None
    up_fetch_order: Optional[SortOrder] = None


@dataclasses.dataclass(frozen=True)
class BSMSHaloLevel(Sharded):
    """One hierarchy level of the flagship scheme: the level's mesh as a
    split halo shard plus the transfer operators to the NEXT level in
    shard-local order (bsms_spatial.py:382-421). Levels are partitioned
    independently, each by its own Morton order."""

    REPLICATED = ("pos_of_node",)

    graph: HaloSplitGraph  # this level's sharded mesh (x / y real at 0)
    # provenance: shard-local row / slot -> GLOBAL ids of THIS level
    node_rows: np.ndarray  # i32[P, Nl] (pad rows -> nk_pad-1)
    edge_rows_int: np.ndarray  # i32[P, Ei] (pad slots -> ek_pad-1)
    edge_rows_bnd: np.ndarray  # i32[P, Eb]
    pos_of_node: np.ndarray  # i32[nk_pad] flat [P*Nl] slot of each id
    # transfer THIS level -> next (None on the last level)
    f2c: Optional[np.ndarray]  # i32[P, Nl] global next-level node ids
    e2c_int: Optional[np.ndarray]  # i32[P, Ei] global next-level edge ids
    e2c_bnd: Optional[np.ndarray]  # i32[P, Eb]
    # WeightedEdgeConv operator on THIS level's rows / slots (0 on pads)
    conv_self: Optional[np.ndarray]  # f32[P, Nl]
    rep_mask: Optional[np.ndarray]  # f32[P, Nl]
    conv_edge_int: Optional[np.ndarray]  # f32[P, Ei]
    conv_edge_bnd: Optional[np.ndarray]  # f32[P, Eb]
    edge_w_int: Optional[np.ndarray]  # f32[P, Ei]
    edge_w_bnd: Optional[np.ndarray]  # f32[P, Eb]
    plan: Optional[TransferPlan] = None
    # padded sizes of the NEXT level's index spaces (0 on the last)
    nc_pad: int = 0
    ec_pad: int = 0
    # this level's REAL mesh sizes
    n_real: int = 0
    e_real: int = 0


@dataclasses.dataclass(frozen=True)
class BSMSHaloGraph(Sharded):
    """num_scales BSMSHaloLevels; levels[0] is the fine mesh."""

    levels: Tuple[BSMSHaloLevel, ...]

    @property
    def fine(self) -> HaloSplitGraph:
        return self.levels[0].graph


def unshard_fine(bg: BSMSHaloGraph, out: np.ndarray) -> np.ndarray:
    """[P, Nl, D] per-shard fine-level rows back to the mesh's node order
    [N, D], by the fine level's provenance ``node_rows`` (the level's
    Morton order is taken over float64 positions, so a float32 reckoning
    of it may swap neighbours)."""
    lv = bg.levels[0]
    rows = lv.node_rows
    real = rows < lv.n_real
    got = np.zeros((lv.n_real,) + out.shape[2:], out.dtype)
    got[rows[real]] = out[real]
    return got


def partition_bsms_halo(
    *,
    senders: np.ndarray,
    receivers: np.ndarray,
    x: np.ndarray,
    edge_attr: np.ndarray,
    pos: np.ndarray,
    y: Optional[np.ndarray],
    num_parts: int,
    num_scales: int,
    mode: str = "stride",
    stride: int = 2,
    edges_pad_multiple: int = 128,
    halo_pad_multiple: int = 8,
    align_interior: bool = False,
) -> BSMSHaloGraph:
    """The flagship multi-rank BSMS graph: every hierarchy level a split
    halo shard (BSMSHaloLevel). The "mean" and the WeightedEdgeConv
    transfer operators are both carried."""
    n = x.shape[0]
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    trans = _hierarchy(senders, receivers, n, pos, num_scales, mode, stride)

    # per-level REAL mesh arrays; level-0 edge rows receiver-sorted (the
    # hierarchy's level-0 arrays index that order)
    perm0 = sort_edges_by_receiver(senders, receivers)
    meshes = [dict(s=senders[perm0], r=receivers[perm0],
                   ea=np.asarray(edge_attr)[perm0], pos=pos, x=x, y=y, n=n)]
    for t in trans:
        meshes.append(dict(s=t["senders"], r=t["receivers"], ea=None,
                           pos=t["pos"], x=None, y=None, n=t["num_nodes"]))

    nk_pad = [_round_up(m["n"] + 1, 128) for m in meshes]
    ek_pad = [_round_up(max(len(m["s"]), 1), 128) for m in meshes]

    levels, host = [], []
    for k, m in enumerate(meshes):
        e_k = len(m["s"])
        t = trans[k] if k < len(trans) else None
        aux = np.zeros((e_k, 4), dtype=np.float64)
        aux[:, 0] = np.arange(e_k)
        if t is not None:
            aux[:, 1] = t["edge_to_coarse"]
            aux[:, 2] = t["conv_edge"]
            aux[:, 3] = t["edge_weights"]
        xk = (m["x"] if m["x"] is not None
              else np.zeros((m["n"], 1), np.float32))
        eak = (m["ea"] if m["ea"] is not None
               else np.zeros((e_k, 1), np.float32))
        sgk, aux_i, aux_b = partition_graph_halo_split(
            senders=m["s"], receivers=m["r"], x=xk, edge_attr=eak,
            pos=np.asarray(m["pos"], np.float64), y=m["y"],
            num_parts=num_parts, edges_pad_multiple=edges_pad_multiple,
            halo_pad_multiple=halo_pad_multiple,
            align_interior=align_interior, edge_aux=aux)

        emi = sgk.edge_mask_int > 0
        emb = sgk.edge_mask_bnd > 0
        edge_rows_int = np.where(emi, aux_i[..., 0],
                                 ek_pad[k] - 1).astype(np.int32)
        edge_rows_bnd = np.where(emb, aux_b[..., 0],
                                 ek_pad[k] - 1).astype(np.int32)

        order, _, n_local = _assign_parts(np.asarray(m["pos"], np.float64),
                                          m["n"], num_parts)
        nlp = sgk.nodes_per_part
        node_rows = np.full((num_parts, nlp), nk_pad[k] - 1, np.int32)
        # pads of the replicated index space point at a local pad row
        pos_of_node = np.full(nk_pad[k], nlp - 1, np.int32)
        for p in range(num_parts):
            chunk = order[p * n_local:(p + 1) * n_local]
            node_rows[p, :len(chunk)] = chunk
            pos_of_node[chunk] = p * nlp + np.arange(len(chunk))

        kw = dict(f2c=None, e2c_int=None, e2c_bnd=None, conv_self=None,
                  rep_mask=None, conv_edge_int=None, conv_edge_bnd=None,
                  edge_w_int=None, edge_w_bnd=None)
        if t is not None:
            f2c = np.full((num_parts, nlp), nk_pad[k + 1] - 1, np.int32)
            cself = np.zeros((num_parts, nlp), np.float32)
            rep = np.zeros((num_parts, nlp), np.float32)
            for p in range(num_parts):
                chunk = order[p * n_local:(p + 1) * n_local]
                kk = len(chunk)
                f2c[p, :kk] = t["fine_to_coarse"][chunk]
                cself[p, :kk] = t["conv_self"][chunk]
                rep[p, :kk] = t["rep_mask"][chunk]
            kw = dict(
                f2c=f2c,
                e2c_int=np.where(emi, aux_i[..., 1],
                                 ek_pad[k + 1] - 1).astype(np.int32),
                e2c_bnd=np.where(emb, aux_b[..., 1],
                                 ek_pad[k + 1] - 1).astype(np.int32),
                conv_self=cself, rep_mask=rep,
                conv_edge_int=aux_i[..., 2].astype(np.float32),
                conv_edge_bnd=aux_b[..., 2].astype(np.float32),
                edge_w_int=aux_i[..., 3].astype(np.float32),
                edge_w_bnd=aux_b[..., 3].astype(np.float32),
                nc_pad=nk_pad[k + 1], ec_pad=ek_pad[k + 1])
        lvl = BSMSHaloLevel(graph=sgk, node_rows=node_rows,
                            edge_rows_int=edge_rows_int,
                            edge_rows_bnd=edge_rows_bnd,
                            pos_of_node=pos_of_node, n_real=m["n"],
                            e_real=e_k, **kw)
        levels.append(lvl)
        host.append(dict(order=order, n_local=n_local, nlp=nlp,
                         eri=edge_rows_int, erb=edge_rows_bnd, emi=emi,
                         emb=emb))

    # second pass: the owner-routed transfer plans
    my_part = np.arange(num_parts)
    for k in range(len(meshes) - 1):
        hn, lk = host[k + 1], levels[k]
        owner_n = np.full(nk_pad[k + 1], -1, np.int64)  # -1 = pad id
        slot_n = np.full(nk_pad[k + 1], hn["nlp"] - 1, np.int64)
        for p in range(num_parts):
            chunk = hn["order"][p * hn["n_local"]:(p + 1) * hn["n_local"]]
            owner_n[chunk] = p
            slot_n[chunk] = np.arange(len(chunk))
        ei_n = hn["eri"].shape[1]
        owner_e = np.full(ek_pad[k + 1], -1, np.int64)  # -1 = pad id
        slot_e = np.full(ek_pad[k + 1], ei_n + hn["erb"].shape[1] - 1,
                         np.int64)
        for p in range(num_parts):
            vi = hn["emi"][p]
            owner_e[hn["eri"][p][vi]] = p
            slot_e[hn["eri"][p][vi]] = np.flatnonzero(vi)
            vb = hn["emb"][p]
            owner_e[hn["erb"][p][vb]] = p
            slot_e[hn["erb"][p][vb]] = ei_n + np.flatnonzero(vb)

        node_slot, node_recv, _ = _owner_route(
            lk.f2c, owner_n, slot_n, my_part, hn["nlp"], num_parts)
        # both edge streams route into the SAME combined space / staging
        both = np.concatenate([lk.e2c_int, lk.e2c_bnd], axis=1)
        es_both, edge_recv, _ = _owner_route(
            both, owner_e, slot_e, my_part, ei_n + hn["erb"].shape[1],
            num_parts)
        n_int = lk.e2c_int.shape[1]
        up_fetch, up_send, _ = _fetch_route(
            lk.f2c, owner_n, slot_n, my_part, hn["nlp"], num_parts)
        es_int = np.ascontiguousarray(es_both[:, :n_int])
        es_bnd = np.ascontiguousarray(es_both[:, n_int:])
        node_space = hn["nlp"] + num_parts * node_recv.shape[2]
        edge_space = (ei_n + hn["erb"].shape[1]
                      + num_parts * edge_recv.shape[2])
        levels[k] = dataclasses.replace(lk, plan=TransferPlan(
            node_slot=node_slot, node_recv_rows=node_recv,
            edge_slot_int=es_int, edge_slot_bnd=es_bnd,
            edge_recv_rows=edge_recv, up_send_rows=up_send,
            up_fetch=up_fetch,
            node_slot_order=sort_order(
                node_slot, lk.graph.node_mask > 0, node_space),
            node_recv_order=sort_order(node_recv),
            edge_slot_int_order=sort_order(
                es_int, host[k]["emi"], edge_space),
            edge_slot_bnd_order=sort_order(
                es_bnd, host[k]["emb"], edge_space),
            edge_recv_order=sort_order(edge_recv),
            up_send_order=sort_order(up_send),
            up_fetch_order=sort_order(up_fetch)))
    return BSMSHaloGraph(levels=tuple(levels))


def _owner_route(tgt_global: np.ndarray, owner: np.ndarray,
                 local_slot: np.ndarray, my_part: np.ndarray,
                 n_dst_slots: int, num_parts: int, pad_multiple: int = 8):
    """Combined-slot routing for a [P, R] table of global destination ids:
    (slot [P, R], recv_rows [P, P, Ht], Ht). slot < n_dst_slots is a local
    destination row; n_dst_slots + q*Ht + j stages row j for peer q.
    recv_rows[p, q, j] is the local destination row on p of peer q's j-th
    staged slot (pads -> 0; staged pads carry exact zeros)."""
    P_, R = tgt_global.shape
    own = owner[tgt_global]
    loc = local_slot[tgt_global]
    # owner -1 marks PAD destination ids: reader-local (exact zeros)
    remote = (own != my_part[:, None]) & (own >= 0)
    src = np.repeat(np.arange(P_), R).reshape(P_, R)
    key = (src[remote].astype(np.int64) * num_parts
           + own[remote]) * n_dst_slots + loc[remote]
    uk, inv = np.unique(key, return_inverse=True)
    uk_pair = uk // n_dst_slots
    uk_row = uk % n_dst_slots
    seg_start = np.searchsorted(uk_pair, np.arange(num_parts * num_parts))
    counts = np.diff(np.append(seg_start, len(uk)))
    h_max = int(counts.max()) if len(uk) else 0
    Ht = max(_round_up(max(h_max, 1), pad_multiple), pad_multiple)
    slot_in_pair = np.arange(len(uk)) - seg_start[uk_pair]

    slot = loc.copy().astype(np.int64)
    slot[remote] = (n_dst_slots + (uk_pair[inv] % num_parts) * Ht
                    + slot_in_pair[inv])
    recv_rows = np.zeros((num_parts, num_parts, Ht), np.int32)
    # uk_pair = src*P + dst: shard dst receives slot j of peer src
    recv_rows[uk_pair % num_parts, uk_pair // num_parts,
              slot_in_pair] = uk_row
    return slot.astype(np.int32), recv_rows, Ht


def _fetch_route(tgt_global: np.ndarray, owner: np.ndarray,
                 local_slot: np.ndarray, my_part: np.ndarray,
                 n_dst_rows: int, num_parts: int, pad_multiple: int = 8):
    """UP routing: (fetch [P, R] into [n_dst_rows + P*Ht], send_rows
    [P, P, Ht], Ht). send_rows[p, q, j] is p's local row shipped to q as
    its j-th table slot; fetch reads local rows directly and remote ones
    from the received table."""
    P_, R = tgt_global.shape
    own = owner[tgt_global]
    loc = local_slot[tgt_global]
    remote = (own != my_part[:, None]) & (own >= 0)
    dst = np.repeat(np.arange(P_), R).reshape(P_, R)  # the READER shard
    key = (own[remote].astype(np.int64) * num_parts
           + dst[remote]) * n_dst_rows + loc[remote]
    uk, inv = np.unique(key, return_inverse=True)
    uk_pair = uk // n_dst_rows
    uk_row = uk % n_dst_rows
    seg_start = np.searchsorted(uk_pair, np.arange(num_parts * num_parts))
    counts = np.diff(np.append(seg_start, len(uk)))
    h_max = int(counts.max()) if len(uk) else 0
    Ht = max(_round_up(max(h_max, 1), pad_multiple), pad_multiple)
    slot_in_pair = np.arange(len(uk)) - seg_start[uk_pair]

    send_rows = np.zeros((num_parts, num_parts, Ht), np.int32)
    send_rows[uk_pair // num_parts, uk_pair % num_parts,
              slot_in_pair] = uk_row
    fetch = loc.copy().astype(np.int64)
    # reader-side table after the all_to_all: block q = rows from owner q
    fetch[remote] = (n_dst_rows + (uk_pair[inv] // num_parts) * Ht
                     + slot_in_pair[inv])
    return fetch.astype(np.int32), send_rows, Ht


def _wec_conv_sharded(lvl: BSMSHaloLevel, x, group: C.Group):
    """Sharded WeightedEdgeConv aggregation on this level's rows: remote
    sender rows arrive through the level's halo exchange, in flight while
    the interior stream is summed; then the receiver-owned conv is complete
    per shard."""
    g = lvl.graph
    n_local = x.shape[0]
    halo_x = _exchange_start(x, g, group)
    # the aligned interior's rows keyed by its pad node are pad rows with
    # zero weights
    xs_i = ops.gather_senders(x, g.senders_int, g.sender_perm_int,
                              g.senders_int_sorted, g.aligned)
    interior = ops.segment_sum_sorted(lvl.conv_edge_int[:, None] * xs_i,
                                      g.receivers_int, n_local,
                                      pad_sink=g.aligned)
    xs_b = _halo_rows(halo_x, g)
    return (lvl.conv_self[:, None] * x + interior
            + ops.segment_sum_sorted(lvl.conv_edge_bnd[:, None] * xs_b,
                                     g.receivers_bnd, n_local))


def _wec_spread_sharded(lvl: BSMSHaloLevel, z, group: C.Group):
    """Sharded transpose of _wec_conv_sharded: contributions to REMOTE
    senders ship back with the reverse all_to_all (the manual transpose of
    halo._exchange_start; unused halo slots carry exact zeros, so their
    adds to row send_idx[..., 0] change nothing)."""
    g = lvl.graph
    n_local = z.shape[0]
    zr_i = ops.gather_receivers(z, g.receivers_int, pad_sink=g.aligned)
    spread = ops.segment_pool_sum(
        lvl.conv_edge_int[:, None] * zr_i, g.senders_int, n_local,
        perm=g.sender_perm_int, seg_sorted=g.senders_int_sorted,
        pad_sink=g.aligned)
    zr_b = ops.gather_receivers(z, g.receivers_bnd)
    p_, h_ = g.send_idx.shape
    buf = ops.segment_pool_sum(
        lvl.conv_edge_bnd[:, None] * zr_b, g.senders_bnd, p_ * h_,
        perm=g.sender_perm_bnd, seg_sorted=g.senders_bnd_sorted)
    # synchronous: every next op reads its result
    rev = C.all_to_all(buf.reshape(p_, h_, -1), group)
    spread = spread + ops.segment_pool_sum(
        rev.reshape(-1, z.shape[-1]), g.send_idx.reshape(-1), n_local,
        perm=g.send_perm, seg_sorted=g.send_sorted)
    return lvl.conv_self[:, None] * z + spread


def _sparse_reduce(payload, slot, slot_order: SortOrder, recv_rows,
                   recv_order: SortOrder, n_dst: int, group: C.Group):
    """Owner-routed reduction: one segment sum into [n_dst + P*Ht] (local
    rows + per-peer staging; the payload's masked rows, zero, keyed past
    it by ``slot_order``), the staging block all_to_all'd, the received
    rows added into their local rows (staged pads carry exact zeros)."""
    p_, ht = recv_rows.shape
    big = _pool(payload, slot, slot_order.perm, slot_order.ids,
                n_dst + p_ * ht, sink=True)
    local, stage = big[:n_dst], big[n_dst:].reshape(p_, ht, -1)
    # synchronous: every next op reads its result
    recv = C.all_to_all(stage, group)
    return local + _pool(recv.reshape(p_ * ht, -1), recv_rows.reshape(-1),
                         recv_order.perm, recv_order.ids, n_dst)


def _sparse_fetch(xk1, send_rows, send_order: SortOrder, fetch,
                  fetch_order: SortOrder, group: C.Group):
    """Owner-routed gather: ship each peer its requested local rows
    (all_to_all), then read local + received rows by ``fetch``; both
    gathers' backward through their sorts."""
    buf = ops.gather_senders(xk1, send_rows.reshape(-1), send_order.perm,
                             send_order.ids).reshape(
        tuple(send_rows.shape) + (xk1.shape[-1],))
    # synchronous: every next op reads its result
    table = C.all_to_all(buf, group)
    return ops.gather_senders(
        torch.cat([xk1, table.reshape(-1, xk1.shape[-1])]), fetch,
        fetch_order.perm, fetch_order.ids)


def bsms_halo_forward(params, cfg, bg: BSMSHaloGraph,
                      group: C.Group) -> torch.Tensor:
    """Per-shard BSMS forward with EVERY level sharded -> fp32 [Nl, Dy]
    (BSMSConfig parameters; the "mean" and the "weighted" transfer)."""
    cdt = getattr(cfg, "compute_dtype", "float32")
    levels = tuple(dataclasses.replace(lv, graph=cast_split_graph(lv.graph,
                                                                  cdt))
                   for lv in bg.levels)
    return with_compute_params(params, cdt, _bsms_halo, cfg, levels, group)


def _bsms_halo(params, cfg, levels, group):
    S = len(levels)
    weighted = cfg.transfer == "weighted"
    act = cfg.activation
    remat = _remat_kw(cfg)

    def stack(layers, lvl, x, ei, eb):
        # grouped remat only on stacks it divides
        rg = remat["remat_group"]
        kw = dict(remat, remat_group=rg if rg > 1 and len(layers) % rg == 0
                  else 0)
        return halo_split_stack(layers, cfg, x, ei, eb, lvl.graph, group,
                                **kw)

    g0 = levels[0].graph
    x = M.mlp_apply(params.node_encoder, g0.x, activation=act)
    e_i = M.mlp_apply(params.edge_encoder, g0.edge_attr_int, activation=act)
    e_b = M.mlp_apply(params.edge_encoder, g0.edge_attr_bnd, activation=act)
    dt = x.dtype

    skips = []
    for k in range(S - 1):
        lvl, nxt = levels[k], levels[k + 1]
        x, e_i, e_b = stack(params.down[k], lvl, x, e_i, e_b)
        skips.append((x, e_i, e_b))
        g, plan = lvl.graph, lvl.plan
        n_next = nxt.graph.node_mask.shape[0]
        ei_next = nxt.graph.edge_mask_int.shape[0]
        eb_next = nxt.graph.edge_mask_bnd.shape[0]
        node_route = (plan.node_slot, plan.node_slot_order,
                      plan.node_recv_rows, plan.node_recv_order, n_next)
        if weighted:
            sel = _wec_conv_sharded(lvl, x, group) * lvl.rep_mask[:, None]
            x = _sparse_reduce(sel, *node_route, group).to(dt)
            w_i = lvl.edge_w_int * g.edge_mask_int
            w_b = lvl.edge_w_bnd * g.edge_mask_bnd
            eps = 1e-12
        else:
            nm = g.node_mask.to(x.dtype)
            res = _sparse_reduce(
                torch.cat([x * nm[:, None], nm[:, None]], dim=1),
                *node_route, group)
            x = (res[:, :-1]
                 / torch.clamp(res[:, -1:], min=1.0)).to(dt)
            w_i, w_b = g.edge_mask_int, g.edge_mask_bnd
            eps = 1.0
        # both source edge streams reduce into the next level's combined
        # [Ei + Eb] slot space with a shared staging block
        p_, ht = plan.edge_recv_rows.shape
        d_e = ei_next + eb_next
        pi = torch.cat([e_i * w_i[:, None], w_i[:, None]], dim=1)
        pb = torch.cat([e_b * w_b[:, None], w_b[:, None]], dim=1)
        oi, ob = plan.edge_slot_int_order, plan.edge_slot_bnd_order
        big = (_pool(pi, plan.edge_slot_int, oi.perm, oi.ids, d_e + p_ * ht,
                     sink=True)
               + _pool(pb, plan.edge_slot_bnd, ob.perm, ob.ids,
                       d_e + p_ * ht, sink=True))
        local, stage = big[:d_e], big[d_e:].reshape(p_, ht, -1)
        # synchronous: every next op reads its result
        recv = C.all_to_all(stage, group)
        orc = plan.edge_recv_order
        comb = local + _pool(recv.reshape(p_ * ht, -1),
                             plan.edge_recv_rows.reshape(-1), orc.perm,
                             orc.ids, d_e)
        comb = (comb[:, :-1]
                / torch.clamp(comb[:, -1:], min=eps)).to(dt)
        e_i, e_b = comb[:ei_next], comb[ei_next:]

    x, e_i, e_b = stack(params.bottleneck, levels[S - 1], x, e_i, e_b)

    for i in range(S - 1):
        k = S - 2 - i
        lvl = levels[k]
        sx, sei, seb = skips[-(i + 1)]
        plan = lvl.plan
        xc = _sparse_fetch(x, plan.up_send_rows, plan.up_send_order,
                           plan.up_fetch, plan.up_fetch_order, group)
        if weighted:
            xc = _wec_spread_sharded(lvl, xc * lvl.rep_mask[:, None],
                                     group).to(dt)
        x, e_i, e_b = stack(params.up[i], lvl, xc + sx, sei, seb)
    return M.mlp_apply(params.decoder, x, activation=act).float()


def make_bsms_halo_forward(model_cfg, mesh: Mesh, *, axis: str = "graph"):
    """``fwd(params, bg)`` -> this shard's fp32 [Nl, Dy] predictions on the
    all-levels-sharded scheme."""
    group = mesh.group(axis)

    def fwd(params, bg):
        with torch.no_grad():
            return bsms_halo_forward(params, model_cfg, bg, group)

    return fwd


def make_bsms_halo_train_step(model_cfg, optimizer: torch.optim.Optimizer,
                              mesh: Mesh, *, axis: str = "graph"):
    """Training step of the flagship halo-split BSMS: the fine level's
    masked-MSE share of the global loss, gradients summed over the axis."""
    group = mesh.group(axis)
    return make_sharded_step(
        lambda params, bg: bsms_halo_forward(params, model_cfg, bg, group),
        optimizer, group, group)
