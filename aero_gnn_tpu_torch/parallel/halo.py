"""Sparse halo exchange for spatial graph parallelism (counterpart of
aero_gnn_tpu.parallel.halo, halo.py:42-767).

parallel.spatial's baseline halo is an all_gather of every shard's
projected node features, O(P * N_local * h) per layer. On Morton-ordered
partitions only boundary nodes are referenced across shards, so this module
exchanges exactly the needed rows with one all_to_all: O(P * H * h), H the
largest boundary of a shard pair (planned on the host, static).

Per layer, per shard (``_exchange_start``):
  1. send_buf = s_proj[send_idx]       # [P, H, h] rows for each peer
                                       # (backward: K5 over send_sorted)
  2. recv     = all_to_all(send_buf)   # [P, H, h] rows from each peer
  3. the halo table recv.reshape(P * H, h), read by the boundary senders.
The all_to_all is issued with ``collectives.all_to_all_start`` and waited
for where the table is first read; its backward is the reverse all_to_all,
started by the wait's backward and waited for by the start's
(``parallel.collectives``).

``HaloSplitGraph`` (the flagship, ``partition_graph_halo_split``) splits
each shard's edges into an interior stream (both endpoints local) and a
boundary stream (sender remote): with ``align_interior`` the interior is
block-aligned, and ``_halo_split_layer`` runs it on the fused kernels K1 /
K3 (backward K2 / K4, the sender gather's backward K5) while the boundary
chain, O(surface), stays plain torch around K5: on the cuda backend its
masked sum runs on K5 and each of its gathers has a K5 backward over a
host-built sort (``sender_perm_bnd``; ``send_perm`` for the send gather,
whose rows repeat across peers), so the step adds in the same order on
every run. As in JAX (halo.py:543, compiled
with xla_flags.async_jit_options) the exchange is issued first and only
the boundary chain waits for it, so it is in flight while the interior
runs; in the backward the reverse exchange is in flight while the
interior's backward runs. ``AERO_GNN_ASYNC_COLLECTIVES=0`` makes it
synchronous (``collectives.async_collectives``).

Host side: numpy, bit-equal to the JAX package's; ``.shard(p, device)`` is
rank p's slice (``parallel.spatial.Sharded``). The forwards checkpoint the
layers through ``models.mgn.checkpointed_layer_stack`` with JAX's remat
defaults (``remat`` on, ``remat_policy`` "save_fused": halo.py:503-510,
:675-682), which on the fused interior checkpoint nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from aero_gnn_tpu_torch import ops
from aero_gnn_tpu_torch.graph.order import morton_order
from aero_gnn_tpu_torch.graph.padded import (
    ALIGN_NODE_BLOCK,
    _round_up,
    sort_edges_by_receiver,
)
from aero_gnn_tpu_torch.models.mgn import _cast, checkpointed_layer_stack
from aero_gnn_tpu_torch.nn import blocks as B
from aero_gnn_tpu_torch.nn import mlp as M
from aero_gnn_tpu_torch.parallel import collectives as C
from aero_gnn_tpu_torch.parallel.mesh import Mesh
from aero_gnn_tpu_torch.parallel.spatial import (
    Sharded,
    fused_edge,
    make_sharded_step,
    masked_sum,
    mean_degree,
    pack_aligned_edges,
    sender_sort,
    with_compute_params,
)


@dataclasses.dataclass(frozen=True)
class HaloSpatialGraph(Sharded):
    """Spatially partitioned mesh with sparse halo metadata ([P, ...])."""

    x: np.ndarray  # [P, Nl, Dn]
    edge_attr: np.ndarray  # [P, El, De]
    senders_combined: np.ndarray  # i32[P, El] into the [Nl + P*H] table
    receivers_local: np.ndarray  # i32[P, El]
    send_idx: np.ndarray  # i32[P, P, H] local rows to ship to each peer
    node_mask: np.ndarray  # f32[P, Nl]
    edge_mask: np.ndarray  # f32[P, El]
    y: np.ndarray  # [P, Nl, Dy]
    sender_perm: Optional[np.ndarray] = None  # i32[P, El]
    senders_sorted: Optional[np.ndarray] = None  # i32[P, El]
    # per-shard sort of the rows shipped to the peers (send_sort)
    send_perm: Optional[np.ndarray] = None  # i32[P, P*H]
    send_sorted: Optional[np.ndarray] = None  # i32[P, P*H]

    @property
    def num_parts(self) -> int:
        return self.x.shape[0]

    @property
    def nodes_per_part(self) -> int:
        return self.x.shape[1]

    @property
    def halo_size(self) -> int:
        return self.send_idx.shape[2]


def send_sort(send_idx: np.ndarray):
    """Per-shard stable sort of the local rows each shard ships, [P, P, H]
    -> (perm, sorted) [P, P*H]: the send gather's backward (rows repeat
    across peers, and pad slots repeat row 0) is a sorted segment sum."""
    return sender_sort(send_idx.reshape(send_idx.shape[0], -1))


def _halo_plan(s_new: np.ndarray, owner_s: np.ndarray, owner_r: np.ndarray,
               n_local: int, num_parts: int, halo_pad_multiple: int,
               halo_rows=None):
    """Vectorised halo plan: (send_idx [P, P, H], H, halo_slot [E]) where
    halo_slot[i] is the slot of edge i's sender in the RECEIVER's halo
    table (p*H + k), valid only where owner_s != owner_r."""
    bmask = owner_s != owner_r
    # one sorted-unique over composite keys:
    # key = ((src_part * P) + dst_part) * n_local + src_local_row
    pair = owner_s[bmask] * num_parts + owner_r[bmask]
    row = s_new[bmask] - owner_s[bmask] * n_local
    key = pair * np.int64(n_local) + row
    uk, inv = np.unique(key, return_inverse=True)
    uk_pair = uk // n_local
    uk_row = uk % n_local
    seg_start = np.searchsorted(uk_pair, np.arange(num_parts * num_parts))
    counts = np.diff(np.append(seg_start, len(uk)))
    h_max = int(counts.max()) if len(uk) else 0
    H = max(_round_up(max(h_max, 1), halo_pad_multiple), halo_pad_multiple)
    if halo_rows is not None:
        if halo_rows < h_max:
            raise ValueError(f"halo_rows={halo_rows} < required {h_max}")
        H = halo_rows

    send_idx = np.zeros((num_parts, num_parts, H), dtype=np.int32)
    slot = np.arange(len(uk)) - seg_start[uk_pair]
    send_idx[uk_pair // num_parts, uk_pair % num_parts, slot] = uk_row

    halo_slot = np.zeros(len(s_new), dtype=np.int64)
    halo_slot[bmask] = owner_s[bmask] * H + slot[inv]
    return send_idx, H, halo_slot


def _assign_parts(pos: np.ndarray, n: int, num_parts: int):
    """Morton-ordered equal-size node partition: (order, new_of_old,
    n_local)."""
    order = morton_order(pos)
    n_local = -(-n // num_parts)
    new_of_old = np.full(n, -1, dtype=np.int64)
    for p in range(num_parts):
        chunk = order[p * n_local:(p + 1) * n_local]
        new_of_old[chunk] = p * n_local + np.arange(len(chunk))
    return order, new_of_old, n_local


def _pack_nodes(order, n_local, num_parts, x, y, dtype, rows=None):
    rows = n_local if rows is None else rows
    if rows < n_local:
        raise ValueError(f"rows={rows} < n_local={n_local}")
    xs = np.zeros((num_parts, rows, x.shape[1]), dtype=dtype)
    ys = np.zeros((num_parts, rows,
                   y.shape[1] if y is not None else 1), dtype=dtype)
    nm = np.zeros((num_parts, rows), dtype=dtype)
    for p in range(num_parts):
        chunk = order[p * n_local:(p + 1) * n_local]
        k = len(chunk)
        xs[p, :k] = x[chunk]
        if y is not None:
            ys[p, :k] = y[chunk]
        nm[p, :k] = 1.0
    return xs, ys, nm


def _pack_edge_streams(parts, num_parts, de, pad_multiple, dtype,
                       rows=None, *, pad_sender=0, pad_receiver=0):
    """Pack per-part (sender, recv_local, edge_attr) triples into padded
    [P, El, ...] arrays (mask 0 on pad slots); ``rows`` overrides the
    padded length. Pad receivers default to the LAST local row
    (``pad_receiver``) so the stream stays sorted; ``pad_sender`` is any
    in-bounds row of the stream's sender table."""
    need = max(max((len(c) for c, _, _ in parts), default=1), 1)
    el = _round_up(need, pad_multiple)
    if rows is not None:
        if rows < need:
            raise ValueError(f"rows={rows} < required {need}")
        el = rows
    sc = np.full((num_parts, el), pad_sender, dtype=np.int32)
    rl = np.full((num_parts, el), pad_receiver, dtype=np.int32)
    ea = np.zeros((num_parts, el, de), dtype=dtype)
    em = np.zeros((num_parts, el), dtype=dtype)
    for s, (comb, rp, eap) in enumerate(parts):
        k = len(comb)
        sc[s, :k], rl[s, :k], ea[s, :k] = comb, rp, eap
        em[s, :k] = 1.0
    return sc, rl, ea, em


def partition_graph_halo(
    *,
    senders: np.ndarray,
    receivers: np.ndarray,
    x: np.ndarray,
    edge_attr: np.ndarray,
    pos: np.ndarray,
    y: Optional[np.ndarray],
    num_parts: int,
    edges_pad_multiple: int = 128,
    halo_pad_multiple: int = 8,
    dtype=np.float32,
) -> HaloSpatialGraph:
    """One combined edge stream per shard whose senders index [local rows;
    halo table]."""
    n = x.shape[0]
    order, new_of_old, n_local = _assign_parts(pos, n, num_parts)
    s_new = new_of_old[senders]
    r_new = new_of_old[receivers]
    owner_s = s_new // n_local
    owner_r = r_new // n_local

    send_idx, H, halo_slot = _halo_plan(
        s_new, owner_s, owner_r, n_local, num_parts, halo_pad_multiple)
    comb_all = np.where(owner_s == owner_r,
                        s_new - owner_r * n_local,
                        n_local + halo_slot).astype(np.int32)
    parts = []
    for s in range(num_parts):
        m = owner_r == s
        sp, rp = s_new[m], r_new[m]
        perm = sort_edges_by_receiver(sp, rp)
        parts.append((comb_all[m][perm], (rp - s * n_local)[perm],
                      edge_attr[m][perm]))
    sc, rl, ea, em = _pack_edge_streams(
        parts, num_parts, edge_attr.shape[1], edges_pad_multiple, dtype,
        pad_sender=n_local + num_parts * H - 1, pad_receiver=n_local - 1)
    sperm, ssort = sender_sort(sc)
    xs, ys, nm = _pack_nodes(order, n_local, num_parts, x, y, dtype)
    send_perm, send_sorted = send_sort(send_idx)
    return HaloSpatialGraph(
        x=xs, edge_attr=ea, senders_combined=sc, receivers_local=rl,
        send_idx=send_idx, node_mask=nm, edge_mask=em, y=ys,
        sender_perm=sperm, senders_sorted=ssort, send_perm=send_perm,
        send_sorted=send_sorted)


@dataclasses.dataclass(frozen=True)
class HaloSplitGraph(Sharded):
    """Spatially partitioned mesh with each shard's edges SPLIT into an
    interior stream (both endpoints local) and a boundary stream (sender
    remote, read from the halo table). Interior work depends on local
    tensors only; boundary edges are O(surface), interior O(volume)."""

    x: np.ndarray  # [P, Nl, Dn]
    # interior stream (sender local)
    edge_attr_int: np.ndarray  # [P, Ei, De]
    senders_int: np.ndarray  # i32[P, Ei] local rows
    receivers_int: np.ndarray  # i32[P, Ei] local rows (sorted)
    edge_mask_int: np.ndarray  # f32[P, Ei]
    # per-shard sender sort of the interior stream (the sender gather's
    # backward is a sorted segment sum: K5 on the card)
    sender_perm_int: np.ndarray  # i32[P, Ei]
    senders_int_sorted: np.ndarray  # i32[P, Ei]
    # boundary stream (senders index the [P*H] halo table)
    edge_attr_bnd: np.ndarray  # [P, Eb, De]
    senders_bnd: np.ndarray  # i32[P, Eb] halo-table rows
    receivers_bnd: np.ndarray  # i32[P, Eb] local rows (sorted)
    edge_mask_bnd: np.ndarray  # f32[P, Eb]
    send_idx: np.ndarray  # i32[P, P, H]
    node_mask: np.ndarray  # f32[P, Nl]
    y: np.ndarray  # [P, Nl, Dy]
    # interior streams block-aligned (ALIGN_NODE_BLOCK node blocks x
    # ALIGN_EDGE_TILE edge tiles per shard), the fused kernels' layout: an
    # explicit flag, divisible shapes alone are unsafe
    aligned: bool = False
    # per-shard sender sort of the boundary stream (the halo-table gather's
    # backward) and of the shipped rows (send_sort); the port's own
    sender_perm_bnd: Optional[np.ndarray] = None  # i32[P, Eb]
    senders_bnd_sorted: Optional[np.ndarray] = None  # i32[P, Eb]
    send_perm: Optional[np.ndarray] = None  # i32[P, P*H]
    send_sorted: Optional[np.ndarray] = None  # i32[P, P*H]

    @property
    def num_parts(self) -> int:
        return self.x.shape[0]

    @property
    def nodes_per_part(self) -> int:
        return self.x.shape[1]

    @property
    def halo_size(self) -> int:
        return self.send_idx.shape[2]


def partition_graph_halo_split(
    *,
    senders: np.ndarray,
    receivers: np.ndarray,
    x: np.ndarray,
    edge_attr: np.ndarray,
    pos: np.ndarray,
    y: Optional[np.ndarray],
    num_parts: int,
    edges_pad_multiple: int = 128,
    halo_pad_multiple: int = 8,
    dtype=np.float32,
    halo_rows=None,
    edges_int_rows=None,
    edges_bnd_rows=None,
    align_interior: bool = False,
    edge_aux: Optional[np.ndarray] = None,
):
    """partition_graph_halo with interior / boundary edge streams
    (HaloSplitGraph); vectorised.

    ``halo_rows`` / ``edges_int_rows`` / ``edges_bnd_rows`` override the
    padded sizes so shards of different samples share one shape (the
    boundary senders' halo-table rows bake H in, so at build time).
    ``align_interior=True`` pads each shard's node count to whole
    ALIGN_NODE_BLOCK blocks and block-aligns the interior streams for the
    fused kernels; the boundary stream stays plain. ``edge_aux`` carries
    extra per-edge columns (f64 [E, K]: ids, weights) through exactly the
    same permutation / padding / alignment as edge_attr, 0 on pad slots,
    and the result is then (graph, aux_int [P, Ei, K], aux_bnd [P, Eb, K])."""
    n = x.shape[0]
    order, new_of_old, n_local = _assign_parts(pos, n, num_parts)
    s_new = new_of_old[senders]
    r_new = new_of_old[receivers]
    owner_s = s_new // n_local
    owner_r = r_new // n_local

    send_idx, H, halo_slot = _halo_plan(
        s_new, owner_s, owner_r, n_local, num_parts, halo_pad_multiple,
        halo_rows=halo_rows)

    interior = owner_s == owner_r
    de = edge_attr.shape[1]
    pack_dtype = dtype
    ea_full = edge_attr
    if edge_aux is not None:
        # f64 keeps integer ids exact; f32 features round-trip exactly
        ea_full = np.concatenate(
            [edge_attr.astype(np.float64),
             np.asarray(edge_aux, dtype=np.float64)], axis=1)
        pack_dtype = np.float64
    parts_int, parts_bnd = [], []
    for s in range(num_parts):
        mi = (owner_r == s) & interior
        sp, rp = s_new[mi] - s * n_local, r_new[mi] - s * n_local
        perm = sort_edges_by_receiver(sp, rp)
        parts_int.append((sp[perm].astype(np.int32), rp[perm],
                          ea_full[mi][perm]))
        mb = (owner_r == s) & ~interior
        hs, rb = halo_slot[mb], r_new[mb] - s * n_local
        perm = sort_edges_by_receiver(hs, rb)
        parts_bnd.append((hs[perm].astype(np.int32), rb[perm],
                          ea_full[mb][perm]))
    if align_interior:
        n_local_pad = _round_up(n_local + 1, ALIGN_NODE_BLOCK)
        si, ri, eai, emi = pack_aligned_edges(
            parts_int, num_parts, ea_full.shape[1], n_local_pad, pack_dtype,
            rows=edges_int_rows, what="edges_int_rows")
    else:
        n_local_pad = n_local
        si, ri, eai, emi = _pack_edge_streams(
            parts_int, num_parts, ea_full.shape[1], edges_pad_multiple,
            pack_dtype, rows=edges_int_rows, pad_sender=n_local - 1,
            pad_receiver=n_local - 1)
    sb, rb, eab, emb = _pack_edge_streams(
        parts_bnd, num_parts, ea_full.shape[1], halo_pad_multiple,
        pack_dtype, rows=edges_bnd_rows, pad_sender=num_parts * H - 1,
        pad_receiver=n_local_pad - 1)
    sperm_i, ssort_i = sender_sort(si)
    sperm_b, ssort_b = sender_sort(sb)
    send_perm, send_sorted = send_sort(send_idx)

    aux_int = aux_bnd = None
    if edge_aux is not None:
        aux_int, eai = eai[..., de:], eai[..., :de].astype(dtype)
        aux_bnd, eab = eab[..., de:], eab[..., :de].astype(dtype)
        emi, emb = emi.astype(dtype), emb.astype(dtype)

    xs, ys, nm = _pack_nodes(order, n_local, num_parts, x, y, dtype,
                             rows=n_local_pad)
    sg = HaloSplitGraph(
        x=xs, edge_attr_int=eai, senders_int=si, receivers_int=ri,
        edge_mask_int=emi, sender_perm_int=sperm_i,
        senders_int_sorted=ssort_i, edge_attr_bnd=eab, senders_bnd=sb,
        receivers_bnd=rb, edge_mask_bnd=emb, send_idx=send_idx,
        node_mask=nm, y=ys, aligned=align_interior, sender_perm_bnd=sperm_b,
        senders_bnd_sorted=ssort_b, send_perm=send_perm,
        send_sorted=send_sorted)
    if edge_aux is not None:
        return sg, aux_int, aux_bnd
    return sg


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------

def _exchange_start(values: torch.Tensor, sh, group: C.Group) -> C.Pending:
    """Issue the exchange of ``values`` [Nl, h] by the shard's
    ``send_idx`` [P, H] (its backward over ``send_perm`` / ``send_sorted``);
    ``.wait().flatten(0, 1)`` is the halo table [P*H, h]."""
    send_buf = ops.gather_senders(values, sh.send_idx.reshape(-1),
                                  sh.send_perm, sh.send_sorted).reshape(
        tuple(sh.send_idx.shape) + (values.shape[-1],))
    return C.all_to_all_start(send_buf, group)


def _halo_layer(layer: B.MGNLayer, cfg: B.MGNLayerConfig, x, e,
                sh: HaloSpatialGraph, group: C.Group):
    n_local = x.shape[0]
    sg_args = (sh.senders_combined, sh.sender_perm, sh.senders_sorted)
    if cfg.do_concat_trick:
        p = layer.edge
        s_proj = x @ p.w_s
        halo = _exchange_start(s_proj, sh, group)
        d_proj = x @ p.w_d + p.b
        h_e = e @ p.w_e
        h_d = ops.gather_receivers(d_proj, sh.receivers_local)
        table = torch.cat([s_proj, halo.wait().flatten(0, 1)])
        h0 = h_e + ops.gather_senders(table, *sg_args) + h_d
        delta_e = B.edge_block_sum_post(p, h0, cfg)
    else:
        halo = _exchange_start(x, sh, group)
        x_d = ops.gather_receivers(x, sh.receivers_local)
        table = torch.cat([x, halo.wait().flatten(0, 1)])
        delta_e = M.mlp_apply(
            layer.edge,
            torch.cat([e, ops.gather_senders(table, *sg_args), x_d], dim=-1),
            activation=cfg.activation)
    e = e + delta_e
    agg = masked_sum(e, sh.edge_mask, sh.receivers_local, n_local)
    agg = mean_degree(agg, cfg, [(sh.receivers_local, sh.edge_mask)],
                      n_local)
    return x + B.node_block_post(layer.node, cfg, x, agg), e


def _remat_kw(cfg) -> dict:
    """The remat knobs of a halo forward, JAX's defaults through getattr
    (halo.py:503-510): per-layer "save_fused" remat."""
    return dict(remat=getattr(cfg, "remat", True),
                remat_policy=getattr(cfg, "remat_policy", "save_fused"),
                remat_group=getattr(cfg, "remat_group", 0),
                remat_group_policy=getattr(cfg, "remat_group_policy",
                                           "full"))


def halo_mgn_forward(params, cfg, sh: HaloSpatialGraph,
                     group: C.Group) -> torch.Tensor:
    """Per-shard MGN forward with the sparse halo exchange -> fp32
    [Nl, Dy]."""
    dt = getattr(cfg, "compute_dtype", "float32")
    if dt != "float32":
        sh = dataclasses.replace(sh, x=_cast(sh.x, dt),
                                 edge_attr=_cast(sh.edge_attr, dt),
                                 edge_mask=_cast(sh.edge_mask, dt))
    return with_compute_params(params, dt, _halo_mgn, cfg, sh, group)


def _halo_mgn(params, cfg, sh, group):
    x = M.mlp_apply(params.node_encoder, sh.x, activation=cfg.activation)
    e = M.mlp_apply(params.edge_encoder, sh.edge_attr,
                    activation=cfg.activation)
    layer_cfg = cfg.layer_cfg

    def body(carry, layer):
        return _halo_layer(layer, layer_cfg, *carry, sh, group)

    x, _ = checkpointed_layer_stack(body, (x, e), params.layers,
                                    **_remat_kw(cfg))
    return M.mlp_apply(params.decoder, x, activation=cfg.activation).float()


def fused_interior(cfg: B.MGNLayerConfig, x, sh: HaloSplitGraph) -> bool:
    """Whether ``_halo_split_layer`` runs the interior on the fused kernels
    (JAX's _fused_interior_ok, halo.py:514-525, by the single-device
    gate ``nn.blocks.uses_fused_layer`` on the interior stream): the
    partitioner's align_interior layout on the cuda backend."""
    return B.uses_fused_layer(cfg, x, sh.receivers_int, sh.edge_mask_int,
                              sh.aligned)


def _halo_rows(halo: C.Pending, sh: HaloSplitGraph) -> torch.Tensor:
    """The boundary senders' rows of the halo table (waited for here),
    their gather's backward over the boundary stream's sender sort."""
    return ops.gather_senders(halo.wait().flatten(0, 1), sh.senders_bnd,
                              sh.sender_perm_bnd, sh.senders_bnd_sorted)


def _halo_split_layer(layer: B.MGNLayer, cfg: B.MGNLayerConfig, x, e_int,
                      e_bnd, sh: HaloSplitGraph, group: C.Group):
    """One MGN layer on the split streams: the exchange issued first, the
    interior chain (on K1 / K3 when ``fused_interior``; the sender gather
    sorted, its backward on K5) while it is in flight, then the boundary
    chain, which waits for the halo table where it first reads it; its
    aggregate is added to the interior's. On the cuda backend the boundary
    chain's masked sum and its gathers' backward run on K5."""
    n_local = x.shape[0]
    int_args = (sh.senders_int, sh.sender_perm_int, sh.senders_int_sorted)
    streams = [(sh.receivers_int, sh.edge_mask_int),
               (sh.receivers_bnd, sh.edge_mask_bnd)]
    if fused_interior(cfg, x, sh):
        p = layer.edge
        s_proj = x @ p.w_s
        halo = _exchange_start(s_proj, sh, group)
        d_proj = x @ p.w_d + p.b
        sg = ops.gather_senders(s_proj, *int_args, aligned=True)
        e_int, agg = fused_edge(p, cfg, e_int, sg, d_proj, sh.edge_mask_int,
                                sh.receivers_int, n_local)
        h0_b = (e_bnd @ p.w_e
                + _halo_rows(halo, sh)
                + ops.gather_receivers(d_proj, sh.receivers_bnd))
        e_bnd = e_bnd + B.edge_block_sum_post(p, h0_b, cfg)
        agg = agg + masked_sum(e_bnd, sh.edge_mask_bnd, sh.receivers_bnd,
                               n_local)
        agg = mean_degree(agg, cfg, streams, n_local)
        x = B.node_block_post_residual(layer.node, cfg, x, agg)
        return x, e_int, e_bnd
    if cfg.do_concat_trick:
        p = layer.edge
        s_proj = x @ p.w_s
        halo = _exchange_start(s_proj, sh, group)
        d_proj = x @ p.w_d + p.b
        h0_i = (e_int @ p.w_e + ops.gather_senders(s_proj, *int_args)
                + ops.gather_receivers(d_proj, sh.receivers_int))
        de_i = B.edge_block_sum_post(p, h0_i, cfg)
        h0_b = (e_bnd @ p.w_e
                + _halo_rows(halo, sh)
                + ops.gather_receivers(d_proj, sh.receivers_bnd))
        de_b = B.edge_block_sum_post(p, h0_b, cfg)
    else:
        halo = _exchange_start(x, sh, group)
        de_i = M.mlp_apply(
            layer.edge,
            torch.cat([e_int, ops.gather_senders(x, *int_args),
                       ops.gather_receivers(x, sh.receivers_int)], dim=-1),
            activation=cfg.activation)
        de_b = M.mlp_apply(
            layer.edge,
            torch.cat([e_bnd,
                       _halo_rows(halo, sh),
                       ops.gather_receivers(x, sh.receivers_bnd)], dim=-1),
            activation=cfg.activation)
    e_int = e_int + de_i
    e_bnd = e_bnd + de_b
    agg = (masked_sum(e_int, sh.edge_mask_int, sh.receivers_int, n_local)
           + masked_sum(e_bnd, sh.edge_mask_bnd, sh.receivers_bnd, n_local))
    agg = mean_degree(agg, cfg, streams, n_local)
    return x + B.node_block_post(layer.node, cfg, x, agg), e_int, e_bnd


def cast_split_graph(sh: HaloSplitGraph, dt: str) -> HaloSplitGraph:
    """The compute-path float streams in the compute dtype (the masks too:
    an fp32 mask would promote every [E, h] product back to fp32); y and
    node_mask stay fp32 for the loss."""
    if dt == "float32":
        return sh
    return dataclasses.replace(
        sh, x=_cast(sh.x, dt),
        edge_attr_int=_cast(sh.edge_attr_int, dt),
        edge_attr_bnd=_cast(sh.edge_attr_bnd, dt),
        edge_mask_int=_cast(sh.edge_mask_int, dt),
        edge_mask_bnd=_cast(sh.edge_mask_bnd, dt))


def halo_split_stack(layers, cfg, x, e_int, e_bnd, sh: HaloSplitGraph,
                     group: C.Group, **remat):
    """``_halo_split_layer`` over ``layers`` under
    ``checkpointed_layer_stack`` (``remat``: its knobs); returns
    (x, e_int, e_bnd)."""
    layer_cfg = cfg.layer_cfg

    def body(carry, layer):
        return _halo_split_layer(layer, layer_cfg, *carry, sh, group)

    return checkpointed_layer_stack(
        body, (x, e_int, e_bnd), layers,
        fused=fused_interior(layer_cfg, x, sh), **remat)


def halo_split_mgn_forward(params, cfg, sh: HaloSplitGraph,
                           group: C.Group) -> torch.Tensor:
    """Per-shard MGN forward on the split streams -> fp32 [Nl, Dy]."""
    dt = getattr(cfg, "compute_dtype", "float32")
    return with_compute_params(params, dt, _halo_split_mgn, cfg,
                               cast_split_graph(sh, dt), group)


def _halo_split_mgn(params, cfg, sh, group):
    act = cfg.activation
    x = M.mlp_apply(params.node_encoder, sh.x, activation=act)
    e_int = M.mlp_apply(params.edge_encoder, sh.edge_attr_int, activation=act)
    e_bnd = M.mlp_apply(params.edge_encoder, sh.edge_attr_bnd, activation=act)
    x, _, _ = halo_split_stack(params.layers, cfg, x, e_int, e_bnd, sh,
                               group, **_remat_kw(cfg))
    return M.mlp_apply(params.decoder, x, activation=act).float()


def _forward_fn(forward, model_cfg, group):
    def fwd(params, sh):
        with torch.no_grad():
            return forward(params, model_cfg, sh, group)

    return fwd


def make_halo_split_forward(model_cfg, mesh: Mesh, *, axis: str = "graph"):
    """``fwd(params, sh)`` -> this shard's fp32 [Nl, Dy] predictions."""
    return _forward_fn(halo_split_mgn_forward, model_cfg, mesh.group(axis))


def make_halo_split_train_step(model_cfg, optimizer: torch.optim.Optimizer,
                               mesh: Mesh, *, axis: str = "graph"):
    """``step(params, sh)`` -> the global loss (``spatial.shard_loss``
    over the axis, gradients summed over it)."""
    group = mesh.group(axis)
    return make_sharded_step(
        lambda params, sh: halo_split_mgn_forward(params, model_cfg, sh,
                                                  group),
        optimizer, group, group)


def make_halo_forward(model_cfg, mesh: Mesh, *, axis: str = "graph"):
    return _forward_fn(halo_mgn_forward, model_cfg, mesh.group(axis))


def make_halo_train_step(model_cfg, optimizer: torch.optim.Optimizer,
                         mesh: Mesh, *, axis: str = "graph"):
    group = mesh.group(axis)
    return make_sharded_step(
        lambda params, sh: halo_mgn_forward(params, model_cfg, sh, group),
        optimizer, group, group)
