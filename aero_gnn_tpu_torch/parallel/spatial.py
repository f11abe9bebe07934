"""Spatial (graph) parallelism: one large mesh partitioned across ranks
(counterpart of aero_gnn_tpu.parallel.spatial, spatial.py:41-448).

Nodes are partitioned into P contiguous shards along a Morton order, every
edge lives on the shard of its RECEIVER (so aggregation is shard-local),
and the only cross-shard traffic is the sender-side feature exchange once
per message-passing layer: here one differentiable ``all_gather`` of the
projected sender features W_s x (concat-trick layer) or of x, whose
backward is a reduce-scatter (``parallel.collectives``).

Host side (numpy): ``partition_graph`` builds a ``SpatialGraph`` whose
arrays lead with [P, ...] and are bit-equal to the JAX package's;
``SpatialGraph.shard(p, device)`` is rank p's slice as tensors on its
device (the same dataclass, leading axis stripped, as JAX's per-shard view
inside ``shard_map``). With ``align_interior`` each shard's node count is
whole ALIGN_NODE_BLOCK blocks and its edge stream block-aligned, so the
per-shard layer runs the fused kernels K1 / K3 (K2 / K4 and the sender
gather's backward on K5) on the card.

The loss of the sharded steps is each shard's LOCAL numerator over the
GLOBAL count (``shard_loss``): a numerator summed across ranks inside the
differentiated function would seed every rank's backward with the sum of
the seeds, and the gradient sum would come out P times too large
(spatial.py:421-436).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from aero_gnn_tpu_torch import ops
from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.graph.order import morton_order
from aero_gnn_tpu_torch.graph.padded import (
    ALIGN_EDGE_TILE,
    ALIGN_NODE_BLOCK,
    _align_edge_blocks,
    _round_up,
    sort_edges_by_receiver,
)
from aero_gnn_tpu_torch.models.mgn import (
    _cast,
    cast_params,
    checkpointed_layer_stack,
)
from aero_gnn_tpu_torch.nn import blocks as B
from aero_gnn_tpu_torch.nn import mlp as M
from aero_gnn_tpu_torch.ops.hopper_fused import fused_edge_layer_autograd
from aero_gnn_tpu_torch.parallel import collectives as C
from aero_gnn_tpu_torch.parallel.mesh import Mesh


class Sharded:
    """A partition's arrays lead with [P, ...] (numpy, on the host);
    ``shard(p, device)`` is rank p's slice, the same dataclass with tensors
    on ``device`` and the leading axis stripped. Arrays named in
    ``REPLICATED`` and arrays inside tuples are the same on every shard
    and go to the device whole; nested partitions are sliced in turn;
    other fields (flags, sizes, None) pass through."""

    REPLICATED: Tuple[str, ...] = ()

    def shard(self, p: int, device: DeviceLike = None):
        dev = resolve_device(device)

        def put(v, whole):
            if isinstance(v, Sharded):
                return v.shard(p, dev)
            if isinstance(v, tuple):
                return tuple(put(a, True) for a in v)
            if isinstance(v, np.ndarray):
                return torch.from_numpy(
                    np.ascontiguousarray(v if whole else v[p])).to(dev)
            return v

        return dataclasses.replace(self, **{
            f.name: put(getattr(self, f.name), f.name in self.REPLICATED)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class SpatialGraph(Sharded):
    """One mesh partitioned into P shards ([P, ...] on the host).

    ``senders_global`` indexes the concatenated [P * n_local] node order
    (shard-major), i.e. directly into the all-gathered table."""

    x: np.ndarray  # [P, Nl, Dn]
    edge_attr: np.ndarray  # [P, El, De]
    senders_global: np.ndarray  # i32[P, El]
    receivers_local: np.ndarray  # i32[P, El] in [0, Nl)
    node_mask: np.ndarray  # f32[P, Nl]
    edge_mask: np.ndarray  # f32[P, El]
    y: np.ndarray  # [P, Nl, Dy]
    # per-shard sender sort: the sender gather's backward is a sorted
    # segment sum over the gathered table
    sender_perm: Optional[np.ndarray] = None  # i32[P, El]
    senders_sorted: Optional[np.ndarray] = None  # i32[P, El]
    # per-shard edge streams block-aligned (the fused kernels' layout): an
    # explicit flag, divisible shapes alone are unsafe
    aligned: bool = False

    @property
    def num_parts(self) -> int:
        return self.x.shape[0]

    @property
    def nodes_per_part(self) -> int:
        return self.x.shape[1]


def pack_aligned_edges(parts, num_parts, de, n_local_pad, dtype,
                       rows=None, *, what: str = "aligned rows"):
    """Block-align each shard's receiver-sorted (sender, recv_local, attr)
    edge stream (graph.padded._align_edge_blocks: every ALIGN_NODE_BLOCK
    node block owns whole ALIGN_EDGE_TILE-edge tiles) and pack shards to
    one padded length. Tail pad tiles point at the shard's last pad node
    (the last block), mask 0, so the receiver stream stays sorted and the
    kernels' tile walk exact. ``rows`` overrides the padded length."""
    aligned = []
    for sp, rp, eap in parts:
        s_a, r_a, ea_a, valid, _, _ = _align_edge_blocks(
            sp.astype(np.int64), rp.astype(np.int64), eap, n_local_pad,
            dtype)
        aligned.append((s_a, r_a, ea_a, valid))
    need = max(len(a[0]) for a in aligned)
    el = _round_up(need, ALIGN_EDGE_TILE)
    if rows is not None:
        if rows < need or rows % ALIGN_EDGE_TILE:
            raise ValueError(
                f"{what}={rows} incompatible with required {need} "
                f"(tile {ALIGN_EDGE_TILE})")
        el = rows
    pad_node = n_local_pad - 1
    si = np.full((num_parts, el), pad_node, dtype=np.int32)
    ri = np.full((num_parts, el), pad_node, dtype=np.int32)
    ea = np.zeros((num_parts, el, de), dtype=dtype)
    em = np.zeros((num_parts, el), dtype=dtype)
    for s, (sa, ra, ea_, va) in enumerate(aligned):
        k = len(sa)
        si[s, :k], ri[s, :k], ea[s, :k] = sa, ra, ea_
        em[s, :k] = va.astype(dtype)
    return si, ri, ea, em


def sender_sort(sc: np.ndarray):
    """Per-shard stable sender sort of a packed [P, El] sender stream ->
    (perm, sorted), for ops.gather_senders' sorted-transpose backward."""
    perm = np.argsort(sc, axis=1, kind="stable").astype(np.int32)
    return perm, np.take_along_axis(sc, perm, axis=1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SortOrder(Sharded):
    """A per-shard stable sort of a [P, ...] id table (``sort_order``):
    ``perm`` [P, R] the rows in id order, ``ids`` [P, R] the sorted ids, the
    stream K5 reads on the card (``ops.segment_pool_sum``,
    ``ops.gather_senders``)."""

    perm: np.ndarray
    ids: np.ndarray


def sort_order(ids: np.ndarray, valid: Optional[np.ndarray] = None,
               sink: Optional[int] = None) -> SortOrder:
    """The stable sort of each shard's ids (trailing axes flattened). With
    ``valid`` the invalid rows are keyed ``sink``, one past the last
    segment, so that they end the stream: a pool whose operand is zero
    there sums into ``sink + 1`` segments with ``pad_sink`` and K5 skips
    them (``parallel.bsms_spatial``)."""
    keys = ids if valid is None else np.where(valid, ids, sink)
    return SortOrder(*sender_sort(keys.reshape(keys.shape[0], -1)))


def partition_graph(
    *,
    senders: np.ndarray,
    receivers: np.ndarray,
    x: np.ndarray,
    edge_attr: np.ndarray,
    pos: np.ndarray,
    y: Optional[np.ndarray],
    num_parts: int,
    edges_pad_multiple: int = 128,
    dtype=np.float32,
    align_interior: bool = False,
) -> SpatialGraph:
    """Host-side partitioning of one REAL (unpadded) mesh into P shards.

    ``align_interior=True`` pads each shard's node count to whole
    ALIGN_NODE_BLOCK blocks and block-aligns the per-shard edge streams so
    the fused kernels run on the shard compute (gated by ``aligned``)."""
    n = x.shape[0]
    order = morton_order(pos)
    n_chunk = -(-n // num_parts)
    n_local = (_round_up(n_chunk + 1, ALIGN_NODE_BLOCK) if align_interior
               else n_chunk)
    # new id: shard-major layout [P * n_local]; tail slots are dummies
    new_of_old = np.full(n, -1, dtype=np.int64)
    for p in range(num_parts):
        chunk = order[p * n_chunk:(p + 1) * n_chunk]
        new_of_old[chunk] = p * n_local + np.arange(len(chunk))

    s_new = new_of_old[senders]
    r_new = new_of_old[receivers]
    part_of_edge = r_new // n_local

    per_part_edges = []
    for p in range(num_parts):
        m = part_of_edge == p
        s_p, r_p, ea_p = s_new[m], r_new[m], edge_attr[m]
        perm = sort_edges_by_receiver(s_p, r_p)
        per_part_edges.append((s_p[perm], r_p[perm] - p * n_local,
                               ea_p[perm]))
    if align_interior:
        # alignment fills pad-slot senders with in-block LOCAL rows (valid
        # rows of the gathered table; masked)
        sg, rl, ea, em = pack_aligned_edges(
            per_part_edges, num_parts, edge_attr.shape[1], n_local, dtype)
    else:
        el = _round_up(
            max(max((len(t[0]) for t in per_part_edges), default=1), 1),
            edges_pad_multiple)
        sg = np.zeros((num_parts, el), dtype=np.int32)
        # sorted-safe pads: last local row, mask 0 (contributions exact 0)
        rl = np.full((num_parts, el), n_local - 1, dtype=np.int32)
        ea = np.zeros((num_parts, el, edge_attr.shape[1]), dtype=dtype)
        em = np.zeros((num_parts, el), dtype=dtype)
        for p, (s_p, r_p, ea_p) in enumerate(per_part_edges):
            k = len(s_p)
            sg[p, :k], rl[p, :k], ea[p, :k] = s_p, r_p, ea_p
            em[p, :k] = 1.0
    xs = np.zeros((num_parts, n_local, x.shape[1]), dtype=dtype)
    ys = np.zeros((num_parts, n_local,
                   y.shape[1] if y is not None else 1), dtype=dtype)
    nm = np.zeros((num_parts, n_local), dtype=dtype)
    for p in range(num_parts):
        chunk = order[p * n_chunk:(p + 1) * n_chunk]
        k = len(chunk)
        xs[p, :k] = x[chunk]
        if y is not None:
            ys[p, :k] = y[chunk]
        nm[p, :k] = 1.0

    sperm, ssort = sender_sort(sg)
    return SpatialGraph(
        x=xs, edge_attr=ea, senders_global=sg, receivers_local=rl,
        node_mask=nm, edge_mask=em, y=ys, sender_perm=sperm,
        senders_sorted=ssort, aligned=align_interior)


def unshard_rows(out: np.ndarray, pos: np.ndarray, num_nodes: int,
                 num_parts: int) -> np.ndarray:
    """[P, Nl, D] per-shard rows back to the mesh's node order [N, D] (the
    Morton chunks of ``partition_graph`` / ``partition_graph_halo*``)."""
    order = morton_order(pos)
    n_chunk = -(-num_nodes // num_parts)
    got = np.zeros((num_nodes,) + out.shape[2:], out.dtype)
    for p in range(num_parts):
        chunk = order[p * n_chunk:(p + 1) * n_chunk]
        got[chunk] = out[p, :len(chunk)]
    return got


# ---------------------------------------------------------------------------
# sharded MGN forward (rank side)
# ---------------------------------------------------------------------------

def with_compute_params(params: torch.nn.Module, dtype: str, fn, *args):
    """``fn(params, *args)`` with the parameters cast to the compute dtype
    (``models.mgn.cast_params``: a cast autograd sees)."""
    casted = cast_params(params, dtype)
    if casted:
        return torch.func.functional_call(params, casted, (fn, *args))
    return fn(params, *args)


def edge_stack(p: B.EdgeBlockSum, like: torch.Tensor):
    """(ws, bs) of an EdgeBlockSum's hidden stack as the fused edge layer
    takes them (zero-size without hidden layers)."""
    h = like.shape[1]
    hidden = p.stack[:-1]
    ws = (torch.stack([s.w for s in hidden]) if len(hidden)
          else like.new_zeros((0, h, h)))
    bs = (torch.stack([s.b for s in hidden]) if len(hidden)
          else like.new_zeros((0, h)))
    return ws, bs


def fused_edge(p: B.EdgeBlockSum, cfg: B.MGNLayerConfig, e, sg, d_proj,
               edge_mask, receivers, n_local: int):
    """(e', agg) of the concat-trick edge layer on K1 (backward K2)."""
    ws, bs = edge_stack(p, sg)
    return fused_edge_layer_autograd(
        e, sg, d_proj, edge_mask, receivers, p.w_e, ws, bs, p.stack[-1].w,
        p.stack[-1].b, p.ln.scale, p.ln.bias, n_local,
        cfg.edge_sum_activation)


def mean_degree(agg, cfg: B.MGNLayerConfig, streams, n_local: int):
    """``agg`` divided by the in-degree over ``streams`` ((receivers, mask)
    pairs) under 'mean' aggregation; ValueError on an unknown mode."""
    if cfg.aggregation == "mean":
        deg = sum(ops.degree(r, n_local, mask=m, dtype=agg.dtype)
                  for r, m in streams)
        return agg / torch.clamp(deg, min=1.0)[:, None]
    if cfg.aggregation != "add":
        raise ValueError(f"Unsupported aggregation method: {cfg.aggregation}")
    return agg


def masked_sum(e, mask, receivers, n_local: int):
    """sum of mask * e by (sorted) receiver: [E, h] -> [N, h]; K5 on the
    cuda backend (``ops.segment_sum_masked``), else the plain sum."""
    return ops.segment_sum_masked(e, receivers, mask, n_local)


def _spatial_layer(layer: B.MGNLayer, cfg: B.MGNLayerConfig, x, e,
                   sh: SpatialGraph, group: C.Group):
    """One MGN layer on a shard; one all_gather per layer for the sender
    halo. On the align_interior layout (``B.uses_fused_layer``) the edge
    chain and aggregation run on K1 and the node update on K3 (backward
    K2, K4, and K5 for the sender gather); otherwise plain ops around
    K5's sums on the cuda backend (the aggregation, both gathers'
    backward; spatial.py:274-305)."""
    n_local = x.shape[0]
    sg_args = (sh.senders_global, sh.sender_perm, sh.senders_sorted)
    if B.uses_fused_layer(cfg, x, sh.receivers_local, sh.edge_mask,
                          sh.aligned):
        p = layer.edge
        s_proj = x @ p.w_s
        d_proj = x @ p.w_d + p.b
        all_s = C.all_gather_tiled(s_proj, group)  # [P*Nl, h]
        sg = ops.gather_senders(all_s, *sg_args, aligned=True)
        e, agg = fused_edge(p, cfg, e, sg, d_proj, sh.edge_mask,
                            sh.receivers_local, n_local)
        agg = mean_degree(agg, cfg, [(sh.receivers_local, sh.edge_mask)],
                          n_local)
        return B.node_block_post_residual(layer.node, cfg, x, agg), e
    if cfg.do_concat_trick:
        p = layer.edge
        s_proj = x @ p.w_s
        d_proj = x @ p.w_d + p.b
        all_s = C.all_gather_tiled(s_proj, group)
        h0 = (e @ p.w_e + ops.gather_senders(all_s, *sg_args)
              + ops.gather_receivers(d_proj, sh.receivers_local))
        delta_e = B.edge_block_sum_post(p, h0, cfg)
    else:
        all_x = C.all_gather_tiled(x, group)
        edge_input = torch.cat([e, ops.gather_senders(all_x, *sg_args),
                                ops.gather_receivers(x, sh.receivers_local)],
                               dim=-1)
        delta_e = M.mlp_apply(layer.edge, edge_input,
                              activation=cfg.activation)
    e = e + delta_e
    agg = masked_sum(e, sh.edge_mask, sh.receivers_local, n_local)
    agg = mean_degree(agg, cfg, [(sh.receivers_local, sh.edge_mask)],
                      n_local)
    return x + B.node_block_post(layer.node, cfg, x, agg), e


def spatial_mgn_forward(params, cfg, sh: SpatialGraph,
                        group: C.Group) -> torch.Tensor:
    """Per-shard MGN forward over ``group`` -> fp32 [Nl, Dy]. ``sh`` is
    this rank's shard (``SpatialGraph.shard``); the parameters those of
    MGNConfig (a FourierMGN's and poolMGN's MeshGraphNet part)."""
    dt = getattr(cfg, "compute_dtype", "float32")
    if dt != "float32":
        sh = dataclasses.replace(sh, x=_cast(sh.x, dt),
                                 edge_attr=_cast(sh.edge_attr, dt),
                                 edge_mask=_cast(sh.edge_mask, dt))
    return with_compute_params(params, dt, _spatial_mgn, cfg, sh, group)


def _spatial_mgn(params, cfg, sh: SpatialGraph, group: C.Group):
    x = M.mlp_apply(params.node_encoder, sh.x, activation=cfg.activation)
    e = M.mlp_apply(params.edge_encoder, sh.edge_attr,
                    activation=cfg.activation)
    layer_cfg = cfg.layer_cfg

    def body(carry, layer):
        return _spatial_layer(layer, layer_cfg, *carry, sh, group)

    # jax.checkpoint of the whole layer when remat (spatial.py:340-341)
    x, e = checkpointed_layer_stack(
        body, (x, e), params.layers, remat=getattr(cfg, "remat", True),
        remat_policy="full")
    return M.mlp_apply(params.decoder, x, activation=cfg.activation).float()


def spatial_model_forward(params, model_cfg, sh: SpatialGraph,
                          group: C.Group) -> torch.Tensor:
    """Model-kind dispatch for the spatially partitioned forward: MGN,
    FourierMGN (the local feature transform) and poolMGN (the global
    context as a cross-rank masked mean, sum or max: spatial.py:349-395)."""
    from aero_gnn_tpu_torch.models.fouriermgn import (
        FourierMGNConfig,
        fourier_embedding,
    )
    from aero_gnn_tpu_torch.models.poolmgn import PoolMGNConfig

    if isinstance(model_cfg, FourierMGNConfig):
        emb = fourier_embedding(
            sh.x, dims=model_cfg.fourier_features_dim,
            freq_start=model_cfg.fourier_freq_start,
            freq_length=model_cfg.fourier_freq_length)
        sh = dataclasses.replace(sh, x=torch.cat([sh.x, emb], dim=-1))
    elif isinstance(model_cfg, PoolMGNConfig):
        g = M.mlp_apply(params.global_encoder, sh.x,
                        activation=model_cfg.activation)
        m = sh.node_mask[:, None]
        method = model_cfg.global_pool_method
        if method == "mean":
            s = C.all_reduce_sum(torch.sum(g * m, dim=0), group)
            cnt = C.all_reduce_raw(torch.sum(sh.node_mask), group)
            pooled = s / torch.clamp(cnt, min=1.0)
        elif method in ("add", "sum"):
            pooled = C.all_reduce_sum(torch.sum(g * m, dim=0), group)
        elif method == "max":
            neg = torch.finfo(g.dtype).min
            local = torch.max(torch.where(m > 0, g, neg), dim=0).values
            pooled = C.all_gather_tiled(local[None], group).max(0).values
        else:
            raise ValueError(
                f"Unsupported global pooling method: {method}")
        x_in = torch.cat([sh.x, pooled[None].expand(sh.x.shape[0], -1)],
                         dim=-1)
        sh = dataclasses.replace(sh, x=x_in)
    return spatial_mgn_forward(params, model_cfg, sh, group)


def shard_loss(pred, y, node_mask, group: C.Group) -> torch.Tensor:
    """This shard's share of the global masked MSE: the LOCAL numerator
    over the GLOBAL count (no parameter path runs through the count's
    sum). Summed over the group it is the global loss."""
    m = node_mask[:, None]
    se = torch.sum(torch.square(pred - y) * m)
    cnt = C.all_reduce_raw((torch.sum(m) * y.shape[-1]).detach(), group)
    return se / cnt


def make_sharded_step(forward, optimizer: torch.optim.Optimizer,
                      loss_group: C.Group, grad_group: C.Group,
                      grad_scale: float = 1.0):
    """``step(params, sh)`` -> the global loss: ``forward(params, sh)``,
    ``shard_loss`` over ``loss_group``, the backward, the gradients summed
    over ``grad_group`` times ``grad_scale`` by one all_reduce, the
    optimizer step. The loss comes back summed the same way."""

    def step(params, sh):
        optimizer.zero_grad(set_to_none=True)
        pred = forward(params, sh)
        # a BSMS partition's targets are its fine level's
        g0 = getattr(sh, "fine", sh)
        loss = shard_loss(pred, g0.y, g0.node_mask, loss_group)
        loss.backward()
        C.sum_gradients(params, grad_group, grad_scale)
        optimizer.step()
        return C.all_reduce_raw(loss.detach(), grad_group) * grad_scale

    return step


def make_spatial_forward(model_cfg, mesh: Mesh, *, axis: str = "graph"):
    """``fwd(params, sh)`` -> this shard's fp32 [Nl, Dy] predictions, the
    mesh axis ``axis`` carrying the exchange."""
    group = mesh.group(axis)

    def fwd(params, sh):
        with torch.no_grad():
            return spatial_model_forward(params, model_cfg, sh, group)

    return fwd


def make_spatial_train_step(model_cfg, optimizer: torch.optim.Optimizer,
                            mesh: Mesh, *, axis: str = "graph"):
    """Spatially parallel train step ``step(params, sh)`` -> the global
    loss: per-shard forward, the globally masked MSE (``shard_loss``), the
    gradients summed over the shards, a replicated optimizer step."""
    group = mesh.group(axis)
    return make_sharded_step(
        lambda params, sh: spatial_mgn_forward(params, model_cfg, sh, group),
        optimizer, group, group)
