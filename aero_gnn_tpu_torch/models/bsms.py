"""Bi-strided multi-scale MeshGraphNet, a U-Net over graph hierarchies
(counterpart of aero_gnn_tpu.models.bsms).

The hierarchy is host data (``graph.hierarchy``); the forward is segment
math over its index arrays:

  down:  MGN layers on the fine stream, then the fine -> coarse transfer:
         "mean" — x_c = segment_mean(x_f by fine_to_coarse), e_c = masked
         segment_mean(e_f by edge_to_coarse); "weighted" — the
         WeightedEdgeConv (WEC): x_c = pool(rep_mask * A x_f), A the
         mass-normalised conv over the fine edge stream, and e_c the
         length-weighted mean of e_f;
  up:    x_f = x_c[fine_to_coarse] (weighted: A^T of rep_mask * that)
         plus the skip, e_f restored from the skip, then MGN layers.

``layers_per_scale`` MGN layers per down / up stage, the bottleneck gets
max(1, processor_size - 2 * sum(down)). The WEC pair A / A^T is two
autograd Functions, each one's backward the other's forward, with no
gradient for the index and weight operands; on an aligned stream on the
cuda backend each runs kernel K7 through ``ops.aggregate_edges_weighted``
with the gather x[senders] folded into the kernel (``rows``). The
processors run the MGN layer, so K1-K5 carry every scale of an aligned
hierarchy.

Dtypes: the JAX package's BSMS never casts its parameters or inputs to
``compute_dtype`` (its apply calls the forward directly), and JAX promotes
a float32 input times bfloat16 weights to float32, so its BSMS computes in
float32 whatever ``compute_dtype`` says. The port does the same: the
parameters are cast up to float32 (a cast autograd sees) and the inputs
taken as float32.

Every sum on the cuda backend adds in an order fixed by the hierarchy:
the down path's node and edge pools run as ``ops.segment_pool_sum`` over
the level's pool permutations (kernel K5), each stream cut before its pad
tail (``HierarchyLevel.node_pool_live`` / ``edge_pool_live``: every pool
operand is masked to zero there), and the up path's unpool as
``ops.gather_chunked`` (its backward K5 through the level's chunk plan,
``unpool_chunks``, which splits the pad tail's long run).

Two switches, read at call time from the JAX package's environment names
and off by default, as there:

  * ``AERO_GNN_SORTED_POOL=1``: the sorted pools on the torch backend too
    (the JAX package's switch schedules XLA's scatter on the TPU; off, the
    torch backend pools with the plain ``segment_sum`` / ``segment_mean``);
  * ``AERO_GNN_WEC_FUSED=0``: the WEC multiplies ``ce * x[senders]`` in its
    own pass and aggregates it with ``ops.aggregate_edges`` (K5) in place
    of K7.

The JAX package's third, ``AERO_GNN_WEC_DTYPE=compute``, casts the WEC's
weights to the data's dtype: the identity while BSMS computes in float32,
in both packages, so the port does not read it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from aero_gnn_tpu_torch import ops
from aero_gnn_tpu_torch.device import DeviceLike
from aero_gnn_tpu_torch.graph.hierarchy import HierarchyLevel
from aero_gnn_tpu_torch.graph.padded import GraphBatch
from aero_gnn_tpu_torch.models.mgn import (
    MGNConfig,
    ModelParams,
    cast_params,
    check_apply,
    init_params,
    run_processor,
)
from aero_gnn_tpu_torch.nn import blocks as B
from aero_gnn_tpu_torch.nn import mlp as M
from aero_gnn_tpu_torch.ops.scatter import (
    gather,
    segment_mean,
    segment_pool_sum,
    segment_sum,
)


class Stream(NamedTuple):
    """One scale's edge streams: a GraphBatch's or a HierarchyLevel's
    coarse graph."""

    senders: torch.Tensor
    receivers: torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor
    sender_perm: Optional[torch.Tensor]
    senders_sorted: Optional[torch.Tensor]
    aligned: bool

    @classmethod
    def of(cls, g: Union[GraphBatch, HierarchyLevel]) -> "Stream":
        return cls(g.senders, g.receivers, g.edge_mask, g.node_mask,
                   g.sender_perm, g.senders_sorted, g.edges_aligned)


def _wec_fused_enabled() -> bool:
    """AERO_GNN_WEC_FUSED (default on): the weight folded into K7's
    aggregation; 0 multiplies the [E, h] stream in its own pass."""
    return os.environ.get("AERO_GNN_WEC_FUSED", "1") == "1"


def _sorted_pool_enabled() -> bool:
    """AERO_GNN_SORTED_POOL=1 (default off): the pools in sorted order
    (ops.segment_pool_sum) on the torch backend too."""
    return os.environ.get("AERO_GNN_SORTED_POOL", "0") == "1"


def _wec_sum(st: Stream, x, ce, ids, rows):
    """sum over the rows of ``ids`` of ce * x[rows]: K7 with the weight
    folded in, or (AERO_GNN_WEC_FUSED=0) the weighted rows in their own
    pass summed by ops.aggregate_edges. The weights are zero on pad rows,
    so the pad sink's rows add nothing. Called only inside the WEC's
    autograd Functions, which record no graph: the gather of the unfused
    pass has no backward here."""
    if _wec_fused_enabled():
        return ops.aggregate_edges_weighted(x, ce, ids, x.shape[0],
                                            aligned=st.aligned, rows=rows)
    return ops.aggregate_edges(ce[:, None] * gather(x, rows), ids,
                               x.shape[0], aggregation="add",
                               aligned=st.aligned, pad_sink=True)


def _wec_A_raw(st: Stream, x, cs, ce):
    """A x: the receiver-sorted WeightedEdgeConv aggregation."""
    return cs[:, None] * x + _wec_sum(st, x, ce, st.receivers, st.senders)


def _wec_At_raw(st: Stream, y, cs, ce, ce_t):
    """A^T y. On a symmetric stream it is the forward conv with the
    reverse-edge weights ``ce_t``; otherwise it runs on the sender-sorted
    stream (an unsorted segment sum without one, which the cuda backend
    refuses on a CUDA tensor)."""
    if ce_t is not None:
        return _wec_A_raw(st, y, cs, ce_t)
    if st.sender_perm is None or st.senders_sorted is None:
        if ops.backend() == "cuda" and y.is_cuda:
            raise ValueError("the WEC adjoint on the cuda backend needs the "
                             "stream's sender sort")
        zr = gather(y, st.receivers)
        return cs[:, None] * y + segment_sum(ce[:, None] * zr, st.senders,
                                             y.shape[0])
    recv_s = gather(st.receivers, st.sender_perm)
    ce_s = gather(ce, st.sender_perm)
    return cs[:, None] * y + _wec_sum(st, y, ce_s, st.senders_sorted, recv_s)


class _WecA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cs, ce, ce_t, st):
        ctx.args = (cs, ce, ce_t, st)
        return _wec_A_raw(st, x, cs, ce)

    @staticmethod
    def backward(ctx, ct):
        cs, ce, ce_t, st = ctx.args
        return _wec_At_raw(st, ct.contiguous(), cs, ce, ce_t), \
            None, None, None, None


class _WecAt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, cs, ce, ce_t, st):
        ctx.args = (cs, ce, st)
        return _wec_At_raw(st, z, cs, ce, ce_t)

    @staticmethod
    def backward(ctx, ct):
        cs, ce, st = ctx.args
        return _wec_A_raw(st, ct.contiguous(), cs, ce), \
            None, None, None, None


def _stream(senders, receivers, sperm, ssort, aligned) -> Stream:
    """The fields of a Stream the WEC reads (no masks: its weights are zero
    on pad rows)."""
    return Stream(senders, receivers, None, None, sperm, ssort, aligned)


def wec_aggregate(level: HierarchyLevel, x: torch.Tensor, senders, receivers,
                  sperm=None, ssort=None,
                  aligned: bool = False) -> torch.Tensor:
    """WeightedEdgeConv aggregation on FINE node rows: x~_i = conv_self[i]
    x_i + sum_{e: recv(e) = i} conv_edge[e] x_send(e) (rows sum to 1;
    weights fp32 and zero on pad rows, so no mask is needed)."""
    st = _stream(senders, receivers, sperm, ssort, aligned)
    return _WecA.apply(x, level.conv_self, level.conv_edge,
                       level.conv_edge_t, st)


def wec_down(level: HierarchyLevel, x: torch.Tensor, senders, receivers,
             sperm=None, ssort=None, aligned: bool = False,
             pool=None) -> torch.Tensor:
    """Weighted fine -> coarse node transfer: the conv, then each coarse
    node's representative fine node (rep_mask) pooled by fine_to_coarse
    (``pool``, by default the model's pool of the node rows)."""
    agg = wec_aggregate(level, x, senders, receivers, sperm, ssort, aligned)
    sel = agg * level.rep_mask.to(agg.dtype)[:, None]
    return (pool or _pools(level)[0])(sel)


def wec_up(level: HierarchyLevel, xc_fine: torch.Tensor, senders, receivers,
           sperm=None, ssort=None, aligned: bool = False) -> torch.Tensor:
    """Weighted coarse -> fine transfer, the exact adjoint of wec_down:
    ``xc_fine`` (x_c[fine_to_coarse]) placed at the representatives, then
    the transposed conv."""
    z = xc_fine * level.rep_mask.to(xc_fine.dtype)[:, None]
    st = _stream(senders, receivers, sperm, ssort, aligned)
    return _WecAt.apply(z, level.conv_self, level.conv_edge,
                        level.conv_edge_t, st)


@dataclasses.dataclass(frozen=True)
class BSMSConfig(MGNConfig):
    num_scales: int = 3
    layers_per_scale: int = 2
    stride: int = 2
    hierarchy_mode: str = "stride"  # "stride" | "bistride"
    transfer: str = "mean"  # "mean" | "weighted" (WeightedEdgeConv)

    @property
    def down_counts(self) -> Sequence[int]:
        return [self.layers_per_scale] * max(self.num_scales - 1, 0)

    @property
    def bottleneck_count(self) -> int:
        return max(1, self.processor_size - 2 * sum(self.down_counts))

    @property
    def params_dtype(self) -> torch.dtype:
        """float32 whatever compute_dtype says (module docstring)."""
        return torch.float32

    def init(self, generator: Union[torch.Generator, int, None] = None, *,
             device: DeviceLike = None) -> "BSMS":
        """Random parameters drawn on the CPU from ``generator`` (a CPU
        torch.Generator or an int seed), moved to ``device`` (CUDA unless
        ``"cpu"``)."""
        return init_params(BSMS, self, generator, device)

    def apply(self, params: "BSMS", graph: GraphBatch, *,
              hierarchy: Tuple[HierarchyLevel, ...],
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward pass -> fp32 [N_pad, output_node_dim]. ``generator`` (on
        the graph's device) turns on the encoders' dropout."""
        if len(hierarchy) != self.num_scales - 1:
            raise ValueError(f"hierarchy has {len(hierarchy)} levels, "
                             f"expected {self.num_scales - 1}")
        if any(lv.device != graph.device for lv in hierarchy):
            raise ValueError(f"the graph is on {graph.device}, the hierarchy "
                             f"on {[str(lv.device) for lv in hierarchy]}")
        if self.transfer not in ("mean", "weighted"):
            raise ValueError(f"Unknown transfer: {self.transfer}")
        check_apply(self, params, graph)
        casted = cast_params(params, "float32")
        if casted:
            return torch.func.functional_call(
                params, casted, (self._forward, graph, hierarchy, generator))
        return self._forward(params, graph, hierarchy, generator)

    def _process(self, layers: nn.ModuleList, x, e, st: Stream):
        return run_processor(layers, self.layer_cfg, x, e, st.senders,
                             st.receivers, st.edge_mask,
                             sender_perm=st.sender_perm,
                             senders_sorted=st.senders_sorted,
                             aligned=st.aligned, remat=self.remat,
                             remat_policy=self.remat_policy)

    def _forward(self, params: "BSMS", graph: GraphBatch, hierarchy,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        x = M.mlp_apply(params.node_encoder, graph.x.float(),
                        activation=self.activation, dropout=self.dropout,
                        generator=generator)
        e = M.mlp_apply(params.edge_encoder, graph.edge_attr.float(),
                        activation=self.activation, dropout=self.dropout,
                        generator=generator)
        if self.dropout > 0.0 and generator is not None:
            x = _dropout(x, self.dropout, generator)
            e = _dropout(e, self.dropout, generator)
        weighted = self.transfer == "weighted"
        st = Stream.of(graph)
        skips = []
        for s, level in enumerate(hierarchy):
            x, e = self._process(params.down[s], x, e, st)
            skips.append((x, e, st))
            pool_nodes, pool_edges = _pools(level)
            if weighted:
                x = wec_down(level, x, st.senders, st.receivers,
                             st.sender_perm, st.senders_sorted, st.aligned,
                             pool=pool_nodes)
                w_e = level.edge_weights * st.edge_mask
                es = pool_edges(e * w_e[:, None])
                wsum = pool_edges(w_e)
                e = es / torch.clamp(wsum, min=1e-12)[:, None]
            else:
                xs = pool_nodes(x * st.node_mask[:, None])
                cnt = pool_nodes(st.node_mask)
                x = xs / torch.clamp(cnt, min=1.0)[:, None]
                if _sorted(level):
                    es = pool_edges(e * st.edge_mask[:, None])
                    ecnt = pool_edges(st.edge_mask)
                    e = es / torch.clamp(ecnt, min=1.0)[:, None]
                else:
                    e = segment_mean(e, level.edge_to_coarse,
                                     level.num_coarse_edges_pad,
                                     mask=st.edge_mask)
            st = Stream.of(level)

        x, e = self._process(params.bottleneck, x, e, st)

        for i in range(len(hierarchy)):
            level = hierarchy[-(i + 1)]
            skip_x, skip_e, st = skips[-(i + 1)]
            # the unpool; its backward sums by coarse node through the
            # level's chunk plan on the cuda backend
            xc = ops.gather_chunked(x, level.fine_to_coarse,
                                    level.unpool_chunks)
            if weighted:
                xc = wec_up(level, xc, st.senders, st.receivers,
                            st.sender_perm, st.senders_sorted, st.aligned)
            x, e = self._process(params.up[i], xc + skip_x, skip_e, st)
        return M.mlp_apply(params.decoder, x,
                           activation=self.activation).float()


def _sorted(level: HierarchyLevel) -> bool:
    """Whether the level's pools run in sorted order: on the cuda backend,
    or under AERO_GNN_SORTED_POOL=1."""
    return level.node_pool_perm is not None and (
        ops.backend() == "cuda" or _sorted_pool_enabled())


def _pools(level: HierarchyLevel):
    """(pool of fine node rows, pool of fine edge rows) onto the level's
    coarse graph: sorted (ops.segment_pool_sum) where ``_sorted``, else the
    plain segment sum. The sorted pools stop before each stream's pad tail,
    whose rows every pool operand masks to zero (so K5 does not walk that
    one long run)."""
    nc, ec = level.num_coarse_nodes_pad, level.num_coarse_edges_pad
    if _sorted(level):
        n_live, e_live = level.node_pool_live, level.edge_pool_live
        return (lambda v: segment_pool_sum(
                    v, level.fine_to_coarse, nc,
                    perm=level.node_pool_perm[:n_live],
                    seg_sorted=level.node_pool_sorted[:n_live]),
                lambda v: segment_pool_sum(
                    v, level.edge_to_coarse, ec,
                    perm=level.edge_pool_perm[:e_live],
                    seg_sorted=level.edge_pool_sorted[:e_live]))
    return (lambda v: segment_sum(v, level.fine_to_coarse, nc),
            lambda v: segment_sum(v, level.edge_to_coarse, ec))


class BSMS(ModelParams):
    """Parameters of a BSMSConfig: node / edge encoders, ``down`` (one
    ModuleList of MGNLayers per down stage), ``bottleneck``, ``up`` (one
    per up stage, coarsest first) and the decoder."""

    def __init__(self, cfg: BSMSConfig, generator: torch.Generator):
        super().__init__()
        hp = cfg.hidden_dim_processor
        self.node_encoder = M.MLP(
            cfg.input_node_dim, cfg.hidden_dim_node_encoder, hp,
            num_hidden_layers=cfg.num_hidden_layers_node_encoder,
            use_layer_norm=True, generator=generator)
        self.edge_encoder = M.MLP(
            cfg.input_edge_dim, cfg.hidden_dim_edge_encoder, hp,
            num_hidden_layers=cfg.num_hidden_layers_edge_encoder,
            use_layer_norm=True, generator=generator)
        self.decoder = M.MLP(hp, cfg.hidden_dim_decoder, cfg.output_node_dim,
                             num_hidden_layers=cfg.num_hidden_layers_decoder,
                             use_layer_norm=False, generator=generator)

        def stack(count):
            return nn.ModuleList(B.MGNLayer(cfg.layer_cfg, generator)
                                 for _ in range(count))

        self.down = nn.ModuleList(stack(c) for c in cfg.down_counts)
        self.bottleneck = stack(cfg.bottleneck_count)
        self.up = nn.ModuleList(stack(c) for c in reversed(cfg.down_counts))


def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
