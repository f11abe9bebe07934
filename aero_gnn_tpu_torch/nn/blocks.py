"""Message-passing blocks (counterpart of aero_gnn_tpu.nn.blocks).

  * ``edge_block_apply``     — MLP over [e, x_src, x_dst] (full concat form)
  * ``edge_block_sum_*``     — the "concat trick": the first linear split into
    W_e/W_s/W_d, nodes projected before the gather. As in the reference,
    EdgeBlockSum hardcodes ReLU whatever the configured activation
    (``edge_sum_activation``, default "relu").
  * ``node_block_*``         — aggregate incoming messages by receiver
    (add | mean), concat with the node state, MLP
  * ``mgn_layer_apply``      — edge update + residual, then node update +
    residual. On the cuda backend with an aligned graph the concat-trick
    layer runs the fused Hopper kernels K1 (edge) and K3 (node) forward,
    K2 and K4 backward (K1's save variant and K8 for the edge layer with
    ``AERO_GNN_SAVE_ACTS=1``), and the sender gather's backward on K5; with
    ``AERO_GNN_MEGA=1`` and 'add' aggregation the whole layer is K9 (its
    forward and backward kernels) instead of K1-K4. The
    unfused layer (``do_concat_trick=False``, the registry's default) runs
    its receiver gather on K6 on an aligned graph, and on the cuda backend
    its sums on K5 with the pad sink declared (the aggregation, the
    receiver and the sender gather's backward) on any graph of
    ``graph.padded``; the rest are plain ops (the node update is
    ``node_block_post``).

All functions take explicit masks so pad edges/nodes contribute zeros, and
are differentiable end to end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from aero_gnn_tpu_torch import ops
from aero_gnn_tpu_torch.nn import mlp as M
from aero_gnn_tpu_torch.ops.hopper_fused import (
    ET,
    NB,
    fused_edge_layer_autograd,
)
from aero_gnn_tpu_torch.ops.hopper_mega import (
    fused_mgn_layer_autograd,
    mega_enabled,
)
from aero_gnn_tpu_torch.ops.hopper_node import fused_node_layer_autograd


@dataclasses.dataclass(frozen=True)
class MGNLayerConfig:
    node_dim: int
    edge_dim: int
    hidden_dim: int = 128
    num_hidden_layers_node: int = 1
    num_hidden_layers_edge: int = 1
    activation: str = "relu"
    use_layer_norm: bool = True
    aggregation: str = "add"
    do_concat_trick: bool = False
    # reference quirk: EdgeBlockSum hardcodes ReLU
    edge_sum_activation: str = "relu"

    def ln_in_edge_block(self) -> bool:
        return self.use_layer_norm


# ---------------------------------------------------------------------------
# EdgeBlock (full concat form)
# ---------------------------------------------------------------------------

def edge_block_init(cfg: MGNLayerConfig, generator=None) -> M.MLP:
    return M.MLP(cfg.edge_dim + 2 * cfg.node_dim, cfg.hidden_dim,
                 cfg.edge_dim, num_hidden_layers=cfg.num_hidden_layers_edge,
                 use_layer_norm=cfg.use_layer_norm, generator=generator)


def edge_block_apply(mlp: M.MLP, cfg: MGNLayerConfig,
                     edge_attr: torch.Tensor, node_attr: torch.Tensor,
                     senders: torch.Tensor, receivers: torch.Tensor,
                     sender_perm: Optional[torch.Tensor] = None,
                     senders_sorted: Optional[torch.Tensor] = None,
                     aligned: bool = False) -> torch.Tensor:
    # the streams of graph.padded: rows keyed by the pad sink are pad rows
    x_src = ops.gather_senders(node_attr, senders, sender_perm,
                               senders_sorted, aligned, pad_sink=True)
    x_dst = ops.gather_receivers(node_attr, receivers, aligned,
                                 pad_sink=True)
    edge_input = torch.cat([edge_attr, x_src, x_dst], dim=-1)
    return M.mlp_apply(mlp, edge_input, activation=cfg.activation)


# ---------------------------------------------------------------------------
# EdgeBlockSum (concat trick / project-then-gather; the fusable form)
# ---------------------------------------------------------------------------

class EdgeBlockSum(nn.Module):
    """One [De + 2 Dn, h] linear split row-wise into ``w_e``/``w_s``/``w_d``
    with bias ``b``, then the post stack (ReLU, (Linear, ReLU) * n_hidden,
    Linear) and an optional LayerNorm."""

    def __init__(self, cfg: MGNLayerConfig, generator=None):
        super().__init__()
        full = M.Linear(cfg.edge_dim + 2 * cfg.node_dim, cfg.hidden_dim,
                        generator=generator)
        w = full.w.detach()
        de, dn = cfg.edge_dim, cfg.node_dim
        self.w_e = nn.Parameter(w[:de].clone())
        self.w_s = nn.Parameter(w[de:de + dn].clone())
        self.w_d = nn.Parameter(w[de + dn:].clone())
        self.b = nn.Parameter(full.b.detach().clone())
        dims = [(cfg.hidden_dim, cfg.hidden_dim)] * cfg.num_hidden_layers_edge
        dims += [(cfg.hidden_dim, cfg.edge_dim)]
        self.stack = nn.ModuleList(
            M.Linear(fi, fo, generator=generator) for fi, fo in dims)
        self.ln = M.LayerNorm(cfg.edge_dim) if cfg.use_layer_norm else None


def edge_block_sum_pre(p: EdgeBlockSum, edge_attr: torch.Tensor,
                       node_attr: torch.Tensor, senders: torch.Tensor,
                       receivers: torch.Tensor,
                       sender_perm: Optional[torch.Tensor] = None,
                       senders_sorted: Optional[torch.Tensor] = None,
                       aligned: bool = False) -> torch.Tensor:
    """h0 = W_e e + (W_s x)[src] + (W_d x + b)[dst]."""
    e_proj = edge_attr @ p.w_e
    s_proj = node_attr @ p.w_s
    d_proj = node_attr @ p.w_d + p.b
    return (e_proj
            + ops.gather_senders(s_proj, senders, sender_perm,
                                 senders_sorted, aligned, pad_sink=True)
            + ops.gather_receivers(d_proj, receivers, aligned,
                                   pad_sink=True))


def edge_block_sum_post(p: EdgeBlockSum, h0: torch.Tensor,
                        cfg: MGNLayerConfig) -> torch.Tensor:
    act = M.activation_fn(cfg.edge_sum_activation)
    z = act(h0)
    for lin in p.stack[:-1]:
        z = act(lin(z))
    z = p.stack[-1](z)
    if p.ln is not None:
        z = M.layer_norm_apply(p.ln, z)
    return z


def edge_block_sum_apply(p: EdgeBlockSum, cfg: MGNLayerConfig,
                         edge_attr: torch.Tensor, node_attr: torch.Tensor,
                         senders: torch.Tensor, receivers: torch.Tensor,
                         sender_perm: Optional[torch.Tensor] = None,
                         senders_sorted: Optional[torch.Tensor] = None,
                         aligned: bool = False) -> torch.Tensor:
    h0 = edge_block_sum_pre(p, edge_attr, node_attr, senders, receivers,
                            sender_perm, senders_sorted, aligned)
    return edge_block_sum_post(p, h0, cfg)


# ---------------------------------------------------------------------------
# NodeBlock
# ---------------------------------------------------------------------------

def node_block_init(cfg: MGNLayerConfig, generator=None) -> M.MLP:
    return M.MLP(cfg.node_dim + cfg.edge_dim, cfg.hidden_dim, cfg.node_dim,
                 num_hidden_layers=cfg.num_hidden_layers_node,
                 use_layer_norm=cfg.use_layer_norm, generator=generator)


def node_block_post(mlp: M.MLP, cfg: MGNLayerConfig, node_attr: torch.Tensor,
                    edge_aggr: torch.Tensor) -> torch.Tensor:
    """Node MLP over [x, aggregated messages]."""
    node_input = torch.cat([node_attr, edge_aggr], dim=-1)
    return M.mlp_apply(mlp, node_input, activation=cfg.activation)


def _fused_node_ok(mlp: M.MLP, cfg: MGNLayerConfig,
                   node_attr: torch.Tensor) -> bool:
    """Gate for the fused node kernel: square ReLU + LN chain over a
    256-row-divisible N (no edge alignment needed)."""
    if ops.backend() != "cuda" or cfg.activation != "relu":
        return False
    n, h = node_attr.shape
    if n % 256 != 0:
        return False
    lins = mlp.linears
    if mlp.ln is None or len(lins) < 2:
        return False
    if tuple(lins[0].w.shape) != (2 * h, h) or \
            tuple(lins[-1].w.shape) != (h, h):
        return False
    return all(tuple(lin.w.shape) == (h, h) for lin in lins[1:-1])


def _pack_node_split(mlp: M.MLP, h: int, dtype, device):
    """Split-concat packing of a NodeBlock MLP for the fused kernel: first
    linear split into W1x/W1a (rows [:h] / [h:]), hidden stack stacked,
    output linear + LN separate."""
    lins = mlp.linears
    w1 = lins[0].w
    hidden = lins[1:-1]
    ws = (torch.stack([lin.w for lin in hidden]) if len(hidden)
          else torch.zeros((0, h, h), dtype=dtype, device=device))
    bs = (torch.stack([lin.b for lin in hidden]) if len(hidden)
          else torch.zeros((0, h), dtype=dtype, device=device))
    return {"w1x": w1[:h], "w1a": w1[h:], "b1": lins[0].b,
            "ws": ws, "bs": bs,
            "w_out": lins[-1].w, "b_out": lins[-1].b,
            "ln_scale": mlp.ln.scale, "ln_bias": mlp.ln.bias}


def node_block_post_residual(mlp: M.MLP, cfg: MGNLayerConfig,
                             node_attr: torch.Tensor,
                             edge_aggr: torch.Tensor) -> torch.Tensor:
    """x + NodeBlock(x, agg), on the fused kernels K3 / K4 when legal."""
    if not _fused_node_ok(mlp, cfg, node_attr):
        return node_attr + node_block_post(mlp, cfg, node_attr, edge_aggr)
    p = _pack_node_split(mlp, node_attr.shape[1], node_attr.dtype,
                         node_attr.device)
    return fused_node_layer_autograd(
        node_attr, edge_aggr.to(node_attr.dtype),
        p["w1x"], p["w1a"], p["b1"], p["ws"], p["bs"],
        p["w_out"], p["b_out"], p["ln_scale"], p["ln_bias"])


def node_block_apply(mlp: M.MLP, cfg: MGNLayerConfig,
                     node_attr: torch.Tensor, edge_attr: torch.Tensor,
                     receivers: torch.Tensor,
                     edge_mask: Optional[torch.Tensor],
                     aligned: bool = False) -> torch.Tensor:
    """NodeBlock over a stream of ``graph.padded`` (GraphBatch or
    HierarchyLevel), whose last node is the pad sink: the aggregation
    declares it (``pad_sink``), so on an aligned stream K5 skips the sink's
    pad rows."""
    edge_aggr = ops.aggregate_edges(
        edge_attr, receivers, node_attr.shape[0],
        aggregation=cfg.aggregation, edge_mask=edge_mask, aligned=aligned,
        pad_sink=True)
    return node_block_post(mlp, cfg, node_attr, edge_aggr)


# ---------------------------------------------------------------------------
# MGN layer (edge residual then node residual)
# ---------------------------------------------------------------------------

class MGNLayer(nn.Module):
    def __init__(self, cfg: MGNLayerConfig, generator=None):
        super().__init__()
        self.edge = (EdgeBlockSum(cfg, generator) if cfg.do_concat_trick
                     else edge_block_init(cfg, generator))
        self.node = node_block_init(cfg, generator)

    def forward(self, fn, *args):
        """``fn(self, *args)``: lets torch.func.functional_call run a
        function of the layer with substituted parameters."""
        return fn(self, *args)


def uses_fused_layer(cfg: MGNLayerConfig, node_attr: torch.Tensor,
                     receivers: torch.Tensor,
                     edge_mask: Optional[torch.Tensor], aligned: bool) -> bool:
    """Whether mgn_layer_apply takes the fused path (K1-K5 on the card):
    cuda backend, concat trick with LayerNorm and ReLU, an edge mask and
    the block-aligned layout."""
    if not aligned or ops.backend() != "cuda" or not cfg.do_concat_trick:
        return False
    if not cfg.ln_in_edge_block() or cfg.edge_sum_activation != "relu":
        return False
    if edge_mask is None:
        return False
    return receivers.shape[0] % ET == 0 and node_attr.shape[0] % NB == 0


def _mega_layer_ok(layer: MGNLayer, cfg: MGNLayerConfig,
                   node_attr: torch.Tensor) -> bool:
    """Gate for the single-kernel layer (K9, ops.hopper_mega): 'add'
    aggregation (no degree division between the edge and node halves),
    ``AERO_GNN_MEGA=1``, and the fused node kernel's legality at the node
    block size (JAX nn/blocks.py:271-281)."""
    if cfg.aggregation != "add" or not mega_enabled():
        return False
    if not _fused_node_ok(layer.node, cfg, node_attr):
        return False
    return node_attr.shape[0] % NB == 0


def _mgn_layer_fused(layer: MGNLayer, cfg: MGNLayerConfig,
                     node_attr: torch.Tensor, edge_attr: torch.Tensor,
                     senders: torch.Tensor, receivers: torch.Tensor,
                     edge_mask: torch.Tensor, sender_perm, senders_sorted):
    """Fused path (only reached when uses_fused_layer: the streams are
    block-aligned): the node projections and the sender gather are plain
    ops (the gather's backward is K5); the whole edge chain, the receiver
    gather and the aggregation run in K1 / K2; the node update in K3 /
    K4. When _mega_layer_ok holds, the edge and node updates run as one
    kernel each way (K9, JAX nn/blocks.py:312-323)."""
    p = layer.edge
    h = node_attr.shape[1]
    s_proj = node_attr @ p.w_s
    d_proj = node_attr @ p.w_d + p.b
    sg = ops.gather_senders(s_proj, senders, sender_perm, senders_sorted,
                            aligned=True)
    hidden = p.stack[:-1]
    ws = (torch.stack([s.w for s in hidden]) if len(hidden)
          else torch.zeros((0, h, h), dtype=s_proj.dtype,
                           device=s_proj.device))
    bs = (torch.stack([s.b for s in hidden]) if len(hidden)
          else torch.zeros((0, h), dtype=s_proj.dtype, device=s_proj.device))
    if _mega_layer_ok(layer, cfg, node_attr):
        ep = {"w_e": p.w_e, "ws": ws, "bs": bs, "w_out": p.stack[-1].w,
              "b_out": p.stack[-1].b, "ln_scale": p.ln.scale,
              "ln_bias": p.ln.bias}
        npar = _pack_node_split(layer.node, h, node_attr.dtype,
                                node_attr.device)
        return fused_mgn_layer_autograd(edge_attr, sg, d_proj, node_attr,
                                        edge_mask, receivers, ep, npar,
                                        node_attr.shape[0])
    edge_attr, agg = fused_edge_layer_autograd(
        edge_attr, sg, d_proj, edge_mask, receivers,
        p.w_e, ws, bs, p.stack[-1].w, p.stack[-1].b,
        p.ln.scale, p.ln.bias, node_attr.shape[0], cfg.edge_sum_activation)
    if cfg.aggregation == "mean":
        deg = ops.degree(receivers, node_attr.shape[0], mask=edge_mask,
                         dtype=agg.dtype)
        agg = agg / torch.clamp(deg, min=1.0)[:, None]
    node_attr = node_block_post_residual(layer.node, cfg, node_attr, agg)
    return node_attr, edge_attr


def mgn_layer_apply(layer: MGNLayer, cfg: MGNLayerConfig,
                    node_attr: torch.Tensor, edge_attr: torch.Tensor,
                    senders: torch.Tensor, receivers: torch.Tensor,
                    edge_mask: Optional[torch.Tensor] = None,
                    sender_perm: Optional[torch.Tensor] = None,
                    senders_sorted: Optional[torch.Tensor] = None,
                    aligned: bool = False):
    """One processor step; returns (node_attr', edge_attr'). ``aligned``
    declares the edge streams block-aligned (build_graph_batch
    align_edges=True); it gates the fused kernels. ``sender_perm`` /
    ``senders_sorted`` (GraphBatch) give the sender gather its sorted
    segment-sum backward."""
    if uses_fused_layer(cfg, node_attr, receivers, edge_mask, aligned):
        return _mgn_layer_fused(layer, cfg, node_attr, edge_attr, senders,
                                receivers, edge_mask, sender_perm,
                                senders_sorted)
    if cfg.do_concat_trick:
        delta_e = edge_block_sum_apply(layer.edge, cfg, edge_attr, node_attr,
                                       senders, receivers, sender_perm,
                                       senders_sorted, aligned)
    else:
        delta_e = edge_block_apply(layer.edge, cfg, edge_attr, node_attr,
                                   senders, receivers, sender_perm,
                                   senders_sorted, aligned)
    edge_attr = edge_attr + delta_e
    delta_n = node_block_apply(layer.node, cfg, node_attr, edge_attr,
                               receivers, edge_mask, aligned)
    return node_attr + delta_n, edge_attr
