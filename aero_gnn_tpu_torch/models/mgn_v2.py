"""MeshGraphNet_v2 ("trial1"), a simplified MGN with global context
(counterpart of aero_gnn_tpu.models.mgn_v2).

Differences from the MGN:
  * its own MLP convention (``build_mlp``): Linear + ReLU, then (Linear +
    ReLU + dropout) per hidden layer, a final Linear and an optional
    LayerNorm; the activation follows the FIRST linear too, and the
    decoder has ``num_decoder_layers - 1`` hidden layers;
  * the edge MLP sees only the edge features (no node gather);
  * the node update aggregates with the masked mean: on an aligned graph
    on the cuda backend kernel K5 twice per layer (the sum and the
    degree), the pad sink declared;
  * a global context (an MLP without LayerNorm, one more Linear, the mean
    over each graph's real nodes) concatenated onto the raw node features.

Dtypes: the JAX package's MGNv2 never casts to ``compute_dtype`` (it has
none), so it computes in float32; ``params_dtype`` is float32 and the
parameters are cast up to it (a cast autograd sees) if they are not.
There is no remat: the JAX package's MGNv2 scans its layers without
checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from aero_gnn_tpu_torch import ops
from aero_gnn_tpu_torch.device import DeviceLike
from aero_gnn_tpu_torch.graph.padded import GraphBatch
from aero_gnn_tpu_torch.models.mgn import (
    ModelParams,
    cast_params,
    check_apply,
    init_params,
)
from aero_gnn_tpu_torch.nn import mlp as M


class BuildMLP(nn.Module):
    """``build_mlp``'s parameters: ``linears`` [(in, h)] + [(h, h)] *
    num_hidden + [(h, out)] (two linears even without a hidden layer) and
    an optional final ``ln``; the attributes of ``nn.mlp.MLP``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_hidden_layers: int, lay_norm: bool,
                 generator: torch.Generator):
        super().__init__()
        dims = [(input_dim, hidden_dim)]
        dims += [(hidden_dim, hidden_dim)] * num_hidden_layers
        dims += [(hidden_dim, output_dim)]
        self.linears = nn.ModuleList(
            M.Linear(fi, fo, generator=generator) for fi, fo in dims)
        self.ln = M.LayerNorm(output_dim) if lay_norm else None


def build_mlp_apply(mlp: BuildMLP, x: torch.Tensor, *, dropout: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """First linear + ReLU (no dropout), hidden linears + ReLU + dropout
    (only with a ``generator`` and ``dropout > 0``), final linear, the
    optional LayerNorm."""
    x = torch.relu(mlp.linears[0](x))
    for lin in mlp.linears[1:-1]:
        x = torch.relu(lin(x))
        if dropout > 0.0 and generator is not None:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) >= dropout
            x = torch.where(keep, x / (1.0 - dropout), torch.zeros_like(x))
    x = mlp.linears[-1](x)
    if mlp.ln is not None:
        x = M.layer_norm_apply(mlp.ln, x)
    return x


@dataclasses.dataclass(frozen=True)
class MGNv2Config:
    node_input_size: int
    edge_input_size: int
    hidden_channels: int
    out_channels: int
    num_graph_conv_layers: int
    num_encoder_layers: int = 2
    num_decoder_layers: int = 2
    dropout: float = 0.0
    # the JAX package's scan / Python-unroll switch; no meaning in an eager
    # loop
    unroll: bool = False

    @property
    def params_dtype(self) -> torch.dtype:
        return torch.float32

    def init(self, generator: Union[torch.Generator, int, None] = None, *,
             device: DeviceLike = None) -> "MGNv2":
        """Random parameters drawn on the CPU from ``generator`` (a CPU
        torch.Generator or an int seed), moved to ``device`` (CUDA unless
        ``"cpu"``)."""
        return init_params(MGNv2, self, generator, device)

    def apply(self, params: "MGNv2", graph: GraphBatch, *,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward pass -> fp32 [N_pad, out_channels]. ``generator`` (on the
        graph's device) turns on the dropout of the encoders and the
        decoder."""
        check_apply(self, params, graph)
        casted = cast_params(params, "float32")
        if casted:
            return torch.func.functional_call(
                params, casted, (self._forward, graph, generator))
        return self._forward(params, graph, generator)

    def _forward(self, params: "MGNv2", graph: GraphBatch,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        x0 = graph.x.float()
        g = params.global_linout(build_mlp_apply(params.global_encoder, x0))
        pooled = ops.graph_pool(g, graph.node_graph, graph.num_graphs_pad,
                                method="mean", node_mask=graph.node_mask,
                                chunks=graph.graph_chunks)
        x = torch.cat([x0, ops.graph_broadcast(
            pooled, graph.node_graph, chunks=graph.graph_chunks)], dim=-1)
        drop = dict(dropout=self.dropout, generator=generator)
        x = build_mlp_apply(params.node_encoder, x, **drop)
        e = build_mlp_apply(params.edge_encoder, graph.edge_attr.float(),
                            **drop)
        for layer in params.layers:
            e = e + build_mlp_apply(layer.edge_mlp, e)
            agg = ops.aggregate_edges(
                e, graph.receivers, x.shape[0], aggregation="mean",
                edge_mask=graph.edge_mask, aligned=graph.edges_aligned,
                pad_sink=True)
            x = x + build_mlp_apply(layer.node_mlp,
                                    torch.cat([x, agg], dim=-1))
        return build_mlp_apply(params.decoder, x, **drop).float()


class MGNv2Layer(nn.Module):
    def __init__(self, h: int, generator: torch.Generator):
        super().__init__()
        self.edge_mlp = BuildMLP(h, h, h, 2, True, generator)
        self.node_mlp = BuildMLP(2 * h, h, h, 2, True, generator)


class MGNv2(ModelParams):
    """Parameters of an MGNv2Config: ``node_encoder``, ``edge_encoder``,
    ``global_encoder``, ``global_linout``, ``layers`` (one MGNv2Layer per
    message-passing step) and ``decoder``."""

    def __init__(self, cfg: MGNv2Config, generator: torch.Generator):
        super().__init__()
        h, ne = cfg.hidden_channels, cfg.num_encoder_layers
        self.node_encoder = BuildMLP(cfg.node_input_size + h, h, h, ne, True,
                                     generator)
        self.edge_encoder = BuildMLP(cfg.edge_input_size, h, h, ne, True,
                                     generator)
        self.global_encoder = BuildMLP(cfg.node_input_size, h, h, ne, False,
                                       generator)
        self.global_linout = M.Linear(h, h, generator=generator)
        self.layers = nn.ModuleList(MGNv2Layer(h, generator)
                                    for _ in range(cfg.num_graph_conv_layers))
        self.decoder = BuildMLP(h, h, cfg.out_channels,
                                cfg.num_decoder_layers - 1, False, generator)
