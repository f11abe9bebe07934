"""MeshGraphNet: encode -> process (L residual MP layers) -> decode
(counterpart of aero_gnn_tpu.models.mgn).

``MGNConfig`` keeps the JAX package's fields and defaults. ``init`` builds a
``MeshGraphNet`` module from an explicit ``torch.Generator``; ``apply`` runs
the forward pass, which is all this slice of the port provides: it runs
under ``torch.no_grad()``. The processor is a Python loop over the layers.

compute_dtype policy (as in the JAX package): fp32 master parameters are
cast to the compute dtype for the forward pass (``cast_params``), the node /
edge inputs and the edge mask are cast too, LayerNorm statistics stay fp32
and the output is fp32.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.graph.padded import GraphBatch
from aero_gnn_tpu_torch.nn import blocks as B
from aero_gnn_tpu_torch.nn import mlp as M

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    input_node_dim: int
    input_edge_dim: int
    output_node_dim: int
    processor_size: int = 15
    activation: str = "relu"
    num_hidden_layers_node_processor: int = 1
    num_hidden_layers_edge_processor: int = 1
    hidden_dim_processor: int = 128
    num_hidden_layers_node_encoder: int = 1
    hidden_dim_node_encoder: int = 128
    num_hidden_layers_edge_encoder: int = 1
    hidden_dim_edge_encoder: int = 128
    aggregation: str = "add"
    hidden_dim_decoder: int = 128
    num_hidden_layers_decoder: int = 1
    # training-only (the JAX package applies it only when given an rng);
    # no effect on this forward-only port
    dropout: float = 0.0
    do_concat_trick: bool = False
    # remat / remat_policy / remat_group / remat_offload / remat_group_policy
    # / unroll are the JAX package's memory and compile knobs for the
    # backward pass; they are accepted and have no effect on this
    # forward-only port.
    remat: bool = True
    remat_policy: str = "save_fused"
    remat_group: int = 0
    remat_offload: bool = False
    remat_group_policy: str = "full"
    compute_dtype: str = "float32"
    unroll: bool = False
    # one decoder MLP per output field, outputs concatenated field-wise
    separate_decoders: bool = False

    @property
    def layer_cfg(self) -> B.MGNLayerConfig:
        return B.MGNLayerConfig(
            node_dim=self.hidden_dim_processor,
            edge_dim=self.hidden_dim_processor,
            hidden_dim=self.hidden_dim_processor,
            num_hidden_layers_node=self.num_hidden_layers_node_processor,
            num_hidden_layers_edge=self.num_hidden_layers_edge_processor,
            activation=self.activation,
            use_layer_norm=True,
            aggregation=self.aggregation,
            do_concat_trick=self.do_concat_trick,
        )

    def init(self, generator: Union[torch.Generator, int, None] = None, *,
             device: DeviceLike = None) -> "MeshGraphNet":
        """Random parameters (torch.nn.Linear-style init) drawn on the CPU
        from ``generator`` (a CPU torch.Generator or an int seed), then
        moved to ``device`` (CUDA unless ``"cpu"``)."""
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            seed = 0 if generator is None else int(generator)
            generator = torch.Generator().manual_seed(seed)
        return MeshGraphNet(self, generator).to(dev)

    def apply(self, params: "MeshGraphNet",
              graph: GraphBatch) -> torch.Tensor:
        """Forward pass -> fp32 [N_pad, output_node_dim]."""
        if params.device != graph.device:
            raise ValueError(f"params are on {params.device}, the graph on "
                             f"{graph.device}")
        cd = self.compute_dtype
        with torch.no_grad():
            params = cast_params(params, cd)
            x = M.mlp_apply(params.node_encoder, _cast(graph.x, cd),
                            activation=self.activation)
            e = M.mlp_apply(params.edge_encoder, _cast(graph.edge_attr, cd),
                            activation=self.activation)
            x, e = run_processor(params.layers, self.layer_cfg, x, e,
                                 graph.senders, graph.receivers,
                                 _cast(graph.edge_mask, cd),
                                 aligned=graph.edges_aligned)
            if self.separate_decoders:
                out = torch.cat([M.mlp_apply(d, x, activation=self.activation)
                                 for d in params.decoder], dim=-1)
            else:
                out = M.mlp_apply(params.decoder, x,
                                  activation=self.activation)
            return out.float()


class MeshGraphNet(nn.Module):
    """Parameters of an MGNConfig: node/edge encoders, ``layers`` (one
    MGNLayer per processor step) and the decoder (a ModuleList of
    per-field MLPs with ``separate_decoders``)."""

    def __init__(self, cfg: MGNConfig, generator: torch.Generator):
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
        self.layers = nn.ModuleList(
            B.MGNLayer(cfg.layer_cfg, generator)
            for _ in range(cfg.processor_size))

        def decoder(out_dim):
            return M.MLP(hp, cfg.hidden_dim_decoder, out_dim,
                         num_hidden_layers=cfg.num_hidden_layers_decoder,
                         use_layer_norm=False, generator=generator)

        self.decoder = (nn.ModuleList(decoder(1)
                                      for _ in range(cfg.output_node_dim))
                        if cfg.separate_decoders
                        else decoder(cfg.output_node_dim))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def run_processor(layers: nn.ModuleList, layer_cfg: B.MGNLayerConfig,
                  x: torch.Tensor, e: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor, edge_mask: torch.Tensor, *,
                  aligned: bool = False):
    """The residual MP layers in order; returns (x, e)."""
    for layer in layers:
        x, e = B.mgn_layer_apply(layer, layer_cfg, x, e, senders, receivers,
                                 edge_mask, aligned)
    return x, e


def _cast(a: Optional[torch.Tensor], dtype: str) -> Optional[torch.Tensor]:
    if dtype == "float32" or a is None:
        return a
    return a.to(_DTYPES[dtype])


def cast_params(params: nn.Module, dtype: str) -> nn.Module:
    """fp32 master parameters cast to the compute dtype, as a copy (the
    module itself when nothing needs casting)."""
    if dtype not in _DTYPES:
        raise ValueError(f"Unsupported compute_dtype: {dtype}")
    dt = _DTYPES[dtype]
    if all(p.dtype == dt for p in params.parameters()
           if p.is_floating_point()):
        return params
    return copy.deepcopy(params).to(dt)
