"""Pointwise MLP baseline, no message passing (counterpart of
aero_gnn_tpu.models.mlpnet): an encoder MLP then a decoder MLP over the
node features, both LayerNorm-terminated. It computes in float32, as the
JAX package's (which has no compute dtype), so ``params_dtype`` is float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from aero_gnn_tpu_torch.device import DeviceLike
from aero_gnn_tpu_torch.graph.padded import GraphBatch
from aero_gnn_tpu_torch.models.mgn import (
    ModelParams,
    cast_params,
    check_apply,
    init_params,
)
from aero_gnn_tpu_torch.nn import mlp as M


@dataclasses.dataclass(frozen=True)
class MLPNetConfig:
    input_node_dim: int
    output_node_dim: int
    hidden_dim: int = 128
    num_hidden_layers_encoder: int = 2
    num_hidden_layers_decoder: int = 2
    activation: str = "relu"
    dropout: float = 0.0

    @property
    def params_dtype(self) -> torch.dtype:
        return torch.float32

    def init(self, generator: Union[torch.Generator, int, None] = None, *,
             device: DeviceLike = None) -> "MLPNet":
        """Random parameters drawn on the CPU from ``generator`` (a CPU
        torch.Generator or an int seed), moved to ``device`` (CUDA unless
        ``"cpu"``)."""
        return init_params(MLPNet, self, generator, device)

    def apply(self, params: "MLPNet", graph: GraphBatch, *,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward pass -> fp32 [N_pad, output_node_dim]. ``generator`` (on
        the graph's device) turns on the dropout."""
        check_apply(self, params, graph)
        casted = cast_params(params, "float32")
        if casted:
            return torch.func.functional_call(
                params, casted, (self._forward, graph, generator))
        return self._forward(params, graph, generator)

    def _forward(self, params: "MLPNet", graph: GraphBatch,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        kw = dict(activation=self.activation, dropout=self.dropout,
                  generator=generator)
        h = M.mlp_apply(params.encoder, graph.x.float(), **kw)
        return M.mlp_apply(params.decoder, h, **kw).float()


class MLPNet(ModelParams):
    """Parameters of an MLPNetConfig: ``encoder`` and ``decoder``."""

    def __init__(self, cfg: MLPNetConfig, generator: torch.Generator):
        super().__init__()
        self.encoder = M.MLP(cfg.input_node_dim, cfg.hidden_dim,
                             cfg.hidden_dim,
                             num_hidden_layers=cfg.num_hidden_layers_encoder,
                             use_layer_norm=True, generator=generator)
        self.decoder = M.MLP(cfg.hidden_dim, cfg.hidden_dim,
                             cfg.output_node_dim,
                             num_hidden_layers=cfg.num_hidden_layers_decoder,
                             use_layer_norm=True, generator=generator)
