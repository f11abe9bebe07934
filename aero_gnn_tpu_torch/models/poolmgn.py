"""poolMGN: MeshGraphNet with one-shot global context (counterpart of
aero_gnn_tpu.models.poolmgn).

A global encoder MLP (no LayerNorm) runs over the raw node features, is
pooled per graph (mean | max | add over the real nodes, ``ops.graph_pool``),
broadcast back to every node (``ops.graph_broadcast``) and concatenated onto
the node-encoder input (``input_node_dim + global_dim``). The rest is the
MeshGraphNet's encoders, processor (the unfused layer unless
``do_concat_trick``) and decoder.

Dtypes: the JAX package's poolMGN never casts its parameters or inputs to
``compute_dtype`` (its apply calls the layers directly), so it computes in
float32 whatever ``compute_dtype`` says; the port does the same, as its
BSMS does: the parameters are cast up to float32 (a cast autograd sees)
and ``params_dtype`` is float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from aero_gnn_tpu_torch import ops
from aero_gnn_tpu_torch.device import DeviceLike
from aero_gnn_tpu_torch.graph.padded import GraphBatch
from aero_gnn_tpu_torch.models.mgn import (
    MeshGraphNet,
    MGNConfig,
    cast_params,
    check_apply,
    init_params,
    mgn_base,
    run_processor,
)
from aero_gnn_tpu_torch.nn import mlp as M


@dataclasses.dataclass(frozen=True)
class PoolMGNConfig(MGNConfig):
    global_pool_method: str = "mean"
    num_hidden_layers_global_encoder: int = 1
    global_dim: int = 128

    @property
    def base(self) -> MGNConfig:
        """The MeshGraphNet over the node input plus the global context."""
        return mgn_base(self, self.input_node_dim + self.global_dim)

    @property
    def params_dtype(self) -> torch.dtype:
        """float32 whatever compute_dtype says (module docstring)."""
        return torch.float32

    def init(self, generator: Union[torch.Generator, int, None] = None, *,
             device: DeviceLike = None) -> "PoolMGN":
        """Random parameters drawn on the CPU from ``generator`` (a CPU
        torch.Generator or an int seed), moved to ``device`` (CUDA unless
        ``"cpu"``)."""
        return init_params(PoolMGN, self, generator, device)

    def apply(self, params: "PoolMGN", graph: GraphBatch, *,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward pass -> fp32 [N_pad, output_node_dim]. ``generator`` (on
        the graph's device) turns on the encoders' dropout."""
        check_apply(self, params, graph)
        casted = cast_params(params, "float32")
        if casted:
            return torch.func.functional_call(
                params, casted, (self._forward, graph, generator))
        return self._forward(params, graph, generator)

    def _forward(self, params: "PoolMGN", graph: GraphBatch,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        x = graph.x.float()
        drop = dict(activation=self.activation, dropout=self.dropout,
                    generator=generator)
        g = M.mlp_apply(params.global_encoder, x, **drop)
        pooled = ops.graph_pool(g, graph.node_graph, graph.num_graphs_pad,
                                method=self.global_pool_method,
                                node_mask=graph.node_mask,
                                chunks=graph.graph_chunks)
        x_in = torch.cat([x, ops.graph_broadcast(
            pooled, graph.node_graph, chunks=graph.graph_chunks)], dim=-1)
        x = M.mlp_apply(params.node_encoder, x_in, **drop)
        e = M.mlp_apply(params.edge_encoder, graph.edge_attr.float(), **drop)
        x, e = run_processor(params.layers, self.layer_cfg, x, e,
                             graph.senders, graph.receivers, graph.edge_mask,
                             sender_perm=graph.sender_perm,
                             senders_sorted=graph.senders_sorted,
                             aligned=graph.edges_aligned, remat=self.remat,
                             remat_policy=self.remat_policy)
        return M.mlp_apply(params.decoder, x,
                           activation=self.activation).float()


class PoolMGN(MeshGraphNet):
    """Parameters of a PoolMGNConfig: the MeshGraphNet of its ``base`` plus
    ``global_encoder``."""

    def __init__(self, cfg: PoolMGNConfig, generator: torch.Generator):
        super().__init__(cfg.base, generator)
        self.global_encoder = M.MLP(
            cfg.input_node_dim, cfg.global_dim, cfg.global_dim,
            num_hidden_layers=cfg.num_hidden_layers_global_encoder,
            use_layer_norm=False, generator=generator)
