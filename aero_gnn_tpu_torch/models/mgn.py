"""MeshGraphNet: encode -> process (L residual MP layers) -> decode
(counterpart of aero_gnn_tpu.models.mgn).

``MGNConfig`` keeps the JAX package's fields and defaults. ``init`` builds a
``MeshGraphNet`` module from an explicit ``torch.Generator``; ``apply`` runs
the forward pass, differentiable with respect to the module's parameters.
The processor is a Python loop over the layers.

compute_dtype policy (as in the JAX package): fp32 master parameters are
cast to the compute dtype for the pass by ``cast_params``, a cast autograd
sees, so the weight gradients come back rounded to the compute dtype and
then cast up to fp32; the node / edge inputs and the edge mask are cast
too, LayerNorm statistics stay fp32 and the output is fp32. Parameters that
are already in the compute dtype (``AeroInference`` casts once, at
construction) are used as they are.

Rematerialisation (``remat``): the fused layer's autograd Functions already
save only the layer inputs plus sg / d_proj / agg, the set the JAX
"save_fused" policy keeps, so "save_fused" on the fused path checkpoints
nothing; "full", and any policy on the unfused path, recompute each layer
in the backward (``torch.utils.checkpoint``). The same holds on the
switched paths (``AERO_GNN_SAVE_ACTS``: the save variant's activations
zs / d / mu / inv in place of sg / d_proj; ``AERO_GNN_MEGA``: the inputs
and agg of the single-kernel layer): under "save_fused" their Functions
keep those residuals, where JAX, whose policy names only sg / d_proj /
agg, re-runs the forward kernel under ``jax.checkpoint``. The gradients
are the same; only memory and time differ. ``remat_group`` > 1 and
``remat_offload`` are not ported (ROADMAP queue 1); ``unroll`` has no
meaning in an eager loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
import torch.utils.checkpoint
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
    # encoder dropout, applied only when apply() is given a generator
    dropout: float = 0.0
    do_concat_trick: bool = False
    # memory knobs of the backward pass (module docstring); remat_group > 1
    # and remat_offload raise NotImplementedError, unroll and
    # remat_group_policy have no effect
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

    @property
    def params_dtype(self) -> torch.dtype:
        """The dtype AeroInference keeps the parameters in."""
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"Unsupported compute_dtype: {self.compute_dtype}")
        return _DTYPES[self.compute_dtype]

    def init(self, generator: Union[torch.Generator, int, None] = None, *,
             device: DeviceLike = None) -> "MeshGraphNet":
        """Random parameters (torch.nn.Linear-style init) drawn on the CPU
        from ``generator`` (a CPU torch.Generator or an int seed), then
        moved to ``device`` (CUDA unless ``"cpu"``)."""
        return init_params(MeshGraphNet, self, generator, device)

    def apply(self, params: "MeshGraphNet", graph: GraphBatch, *,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward pass -> fp32 [N_pad, output_node_dim]. ``generator`` (on
        the graph's device) turns on the encoders' dropout."""
        check_apply(self, params, graph)
        cd = self.compute_dtype
        casted = cast_params(params, cd)
        if casted:
            return torch.func.functional_call(params, casted,
                                              (self._forward, graph,
                                               generator))
        return self._forward(params, graph, generator)

    def _forward(self, params: "MeshGraphNet", graph: GraphBatch,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        cd = self.compute_dtype
        x = M.mlp_apply(params.node_encoder, _cast(graph.x, cd),
                        activation=self.activation, dropout=self.dropout,
                        generator=generator)
        e = M.mlp_apply(params.edge_encoder, _cast(graph.edge_attr, cd),
                        activation=self.activation, dropout=self.dropout,
                        generator=generator)
        x, e = run_processor(params.layers, self.layer_cfg, x, e,
                             graph.senders, graph.receivers,
                             _cast(graph.edge_mask, cd),
                             sender_perm=graph.sender_perm,
                             senders_sorted=graph.senders_sorted,
                             aligned=graph.edges_aligned, remat=self.remat,
                             remat_policy=self.remat_policy)
        if self.separate_decoders:
            out = torch.cat([M.mlp_apply(d, x, activation=self.activation)
                             for d in params.decoder], dim=-1)
        else:
            out = M.mlp_apply(params.decoder, x, activation=self.activation)
        return out.float()


class ModelParams(nn.Module):
    """Base of the models' parameter modules: their device, and a forward
    that lets torch.func.functional_call run a function of the module with
    substituted parameters."""

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, fn, *args):
        """``fn(self, *args)``."""
        return fn(self, *args)


def init_params(module_cls, cfg, generator: Union[torch.Generator, int, None],
                device: DeviceLike) -> nn.Module:
    """``module_cls(cfg, generator)`` drawn on the CPU from ``generator`` (a
    CPU torch.Generator or an int seed, 0 by default), moved to ``device``
    (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        seed = 0 if generator is None else int(generator)
        generator = torch.Generator().manual_seed(seed)
    return module_cls(cfg, generator).to(dev)


def mgn_base(cfg: MGNConfig, input_node_dim: int) -> MGNConfig:
    """The plain MGNConfig of ``cfg`` (an MGNConfig subclass) over a node
    input of ``input_node_dim`` columns."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(MGNConfig)}
    fields["input_node_dim"] = input_node_dim
    return MGNConfig(**fields)


def check_apply(cfg, params: nn.Module, graph: GraphBatch) -> None:
    """The checks every model's apply makes: parameters on the graph's
    device and, for the configs with remat (the MGN family), no remat
    variant that is not ported."""
    if params.device != graph.device:
        raise ValueError(f"params are on {params.device}, the graph on "
                         f"{graph.device}")
    if getattr(cfg, "remat", False) and (cfg.remat_group > 1
                                         or cfg.remat_offload):
        raise NotImplementedError(
            "remat_group > 1 and remat_offload (grouped / host-offloaded "
            "remat) are not ported yet (ROADMAP queue 1)")


class MeshGraphNet(ModelParams):
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


def apply_model(model_cfg, params, graph: GraphBatch, hierarchy,
                needs_hierarchy: bool, device: torch.device, **kw):
    """``model_cfg.apply`` (any config of ``models.registry``) with the
    graph (and the hierarchy) moved to ``device``; ``needs_hierarchy``
    models (BSMS) require the hierarchy. The entry point of the engine and
    the steps."""
    if graph.device != device:
        graph = graph.to(device)
    if not needs_hierarchy:
        return model_cfg.apply(params, graph, **kw)
    if hierarchy is None:
        raise ValueError("this model needs a graph hierarchy: pass the "
                         "Loader's aux (num_scales > 1)")
    hierarchy = tuple(lv if lv.device == device else lv.to(device)
                      for lv in hierarchy)
    return model_cfg.apply(params, graph, hierarchy=hierarchy, **kw)


def run_processor(layers: nn.ModuleList, layer_cfg: B.MGNLayerConfig,
                  x: torch.Tensor, e: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor, edge_mask: torch.Tensor, *,
                  sender_perm: Optional[torch.Tensor] = None,
                  senders_sorted: Optional[torch.Tensor] = None,
                  aligned: bool = False, remat: bool = False,
                  remat_policy: str = "save_fused"):
    """The residual MP layers in order; returns (x, e). With ``remat`` (and
    grad mode on) each layer is recomputed in the backward unless the
    policy is "save_fused" on the fused path (module docstring)."""
    fused = B.uses_fused_layer(layer_cfg, x, receivers, edge_mask, aligned)
    recompute = (remat and torch.is_grad_enabled()
                 and (remat_policy != "save_fused" or not fused))
    graph_args = (senders, receivers, edge_mask, sender_perm, senders_sorted,
                  aligned)
    for layer in layers:
        if not recompute:
            x, e = B.mgn_layer_apply(layer, layer_cfg, x, e, *graph_args)
            continue
        # the layer's (possibly cast) parameters enter the checkpoint as
        # inputs, so the recompute sees the same tensors as the forward
        names, tensors = zip(*layer.named_parameters())
        x, e = torch.utils.checkpoint.checkpoint(
            _layer_with, layer, layer_cfg, names, graph_args, x, e, *tensors,
            use_reentrant=False)
    return x, e


def _layer_with(layer: B.MGNLayer, layer_cfg: B.MGNLayerConfig, names,
                graph_args, x, e, *tensors):
    """mgn_layer_apply of ``layer`` with its parameters set to ``tensors``."""
    return torch.func.functional_call(
        layer, dict(zip(names, tensors)),
        (B.mgn_layer_apply, layer_cfg, x, e, *graph_args))


def _cast(a: Optional[torch.Tensor], dtype: str) -> Optional[torch.Tensor]:
    if dtype == "float32" or a is None:
        return a
    return a.to(_DTYPES[dtype])


def cast_params(params: nn.Module, dtype: str) -> Dict[str, torch.Tensor]:
    """{name: parameter cast to the compute dtype} for every floating
    parameter not already in it (empty when there is none), as one
    concatenate-cast-split so the backward is one cast too. Autograd sees
    the cast: the gradient of each fp32 master is its compute-dtype
    gradient cast up."""
    if dtype not in _DTYPES:
        raise ValueError(f"Unsupported compute_dtype: {dtype}")
    dt = _DTYPES[dtype]
    named = [(n, p) for n, p in params.named_parameters()
             if p.is_floating_point() and p.dtype != dt]
    if not named:
        return {}
    flat = torch.cat([p.reshape(-1) for _, p in named]).to(dt)
    parts = torch.split(flat, [p.numel() for _, p in named])
    return {n: v.view(p.shape) for (n, p), v in zip(named, parts)}
