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

Rematerialisation (``remat``, ``checkpointed_layer_stack``): the fused
layer's autograd Functions already save only the layer inputs plus sg /
d_proj / agg, the set the JAX "save_fused" policy keeps, so "save_fused" on
the fused path checkpoints nothing; "full", and any policy on the unfused
path, recompute each layer in the backward (``torch.utils.checkpoint``,
non-reentrant). The same holds on the switched paths
(``AERO_GNN_SAVE_ACTS``: the save variant's activations zs / d / mu / inv
in place of sg / d_proj; ``AERO_GNN_MEGA``: the inputs and agg of the
single-kernel layer): under "save_fused" their Functions keep those
residuals, where JAX, whose policy names only sg / d_proj / agg, re-runs the
forward kernel under ``jax.checkpoint``. The gradients are the same; only
memory and time differ.

Grouped remat (``remat_group`` > 1, the large-mesh path): an outer
checkpoint per group of ``remat_group`` layers keeps only the group's input
(x, e); inside it the per-layer policy ``remat_group_policy`` ("full",
"save_fused", or "save_fused:N": save_fused in the first N groups, full in
the rest), and the node and edge encoders are checkpointed too, their
dropout replayed from the generator's state. ``remat_offload`` keeps each
group's input in pinned host memory from the forward until that group's
backward. ``unroll`` has no meaning in an eager loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

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
    # memory knobs of the backward pass (module docstring,
    # checkpointed_layer_stack). remat: recompute in the backward;
    # remat_policy: per layer, "save_fused" (the fused Functions' own
    # residuals, no checkpoint) or "full" (a checkpoint per layer)
    remat: bool = True
    remat_policy: str = "save_fused"
    # > 1: checkpoint groups of this many layers (it must divide
    # processor_size), keeping only each group's input (x, e); 0 = off
    remat_group: int = 0
    # keep the group inputs in pinned host memory (needs remat_group > 1)
    remat_offload: bool = False
    # the per-layer policy inside a group: "full", "save_fused" or
    # "save_fused:N" (save_fused in the first N groups, full in the rest)
    remat_group_policy: str = "full"
    compute_dtype: str = "float32"
    # no effect: an eager loop has nothing to unroll
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
        # near the memory limit the encoders' [E, h] activations are GBs
        # too: grouped remat recomputes them (JAX mgn.py:160-165)
        grouped = (self.remat and self.remat_group > 1
                   and torch.is_grad_enabled())
        x = _encode(params, "node_encoder", _cast(graph.x, cd), self,
                    generator, grouped)
        e = _encode(params, "edge_encoder", _cast(graph.edge_attr, cd),
                    self, generator, grouped)
        x, e = run_processor(params.layers, self.layer_cfg, x, e,
                             graph.senders, graph.receivers,
                             _cast(graph.edge_mask, cd),
                             sender_perm=graph.sender_perm,
                             senders_sorted=graph.senders_sorted,
                             aligned=graph.edges_aligned, remat=self.remat,
                             remat_policy=self.remat_policy,
                             remat_group=self.remat_group,
                             remat_offload=self.remat_offload,
                             remat_group_policy=self.remat_group_policy)
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
    """The check every model's apply makes: parameters on the graph's
    device."""
    if params.device != graph.device:
        raise ValueError(f"params are on {params.device}, the graph on "
                         f"{graph.device}")


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
                  remat_policy: str = "save_fused", remat_group: int = 0,
                  remat_offload: bool = False,
                  remat_group_policy: str = "full"):
    """The residual MP layers in order; returns (x, e). The remat knobs as
    in checkpointed_layer_stack."""
    graph_args = (senders, receivers, edge_mask, sender_perm, senders_sorted,
                  aligned)

    def body(carry, layer):
        return B.mgn_layer_apply(layer, layer_cfg, *carry, *graph_args)

    return checkpointed_layer_stack(
        body, (x, e), layers, remat=remat, remat_policy=remat_policy,
        remat_group=remat_group, remat_offload=remat_offload,
        remat_group_policy=remat_group_policy,
        fused=B.uses_fused_layer(layer_cfg, x, receivers, edge_mask,
                                 aligned))


def checkpointed_layer_stack(body, carry: Tuple[torch.Tensor, ...], layers,
                             *, remat: bool = True,
                             remat_policy: str = "save_fused",
                             remat_group: int = 0,
                             remat_offload: bool = False,
                             remat_group_policy: str = "full",
                             fused: bool = False):
    """``carry = body(carry, layer)`` for each layer of ``layers`` (modules
    whose ``forward(fn, *args)`` is ``fn(self, *args)``, as MGNLayer's),
    under the checkpoint scheme of the remat knobs (JAX mgn.py:194-364);
    ``carry`` is a tuple of tensors. ``fused`` says that body's autograd
    Functions keep just the residuals JAX's "save_fused" policy names (sg /
    d_proj / agg), so that policy needs no checkpoint of its own.

    * per layer (``remat_group`` <= 1): a checkpoint per layer, unless the
      policy is "save_fused" and ``fused``;
    * grouped (``remat_group`` > 1): an outer checkpoint per group of
      ``remat_group`` layers keeps only the group's input carry; inside it
      each layer is checkpointed under ``remat_group_policy`` "full", and
      as per-layer "save_fused" under "save_fused"; "save_fused:N" applies
      save_fused to the first N groups and full to the rest;
    * ``remat_offload`` (grouped only): each group's input carry is kept in
      pinned host memory from the forward until that group's backward,
      whose recompute copies it back to the card. As in JAX's offload
      branch (mgn.py:236-242), the inner policy is then save_fused under
      "save_fused" only; "save_fused:N" runs full in every group.

    Every checkpoint takes the layers' parameters as inputs, so the
    recompute sees the tensors of the forward (the compute-dtype casts).
    Nothing is checkpointed with grad mode off. ValueError when
    ``remat_offload`` is set without ``remat_group`` > 1 or when
    ``remat_group`` does not divide the layer count."""
    layers = list(layers)
    if remat and remat_offload and remat_group <= 1:
        raise ValueError("remat_offload requires remat_group > 1 (the "
                         "offload streams GROUP boundaries to host)")
    if remat and remat_group > 1 and len(layers) % remat_group:
        raise ValueError(f"remat_group={remat_group} must divide the layer "
                         f"count {len(layers)}")
    if not (remat and torch.is_grad_enabled()):
        for layer in layers:
            carry = body(carry, layer)
        return carry
    if remat_group <= 1:
        recompute = remat_policy != "save_fused" or not fused
        for layer in layers:
            carry = (_checkpointed_layer(body, carry, layer,
                                         *_params_of(layer))
                     if recompute else body(carry, layer))
        return carry
    n_sf = _save_fused_groups(remat_group_policy, len(layers) // remat_group,
                              remat_offload)
    for g, start in enumerate(range(0, len(layers), remat_group)):
        carry = _checkpointed_group(body, carry,
                                    layers[start:start + remat_group],
                                    recompute=g >= n_sf or not fused,
                                    offload=remat_offload)
    return carry


def _save_fused_groups(policy: str, groups: int, offload: bool) -> int:
    """How many leading groups take the save_fused inner policy."""
    if policy == "save_fused":
        return groups
    if policy.startswith("save_fused:") and not offload:
        return int(policy.split(":", 1)[1])
    return 0


def _params_of(module: nn.Module):
    """(names, tensors) of ``module``'s parameters as it holds them now."""
    pairs = tuple(module.named_parameters())
    return tuple(n for n, _ in pairs), tuple(t for _, t in pairs)


def _call_with(module: nn.Module, names, tensors, fn, *args):
    """``fn(module, *args)`` with ``module``'s parameters ``names`` set to
    ``tensors`` (its forward must be ``fn(self, *args)``)."""
    return torch.func.functional_call(module, dict(zip(names, tensors)),
                                      (fn, *args))


def _layer_body(layer: nn.Module, body, carry):
    return body(carry, layer)


def _checkpointed_layer(body, carry, layer, names, tensors):
    n = len(carry)

    def run(*flat):
        return _call_with(layer, names, flat[n:], _layer_body, body,
                          tuple(flat[:n]))

    return torch.utils.checkpoint.checkpoint(run, *carry, *tensors,
                                             use_reentrant=False)


def _checkpointed_group(body, carry, group, *, recompute: bool,
                        offload: bool):
    """One group under its outer checkpoint, each layer under the inner
    policy (``recompute``: a checkpoint per layer). With ``offload`` the
    checkpoint's saved input is a pinned host copy of the carry: the
    forward runs on the device carry it was copied from (so the gradient
    stays on the card), the recompute on the host copy moved back."""
    params = [_params_of(layer) for layer in group]
    flat_params = [t for _, ts in params for t in ts]
    n = len(carry)

    def run(*flat):
        c, rest = tuple(flat[:n]), flat[n:]
        for layer, (names, ts) in zip(group, params):
            ts, rest = rest[:len(ts)], rest[len(ts):]
            c = (_checkpointed_layer(body, c, layer, names, ts) if recompute
                 else _call_with(layer, names, ts, _layer_body, body, c))
        return c

    if not offload:
        return torch.utils.checkpoint.checkpoint(run, *carry, *flat_params,
                                                 use_reentrant=False)
    device = carry[0].device
    needs_grad = [t.requires_grad for t in carry]
    forward_carry = [carry]  # handed to the first call only

    def run_from_host(*flat):
        if forward_carry:
            c = forward_carry.pop()
        else:
            c = tuple(t.to(device, non_blocking=True).detach()
                      .requires_grad_(r)
                      for t, r in zip(flat[:n], needs_grad))
        return run(*c, *flat[n:])

    host = tuple(_to_host(t.detach()) for t in carry)
    return torch.utils.checkpoint.checkpoint(run_from_host, *host,
                                             *flat_params,
                                             use_reentrant=False)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor, copied on the current stream
    (a CPU tensor is already in host memory)."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _encode(params: nn.Module, name: str, a: torch.Tensor, cfg,
            generator: Optional[torch.Generator],
            checkpointed: bool) -> torch.Tensor:
    """The encoder MLP ``params.<name>`` on ``a``; ``checkpointed``
    recomputes it in the backward, its dropout masks drawn again from the
    generator's state before the forward (torch.utils.checkpoint restores
    only the global RNG)."""

    def run(root, a):
        return M.mlp_apply(getattr(root, name), a, activation=cfg.activation,
                           dropout=cfg.dropout, generator=generator)

    if not checkpointed:
        return run(params, a)
    names, tensors = _params_of(getattr(params, name))
    names = tuple(f"{name}.{n}" for n in names)
    replay = _replaying(run, generator)

    def fn(a, *ts):
        return _call_with(params, names, ts, replay, a)

    return torch.utils.checkpoint.checkpoint(fn, a, *tensors,
                                             use_reentrant=False)


def _replaying(fn, generator: Optional[torch.Generator]):
    """``fn`` whose calls after the first draw from ``generator`` what the
    first drew, and leave it where they found it."""
    if generator is None:
        return fn
    start = generator.get_state()
    calls = []

    def run(*args):
        if not calls:
            calls.append(1)
            return fn(*args)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*args)
        finally:
            generator.set_state(now)

    return run


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
