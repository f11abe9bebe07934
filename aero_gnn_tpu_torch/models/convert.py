"""Carry the model zoo's parameters between the JAX package's tree and the
port (``params_from_jax``, the inverse of aero_gnn_tpu/utils/torch_import.py,
and ``params_to_jax``).

The JAX tree, as numpy arrays, has the layout of ``MGNConfig.init`` there:
``{"node_encoder", "edge_encoder": {"linears": [{"w", "b"}], "ln"},
"layers": {"edge": ..., "node": ...} with every leaf stacked on a leading
layer axis, "decoder": MLP tree or a list of them}``. FourierMGN's is the
MGN tree over the expanded input; poolMGN's adds ``"global_encoder"``;
``BSMSConfig.init``'s has ``"down": [stacked layers per stage],
"bottleneck": stacked layers, "up": [stacked layers per stage]`` in place
of ``"layers"``; MGNv2's is ``{"node_encoder", "edge_encoder",
"global_encoder", "global_linout": {"w", "b"}, "layers": {"edge_mlp",
"node_mlp"} stacked, "decoder"}``; MLPNet's ``{"encoder", "decoder"}``.
Transolver, which the JAX package lacks, is kept as ``{parameter name:
array}`` in the port's names.
Weights are [in, out] in both packages, so each leaf is an exact copy.
"""

from __future__ import annotations

import numpy as np
import torch

from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.models.bsms import BSMSConfig
from aero_gnn_tpu_torch.models.mgn_v2 import MGNv2Config
from aero_gnn_tpu_torch.models.mlpnet import MLPNetConfig
from aero_gnn_tpu_torch.models.poolmgn import PoolMGNConfig
from aero_gnn_tpu_torch.models.transolver import TransolverConfig
from aero_gnn_tpu_torch.nn import blocks as B
from aero_gnn_tpu_torch.nn import mlp as M


def _put(param: torch.nn.Parameter, arr, name: str) -> None:
    a = torch.from_numpy(np.array(arr, dtype=np.float32))
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"{name}: JAX shape {tuple(a.shape)} != port shape "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(a.to(param.dtype))


def _put_ln(ln, tree, name: str) -> None:
    if (tree is None) != (ln is None):
        raise ValueError(f"{name}: LayerNorm present in only one package")
    if ln is not None:
        _put(ln.scale, tree["scale"], f"{name}.scale")
        _put(ln.bias, tree["bias"], f"{name}.bias")


def load_mlp(mlp: M.MLP, tree, name: str = "mlp") -> None:
    """Copy a JAX MLP tree ({"linears": [{"w", "b"}], "ln"}) into ``mlp``."""
    if len(tree["linears"]) != len(mlp.linears):
        raise ValueError(f"{name}: {len(tree['linears'])} linears in JAX, "
                         f"{len(mlp.linears)} in the port")
    for i, (lin, t) in enumerate(zip(mlp.linears, tree["linears"])):
        _put(lin.w, t["w"], f"{name}.linears[{i}].w")
        _put(lin.b, t["b"], f"{name}.linears[{i}].b")
    _put_ln(mlp.ln, tree["ln"], f"{name}.ln")


def _layer(tree, i: int):
    """Slice layer ``i`` out of a tree stacked on the leading axis."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layer(v, i) for v in tree]
    return np.asarray(tree)[i]


def _load_layer(layer: B.MGNLayer, t, name: str) -> None:
    if isinstance(layer.edge, B.EdgeBlockSum):
        p, te = layer.edge, t["edge"]
        for k in ("w_e", "w_s", "w_d", "b"):
            _put(getattr(p, k), te[k], f"{name}.edge.{k}")
        if len(te["stack"]) != len(p.stack):
            raise ValueError(f"{name}.edge.stack length differs")
        for j, (lin, tl) in enumerate(zip(p.stack, te["stack"])):
            _put(lin.w, tl["w"], f"{name}.edge.stack[{j}].w")
            _put(lin.b, tl["b"], f"{name}.edge.stack[{j}].b")
        _put_ln(p.ln, te["ln"], f"{name}.edge.ln")
    else:
        load_mlp(layer.edge, t["edge"], f"{name}.edge")
    load_mlp(layer.node, t["node"], f"{name}.node")


def _load_stack(layers, tree, name: str) -> None:
    """Copy a JAX stack (leaves stacked on the leading axis) into a
    ModuleList of MGNLayers."""
    _check_depth(np.asarray(tree["node"]["linears"][0]["w"]).shape[0],
                 len(layers), name)
    for i, layer in enumerate(layers):
        _load_layer(layer, _layer(tree, i), f"{name}[{i}]")


def _check_depth(tree_layers: int, port_layers: int, name: str) -> None:
    if tree_layers != port_layers:
        raise ValueError(f"{name}: {tree_layers} processor layers in JAX, "
                         f"{port_layers} in the port")


def params_from_jax(tree, cfg, *, device: DeviceLike = None):
    """Port parameters equal to a JAX ``cfg.init`` tree (any config of
    ``models.registry``), on ``device``."""
    params = cfg.init(0, device="cpu")
    if isinstance(cfg, TransolverConfig):
        named = dict(params.named_parameters())
        if set(tree) != set(named):
            raise ValueError("Transolver parameters differ: "
                             f"{sorted(set(tree) ^ set(named))[:5]}")
        for name, p in named.items():
            _put(p, tree[name], name)
        return params.to(resolve_device(device))
    if isinstance(cfg, MLPNetConfig):
        load_mlp(params.encoder, tree["encoder"], "encoder")
        load_mlp(params.decoder, tree["decoder"], "decoder")
        return params.to(resolve_device(device))
    if isinstance(cfg, MGNv2Config):
        for k in ("node_encoder", "edge_encoder", "global_encoder",
                  "decoder"):
            load_mlp(getattr(params, k), tree[k], k)
        _put(params.global_linout.w, tree["global_linout"]["w"],
             "global_linout.w")
        _put(params.global_linout.b, tree["global_linout"]["b"],
             "global_linout.b")
        _check_depth(np.asarray(tree["layers"]["edge_mlp"]["linears"][0][
            "w"]).shape[0], len(params.layers), "layers")
        for i, layer in enumerate(params.layers):
            t = _layer(tree["layers"], i)
            load_mlp(layer.edge_mlp, t["edge_mlp"], f"layers[{i}].edge_mlp")
            load_mlp(layer.node_mlp, t["node_mlp"], f"layers[{i}].node_mlp")
        return params.to(resolve_device(device))
    if isinstance(cfg, PoolMGNConfig):
        load_mlp(params.global_encoder, tree["global_encoder"],
                 "global_encoder")
    load_mlp(params.node_encoder, tree["node_encoder"], "node_encoder")
    load_mlp(params.edge_encoder, tree["edge_encoder"], "edge_encoder")
    if isinstance(cfg, BSMSConfig):
        for stage in ("down", "up"):
            if len(tree[stage]) != len(getattr(params, stage)):
                raise ValueError(f"{stage}: {len(tree[stage])} stages in JAX, "
                                 f"{len(getattr(params, stage))} in the port")
            for s, (layers, t) in enumerate(zip(getattr(params, stage),
                                                tree[stage])):
                _load_stack(layers, t, f"{stage}[{s}]")
        _load_stack(params.bottleneck, tree["bottleneck"], "bottleneck")
        load_mlp(params.decoder, tree["decoder"], "decoder")
        return params.to(resolve_device(device))
    _load_stack(params.layers, tree["layers"], "layers")
    if cfg.separate_decoders:
        for i, (d, t) in enumerate(zip(params.decoder, tree["decoder"])):
            load_mlp(d, t, f"decoder[{i}]")
    else:
        load_mlp(params.decoder, tree["decoder"], "decoder")
    return params.to(resolve_device(device))


def _get(param: torch.nn.Parameter, grads: bool) -> np.ndarray:
    t = param.grad if grads else param
    if t is None:
        return np.zeros(tuple(param.shape), np.float32)
    return t.detach().float().cpu().numpy()


def _mlp_tree(mlp: M.MLP, grads: bool):
    return {"linears": [{"w": _get(lin.w, grads), "b": _get(lin.b, grads)}
                        for lin in mlp.linears],
            "ln": None if mlp.ln is None else
            {"scale": _get(mlp.ln.scale, grads),
             "bias": _get(mlp.ln.bias, grads)}}


def _stack(trees):
    """Stack per-layer trees of equal structure on a new leading axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return np.stack(trees)


def _layer_tree(layer: B.MGNLayer, grads: bool):
    if isinstance(layer.edge, B.EdgeBlockSum):
        p = layer.edge
        edge = {k: _get(getattr(p, k), grads)
                for k in ("w_e", "w_s", "w_d", "b")}
        edge["stack"] = [{"w": _get(lin.w, grads), "b": _get(lin.b, grads)}
                         for lin in p.stack]
        edge["ln"] = None if p.ln is None else {
            "scale": _get(p.ln.scale, grads),
            "bias": _get(p.ln.bias, grads)}
    else:
        edge = _mlp_tree(layer.edge, grads)
    return {"edge": edge, "node": _mlp_tree(layer.node, grads)}


def _stack_tree(layers, grads: bool):
    return _stack([_layer_tree(layer, grads) for layer in layers])


def params_to_jax(params, cfg, *, grads: bool = False):
    """The port's parameters (``grads=True``: their ``.grad``, zeros where
    there is none) as the JAX package's ``cfg.init`` tree of float32 numpy
    arrays, processor layers stacked on the leading axis."""
    if isinstance(cfg, TransolverConfig):
        return {n: _get(p, grads) for n, p in params.named_parameters()}
    if isinstance(cfg, MLPNetConfig):
        return {"encoder": _mlp_tree(params.encoder, grads),
                "decoder": _mlp_tree(params.decoder, grads)}
    if isinstance(cfg, MGNv2Config):
        tree = {k: _mlp_tree(getattr(params, k), grads)
                for k in ("node_encoder", "edge_encoder", "global_encoder",
                          "decoder")}
        tree["global_linout"] = {"w": _get(params.global_linout.w, grads),
                                 "b": _get(params.global_linout.b, grads)}
        tree["layers"] = _stack([
            {"edge_mlp": _mlp_tree(layer.edge_mlp, grads),
             "node_mlp": _mlp_tree(layer.node_mlp, grads)}
            for layer in params.layers])
        return tree
    enc = {"node_encoder": _mlp_tree(params.node_encoder, grads),
           "edge_encoder": _mlp_tree(params.edge_encoder, grads)}
    if isinstance(cfg, PoolMGNConfig):
        enc["global_encoder"] = _mlp_tree(params.global_encoder, grads)
    if isinstance(cfg, BSMSConfig):
        return {**enc,
                "down": [_stack_tree(s, grads) for s in params.down],
                "bottleneck": _stack_tree(params.bottleneck, grads),
                "up": [_stack_tree(s, grads) for s in params.up],
                "decoder": _mlp_tree(params.decoder, grads)}
    decoder = ([_mlp_tree(d, grads) for d in params.decoder]
               if cfg.separate_decoders else _mlp_tree(params.decoder, grads))
    return {**enc, "layers": _stack_tree(params.layers, grads),
            "decoder": decoder}
