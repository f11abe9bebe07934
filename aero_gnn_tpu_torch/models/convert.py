"""Carry a JAX-package MGN parameter tree over to the port (the inverse of
aero_gnn_tpu/utils/torch_import.py).

The JAX tree, as numpy arrays, has the layout of ``MGNConfig.init`` there:
``{"node_encoder", "edge_encoder": {"linears": [{"w", "b"}], "ln"},
"layers": {"edge": ..., "node": ...} with every leaf stacked on a leading
layer axis, "decoder": MLP tree or a list of them}``. Weights are [in, out]
in both packages, so each leaf is an exact copy.
"""

from __future__ import annotations

import numpy as np
import torch

from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.models.mgn import MeshGraphNet, MGNConfig
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


def params_from_jax(tree, cfg: MGNConfig, *,
                    device: DeviceLike = None) -> MeshGraphNet:
    """Port parameters equal to a JAX ``cfg.init`` tree, on ``device``."""
    params = cfg.init(0, device="cpu")
    load_mlp(params.node_encoder, tree["node_encoder"], "node_encoder")
    load_mlp(params.edge_encoder, tree["edge_encoder"], "edge_encoder")
    n_layers = np.asarray(tree["layers"]["node"]["linears"][0]["w"]).shape[0]
    if n_layers != len(params.layers):
        raise ValueError(f"{n_layers} processor layers in JAX, "
                         f"{len(params.layers)} in the port")
    for i, layer in enumerate(params.layers):
        t = _layer(tree["layers"], i)
        name = f"layers[{i}]"
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
    if cfg.separate_decoders:
        for i, (d, t) in enumerate(zip(params.decoder, tree["decoder"])):
            load_mlp(d, t, f"decoder[{i}]")
    else:
        load_mlp(params.decoder, tree["decoder"], "decoder")
    return params.to(resolve_device(device))
