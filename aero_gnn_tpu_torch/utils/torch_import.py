"""Import trained reference checkpoints (a torch ``model_weights.pt``
state_dict of the reference framework) as the port's parameters
(counterpart of aero_gnn_tpu.utils.torch_import).

The converters parse the state_dict into the JAX package's parameter tree
layout (numpy arrays, processor layers stacked on a leading axis), which
``models.convert.params_from_jax`` loads into the port's modules.

Key layout of the reference modules (state_dict keys):
  MLP:           layers.<i>.weight/.bias, layer_norm.weight/.bias
  EdgeBlock:     edge_block.mlp.<MLP>
  EdgeBlockSum:  edge_block.edge_lin / src_lin / dst_lin / bias,
                 edge_block.mlp.<seq idx>.weight/.bias (Sequential)
  NodeBlock:     node_block.mlp.<MLP>
  MGN:           node_encoder.<MLP>, edge_encoder.<MLP>,
                 layers.<L>.<layer>, decoder.<MLP>
  poolMGN:       + global_encoder.<MLP>
  MLPNet:        mlp.<MLP>, decoder.<MLP>
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

from aero_gnn_tpu_torch.device import DeviceLike
from aero_gnn_tpu_torch.models.convert import _stack, params_from_jax


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu")
    return {k: _np(v) for k, v in sd.items()}


def _subdict(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_mlp_sd(sd: Dict[str, np.ndarray]) -> dict:
    """`layers.<i>.weight/.bias` (+ optional layer_norm) -> MLP params."""
    idxs = sorted({int(m.group(1)) for k in sd
                   if (m := re.match(r"layers\.(\d+)\.weight", k))})
    linears = [{"w": sd[f"layers.{i}.weight"].T.copy(),
                "b": sd[f"layers.{i}.bias"].copy()} for i in idxs]
    ln = None
    if "layer_norm.weight" in sd:
        ln = {"scale": sd["layer_norm.weight"].copy(),
              "bias": sd["layer_norm.bias"].copy()}
    return {"linears": linears, "ln": ln}


def convert_edge_block_sum_sd(sd: Dict[str, np.ndarray]) -> dict:
    """EdgeBlockSum: split linears + `mlp.<seq>` Sequential stack."""
    seq_idx = sorted({int(m.group(1)) for k in sd
                      if (m := re.match(r"mlp\.(\d+)\.weight", k))})
    stack, ln = [], None
    for i in seq_idx:
        w = sd[f"mlp.{i}.weight"]
        if w.ndim == 2:
            stack.append({"w": w.T.copy(), "b": sd[f"mlp.{i}.bias"].copy()})
        else:  # LayerNorm weight is 1-D
            ln = {"scale": w.copy(), "bias": sd[f"mlp.{i}.bias"].copy()}
    return {"w_e": sd["edge_lin"].T.copy(), "w_s": sd["src_lin"].T.copy(),
            "w_d": sd["dst_lin"].T.copy(), "b": sd["bias"].copy(),
            "stack": stack, "ln": ln}


def _convert_layer_sd(sd: Dict[str, np.ndarray]) -> dict:
    if "edge_block.edge_lin" in sd:
        edge = convert_edge_block_sum_sd(_subdict(sd, "edge_block."))
    else:
        edge = convert_mlp_sd(_subdict(sd, "edge_block.mlp."))
    node = convert_mlp_sd(_subdict(sd, "node_block.mlp."))
    return {"edge": edge, "node": node}


def convert_mgn_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference MeshGraphNet / poolMGN / FourierMGN state_dict -> the
    parameter tree, layers stacked on the leading axis."""
    n_layers = max(int(m.group(1)) for k in sd
                   if (m := re.match(r"layers\.(\d+)\.", k))) + 1
    layers: List[dict] = [
        _convert_layer_sd(_subdict(sd, f"layers.{i}."))
        for i in range(n_layers)
    ]
    params: Dict[str, Any] = {
        "node_encoder": convert_mlp_sd(_subdict(sd, "node_encoder.")),
        "edge_encoder": convert_mlp_sd(_subdict(sd, "edge_encoder.")),
        "layers": _stack(layers),
        "decoder": convert_mlp_sd(_subdict(sd, "decoder.")),
    }
    if any(k.startswith("global_encoder.") for k in sd):
        params["global_encoder"] = convert_mlp_sd(
            _subdict(sd, "global_encoder."))
    return params


def convert_mlpnet_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    return {"encoder": convert_mlp_sd(_subdict(sd, "mlp.")),
            "decoder": convert_mlp_sd(_subdict(sd, "decoder."))}


def import_reference_checkpoint(path: str, model_kind: str, cfg, *,
                                device: DeviceLike = None):
    """Load and convert a reference ``model_weights.pt`` for ``model_kind``
    in {"mgn", "poolmgn", "fouriermgn", "mlpnet"}: the parameter module of
    ``cfg`` (a config of ``models.registry`` of that kind) on ``device``
    (CUDA unless ``"cpu"``)."""
    sd = load_state_dict(path)
    if model_kind in ("mgn", "poolmgn", "fouriermgn"):
        tree = convert_mgn_state_dict(sd)
    elif model_kind == "mlpnet":
        tree = convert_mlpnet_state_dict(sd)
    else:
        raise ValueError(f"Unsupported model kind for import: {model_kind}")
    return params_from_jax(tree, cfg, device=device)
