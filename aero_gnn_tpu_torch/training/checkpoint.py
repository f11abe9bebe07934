"""Checkpoints, final weights and normalisation statistics (counterpart of
aero_gnn_tpu.training.checkpoint).

``save`` / ``restore_latest``: periodic ``ckpt_{epoch:08d}.pt`` files in a
checkpoint directory, each a ``torch.save`` of the parameters'
``state_dict``, the optimizer's ``state_dict`` (Adam's moments and its
learning rate), the epoch and the loss history, written to a temporary file
and renamed into place so a crash never leaves a torn checkpoint.

``save_params`` / ``load_params``: the final ``model_weights.pkl`` in the
JAX package's layout, a pickle of the model's parameter tree as float32
numpy arrays (``models.convert.params_to_jax``), read back through
``params_from_jax``. A run directory written by either package is therefore
readable by both; unpickling it imports numpy only.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from aero_gnn_tpu_torch.device import DeviceLike
from aero_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.pt")


def save(ckpt_dir: str, params: torch.nn.Module,
         optimizer: torch.optim.Optimizer, epoch: int,
         history: Dict[str, Any]) -> str:
    """Save params + optimizer state + epoch + history; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"params": params.state_dict(),
               "optimizer": optimizer.state_dict(),
               "epoch": epoch, "history": history}
    path = _ckpt_path(ckpt_dir, epoch)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic: no torn checkpoints on crash
    return path


def restore_latest(ckpt_dir: str, params: torch.nn.Module,
                   optimizer: torch.optim.Optimizer
                   ) -> Optional[Tuple[int, Dict[str, Any]]]:
    """Load the newest checkpoint into ``params`` and ``optimizer`` in place
    (on the devices they are on); returns (epoch, history), or None when
    the directory holds no checkpoint."""
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted(p for p in os.listdir(ckpt_dir)
                   if p.startswith("ckpt_") and p.endswith(".pt"))
    if not ckpts:
        return None
    payload = torch.load(os.path.join(ckpt_dir, ckpts[-1]),
                         map_location="cpu", weights_only=True)
    params.load_state_dict(payload["params"])
    optimizer.load_state_dict(payload["optimizer"])
    return payload["epoch"], payload["history"]


def save_params(path: str, params: torch.nn.Module, model_cfg) -> None:
    """Final model weights artifact, in the JAX package's tree layout."""
    with open(path, "wb") as f:
        pickle.dump(params_to_jax(params, model_cfg), f)


def load_params(path: str, model_cfg, *, device: DeviceLike = None):
    """The port's parameters of ``model_cfg`` from a ``model_weights.pkl``
    written by either package, on ``device`` (CUDA unless ``"cpu"``)."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    return params_from_jax(tree, model_cfg, device=device)


def save_norm_stats(path: str, stats: Dict[str, np.ndarray]) -> None:
    np.savez(path, **stats)


def load_norm_stats(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
