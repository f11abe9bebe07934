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

``make_dcp_manager`` / ``save_dcp`` / ``restore_dcp``: the multi-process
checkpoints, counterparts of the Orbax functions (``make_orbax_manager``,
``save_orbax``, ``restore_orbax``, JAX training/checkpoint.py:66-98), on
``torch.distributed.checkpoint``. Every rank calls them; each step is a
directory ``{epoch:08d}/`` of the parameters' and the optimizer's state
(``torch.distributed.checkpoint.state_dict``: replicated tensors written
once) and the loss history (``history.json``, rank 0); a step counts once
its ``.metadata`` is written, so a torn save is never restored. Saves are
asynchronous (``async_save``), as the Orbax manager's are by default, and
the manager keeps the newest ``max_to_keep`` steps.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Any, Dict, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# torch.distributed.checkpoint (asynchronous, multi-process)
# ---------------------------------------------------------------------------

class DCPManager:
    """The step directories of one checkpoint directory, the save in
    flight, and the process group the checkpoint collectives run on (a
    gloo group when the default group is not gloo: an asynchronous save
    coordinates on the CPU)."""

    def __init__(self, ckpt_dir: str, max_to_keep: int, process_group=None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.process_group = process_group
        self._pending = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"{step:08d}")

    def all_steps(self) -> List[int]:
        """The steps whose save completed, oldest first."""
        if not os.path.isdir(self.ckpt_dir):
            return []
        return sorted(int(d) for d in os.listdir(self.ckpt_dir)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.ckpt_dir, d, ".metadata")))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        """Wait for the save in flight, then keep the newest
        ``max_to_keep`` steps (rank 0 deletes the rest). Every rank calls
        it and leaves it only once the deletion is done, so that every
        rank then sees the same steps."""
        import torch.distributed as dist

        if self._pending is not None:
            self._pending.result()
            self._pending = None
        if _rank() == 0:
            for step in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(step))
        if dist.is_initialized():
            dist.barrier(group=self.process_group)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def make_dcp_manager(ckpt_dir: str, *, max_to_keep: int = 3) -> DCPManager:
    """A DCPManager of ``ckpt_dir`` (every rank calls it)."""
    import torch.distributed as dist

    pg = None
    if dist.is_initialized() and dist.get_backend() != "gloo":
        pg = dist.new_group(backend="gloo")
    os.makedirs(ckpt_dir, exist_ok=True)
    return DCPManager(ckpt_dir, max_to_keep, pg)


def _state(params: torch.nn.Module, optimizer: torch.optim.Optimizer):
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(params, optimizer)
    return {"params": model_sd, "optimizer": optim_sd}


def save_dcp(manager: DCPManager, params: torch.nn.Module,
             optimizer: torch.optim.Optimizer, epoch: int,
             history: Dict[str, Any]) -> None:
    """Save params + optimizer state + history as step ``epoch`` (every
    rank calls it), asynchronously (the previous save is waited for
    first)."""
    import torch.distributed.checkpoint as dcp

    manager.wait_until_finished()
    path = manager._step_dir(epoch)
    if _rank() == 0:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "history.json"), "w") as f:
            json.dump(history, f)
    state = _state(params, optimizer)
    manager._pending = dcp.async_save(
        state, checkpoint_id=path, process_group=manager.process_group)


def restore_dcp(manager: DCPManager, params: torch.nn.Module,
                optimizer: torch.optim.Optimizer
                ) -> Optional[Tuple[int, Dict[str, Any]]]:
    """Load the newest complete step into ``params`` and ``optimizer`` in
    place (every rank calls it); returns (epoch, history), or None when
    the directory holds no complete step."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import set_state_dict

    manager.wait_until_finished()
    step = manager.latest_step()
    if step is None:
        return None
    path = manager._step_dir(step)
    state = _state(params, optimizer)
    dcp.load(state, checkpoint_id=path, process_group=manager.process_group)
    set_state_dict(params, optimizer, model_state_dict=state["params"],
                   optim_state_dict=state["optimizer"])
    with open(os.path.join(path, "history.json")) as f:
        history = json.load(f)
    return step, history
