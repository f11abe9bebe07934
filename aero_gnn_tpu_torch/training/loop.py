"""Train / eval steps and the epoch driver (counterpart of
aero_gnn_tpu.training.loop).

Adam whose ``weight_decay`` adds ``wd * p`` to the gradient before the Adam
update (what the JAX package builds as optax.chain(add_decayed_weights,
adam)), the learning rate set on the optimizer from the host, masked MSE so
pad nodes never reach the loss, ReduceLROnPlateau + early stopping stepped
once per epoch, periodic checkpoints with resume (``training/checkpoint.py``)
and a JSONL metric log. The entry points take a ``device``: the CUDA card
unless the caller passes ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from aero_gnn_tpu_torch.data.batching import Loader
from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.models.mgn import apply_model
from aero_gnn_tpu_torch.training import checkpoint as C
from aero_gnn_tpu_torch.training.schedulers import (
    EarlyStopping,
    ReduceLROnPlateau,
)
from aero_gnn_tpu_torch.utils.logging import MetricLogger
from aero_gnn_tpu_torch.utils.profiling import annotate


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               node_mask: torch.Tensor) -> torch.Tensor:
    """MSE over real nodes only == nn.MSELoss on the unpadded batch."""
    m = node_mask[:, None]
    return torch.sum(torch.square(pred - target) * m) / (
        torch.sum(m) * target.shape[-1])


def make_optimizer(params: torch.nn.Module, learning_rate: float,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam over ``params`` (torch's additive L2 ``weight_decay``, not
    AdamW; betas and eps are optax.adam's defaults)."""
    return torch.optim.Adam(params.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclasses.dataclass
class StepFns:
    """``train_step(params, graph, hierarchy=None, generator=None)`` runs
    forward, backward and the optimizer step and returns the loss (a 0-d
    tensor on the device); ``eval_step(params, graph, hierarchy=None)`` the
    loss without gradients; ``predict(params, graph, hierarchy=None)`` the
    fp32 predictions. ``hierarchy`` (the Loader's ``aux["hierarchy"]``) is
    required by ``needs_hierarchy`` models (BSMS)."""

    train_step: Callable
    eval_step: Callable
    predict: Callable
    device: torch.device


def make_step_fns(model_cfg, optimizer: torch.optim.Optimizer, *,
                  device: DeviceLike = None,
                  needs_hierarchy: bool = False) -> StepFns:
    """Steps of ``model_cfg`` on ``device`` (CUDA unless ``"cpu"``);
    ``optimizer`` holds the parameters the train step updates. Graphs and
    hierarchies are moved to the device when they are not on it."""
    dev = resolve_device(device)

    def apply(params, graph, hierarchy, generator=None):
        if params.device != dev:
            raise ValueError(f"params are on {params.device}, the steps run "
                             f"on {dev}")
        return apply_model(model_cfg, params, graph, hierarchy,
                           needs_hierarchy, dev, generator=generator)

    def train_step(params, graph, hierarchy=None,
                   generator: Optional[torch.Generator] = None):
        optimizer.zero_grad(set_to_none=True)
        with annotate("aero.step.forward"):
            pred = apply(params, graph, hierarchy, generator)
            loss = masked_mse(pred, graph.y.to(dev), graph.node_mask.to(dev))
        with annotate("aero.step.backward"):
            loss.backward()
        with annotate("aero.step.optimizer"):
            optimizer.step()
        return loss.detach()

    def eval_step(params, graph, hierarchy=None):
        with torch.no_grad(), annotate("aero.step.forward"):
            pred = apply(params, graph, hierarchy)
            return masked_mse(pred, graph.y.to(dev), graph.node_mask.to(dev))

    def predict(params, graph, hierarchy=None):
        with torch.no_grad():
            return apply(params, graph, hierarchy)

    return StepFns(train_step=train_step, eval_step=eval_step,
                   predict=predict, device=dev)


def run_epoch_train(fns: StepFns, params, loader: Loader,
                    generator: Optional[torch.Generator] = None) -> float:
    """The mean loss of one pass over ``loader``; each step is a span
    ``aero.step`` whose child ``aero.step.sync`` is the host's wait for the
    loss."""
    total, count = 0.0, 0
    for graph, aux in loader:
        with annotate("aero.step"):
            loss = fns.train_step(params, graph, aux.get("hierarchy"),
                                  generator)
            with annotate("aero.step.sync"):
                total += float(loss)
        count += 1
    return total / max(count, 1)


def run_epoch_eval(fns: StepFns, params, loader: Loader) -> float:
    total, count = 0.0, 0
    for graph, aux in loader:
        with annotate("aero.step"):
            loss = fns.eval_step(params, graph, aux.get("hierarchy"))
            with annotate("aero.step.sync"):
                total += float(loss)
        count += 1
    return total / max(count, 1)


@dataclasses.dataclass
class FitResult:
    params: Any
    optimizer: torch.optim.Optimizer
    train_losses: List[float]
    val_losses: List[float]
    epochs_run: int
    stopped_early: bool
    wall_time_s: float


def fit(*, model_cfg, params, train_loader: Loader, val_loader: Loader,
        training_config: Dict[str, Any], needs_hierarchy: bool = False,
        seed: int = 0, log_every: int = 1,
        checkpoint_dir: Optional[str] = None,
        log_fn: Callable[[str], None] = print,
        device: DeviceLike = None) -> FitResult:
    """The epoch loop: train, eval, plateau LR, early stop, checkpoints.
    ``params`` is moved to ``device`` (CUDA unless ``"cpu"``) and trained in
    place; the dropout masks of epoch k come from a generator seeded
    ``seed + k``. With ``checkpoint_dir``, every ``checkpoint_every``-th
    epoch is saved there, the metrics go to ``checkpoint_dir/../
    metrics.jsonl``, and ``resume`` restores the newest checkpoint's params
    and optimizer state (its learning rate included) in place and continues
    from its epoch with its loss history; the plateau and early-stop state
    start fresh, as in the JAX package."""
    dev = resolve_device(device)
    params = params.to(dev)
    lr = training_config.get("learning_rate", 1e-3)
    optimizer = make_optimizer(params, lr,
                               training_config.get("weight_decay", 0.0))
    fns = make_step_fns(model_cfg, optimizer, device=dev,
                        needs_hierarchy=needs_hierarchy)
    plateau = ReduceLROnPlateau(
        lr=lr, factor=training_config.get("lr_scheduler_gamma", 0.8),
        patience=training_config.get("lr_scheduler_step_size", 50),
        min_lr=1e-7)
    early = EarlyStopping(patience=training_config.get("patience", 200))
    use_early = bool(training_config.get("early_stopping", True))
    epochs = int(training_config.get("epochs", 0))
    ckpt_every = int(training_config.get("checkpoint_every", 0) or 0)

    train_losses: List[float] = []
    val_losses: List[float] = []
    t0 = time.time()
    stopped = False
    start_epoch = 0
    metrics = MetricLogger(
        os.path.join(checkpoint_dir, "..", "metrics.jsonl")
        if checkpoint_dir else None)
    if checkpoint_dir and training_config.get("resume"):
        restored = C.restore_latest(checkpoint_dir, params, optimizer)
        if restored is not None:
            start_epoch, hist = restored
            train_losses = list(hist.get("train_losses", []))
            val_losses = list(hist.get("val_losses", []))
            log_fn(f"resumed from checkpoint at epoch {start_epoch}")

    for epoch in range(start_epoch, epochs):
        gen = torch.Generator(device=dev).manual_seed(seed + epoch)
        train_loss = run_epoch_train(fns, params, train_loader, gen)
        val_loss = run_epoch_eval(fns, params, val_loader)
        new_lr = plateau.step(val_loss)
        set_learning_rate(optimizer, new_lr)
        train_losses.append(train_loss)
        val_losses.append(val_loss)
        if log_every and epoch % log_every == 0:
            log_fn(f"epoch {epoch:4d}  loss {train_loss:.6f}  "
                   f"val {val_loss:.6f}  lr {new_lr:.2e}")
        metrics.log(epoch, train_loss=train_loss, val_loss=val_loss,
                    lr=new_lr)
        if checkpoint_dir and ckpt_every and (epoch + 1) % ckpt_every == 0:
            C.save(checkpoint_dir, params, optimizer, epoch + 1,
                   {"train_losses": train_losses, "val_losses": val_losses})
        if use_early and early.step(val_loss):
            log_fn(f"early stopping at epoch {epoch}")
            stopped = True
            break

    metrics.close()
    return FitResult(params=params, optimizer=optimizer,
                     train_losses=train_losses, val_losses=val_losses,
                     epochs_run=len(train_losses), stopped_early=stopped,
                     wall_time_s=time.time() - t0)
