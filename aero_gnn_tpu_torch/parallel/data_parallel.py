"""Data-parallel training over the ``data`` axis of a mesh (counterpart of
aero_gnn_tpu.parallel.data_parallel, data_parallel.py:32-95).

Each rank holds a full replica of the parameters and its own padded
``GraphBatch`` (JAX's ``stack_batches`` has no port: a rank never sees the
others' batches). The step is the single-device step of
``training.loop`` (the model's ``apply``, ``masked_mse``), then one
all_reduce averages the gradients over the axis (``jax.lax.pmean``) and
another the loss, so every replica takes the same optimizer step. Works for
every model of the zoo.

Dropout: each rank draws its masks from a ``torch.Generator`` seeded from
the step's seed and the rank's index on the axis, in place of JAX's
``fold_in(rng, axis_index("data"))`` (data_parallel.py:50).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from aero_gnn_tpu_torch.models.mgn import apply_model
from aero_gnn_tpu_torch.parallel import collectives as C
from aero_gnn_tpu_torch.parallel.mesh import Mesh
from aero_gnn_tpu_torch.training.loop import masked_mse


def rank_generator(seed: int, index: int,
                   device: torch.device) -> torch.Generator:
    """A generator on ``device`` for rank ``index`` of an axis, seeded from
    (seed, index): distinct streams per rank, the same on every run."""
    s = int(np.random.SeedSequence([int(seed), int(index)])
            .generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(s)


def make_dp_train_step(model_cfg, optimizer: torch.optim.Optimizer,
                       mesh: Mesh, *, needs_hierarchy: bool = False
                       ) -> Callable:
    """``step(params, graph, hierarchy=None, seed=None)`` -> the loss
    averaged over the data axis (a 0-d tensor); updates ``params`` through
    ``optimizer`` with the averaged gradients. ``seed`` turns on the
    encoders' dropout with this rank's stream. The graph and hierarchy are
    this rank's; they are moved to the parameters' device."""
    group = mesh.group("data")

    def step(params, graph, hierarchy=None, seed: Optional[int] = None):
        dev = params.device
        gen = (None if seed is None
               else rank_generator(seed, group.rank, dev))
        optimizer.zero_grad(set_to_none=True)
        pred = apply_model(model_cfg, params, graph, hierarchy,
                           needs_hierarchy, dev, generator=gen)
        loss = masked_mse(pred, graph.y.to(dev), graph.node_mask.to(dev))
        loss.backward()
        C.sum_gradients(params, group, 1.0 / group.size)
        optimizer.step()
        return C.all_reduce_raw(loss.detach(), group) / group.size

    return step


def make_dp_eval_step(model_cfg, mesh: Mesh, *,
                      needs_hierarchy: bool = False) -> Callable:
    """``eval_step(params, graph, hierarchy=None)`` -> the loss averaged
    over the data axis, without gradients."""
    group = mesh.group("data")

    def eval_step(params, graph, hierarchy=None):
        with torch.no_grad():
            pred = apply_model(model_cfg, params, graph, hierarchy,
                               needs_hierarchy, params.device)
            loss = masked_mse(pred, graph.y.to(params.device),
                              graph.node_mask.to(params.device))
            return C.all_reduce_raw(loss, group) / group.size

    return eval_step
