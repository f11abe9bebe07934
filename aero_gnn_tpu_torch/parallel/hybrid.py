"""Hybrid data x spatial parallel training over a 2-D rank grid
(counterpart of aero_gnn_tpu.parallel.hybrid, hybrid.py:28-97).

Axes: ``data`` replicates the model over independent meshes, ``graph``
partitions each mesh spatially with a per-layer exchange. Gradients: psum
over ``graph`` (one mesh's partial contributions), then pmean over
``data``: one all_reduce over the whole grid scaled by 1 / data, the scale
JAX's pair of collectives gives. The loss is each shard's local numerator
over its mesh's count (``spatial.shard_loss`` over the graph axis), summed
and averaged the same way. JAX's ``stack_spatial`` / ``stack_halo_split``
have no port: each rank holds its own shard of its own mesh.
"""

from __future__ import annotations

import torch

from aero_gnn_tpu_torch.parallel.halo import halo_split_mgn_forward
from aero_gnn_tpu_torch.parallel.mesh import Mesh
from aero_gnn_tpu_torch.parallel.spatial import (
    make_sharded_step,
    spatial_mgn_forward,
)


def _hybrid_step(forward, model_cfg, optimizer, mesh: Mesh):
    graph = mesh.group("graph")
    return make_sharded_step(
        lambda params, sh: forward(params, model_cfg, sh, graph),
        optimizer, graph, mesh.group("world"), 1.0 / mesh.shape[0])


def make_hybrid_train_step(model_cfg, optimizer: torch.optim.Optimizer,
                           mesh: Mesh):
    """``step(params, sh)`` -> the loss averaged over the meshes, on the
    all_gather exchange (``spatial.spatial_mgn_forward``)."""
    return _hybrid_step(spatial_mgn_forward, model_cfg, optimizer, mesh)


def make_hybrid_halo_split_train_step(model_cfg,
                                      optimizer: torch.optim.Optimizer,
                                      mesh: Mesh):
    """The same on the flagship exchange: the split halo streams
    (``halo.halo_split_mgn_forward``)."""
    return _hybrid_step(halo_split_mgn_forward, model_cfg, optimizer, mesh)
