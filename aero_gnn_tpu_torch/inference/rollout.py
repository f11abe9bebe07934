"""Rollout / serving harness: repeated inference (counterpart of
aero_gnn_tpu.inference.rollout).

  * ``make_batch_rollout`` — one forward per graph of K same-shape padded
    graphs, predictions stacked [K, N_pad, Dy];
  * ``autoregressive_rollout`` — feeds predictions back into chosen
    node-feature columns for T steps (for models trained on incremental
    targets; not used by the steady-state datasets).

Both run a Python loop under ``torch.inference_mode()`` where the JAX
package scans a jitted forward, on the parameters' device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from aero_gnn_tpu_torch.graph.padded import GraphBatch
from aero_gnn_tpu_torch.models.mgn import apply_model


def stack_graphs(graphs: Sequence[GraphBatch]) -> GraphBatch:
    """[K] same-shape GraphBatches -> one GraphBatch whose tensors have a
    leading K axis (the layout ``make_batch_rollout`` takes); a per-graph
    count that differs between the graphs (``n_node``, ``n_edge``) becomes
    a tuple of K."""
    fields = {}
    for f in dataclasses.fields(graphs[0]):
        vals = [getattr(g, f.name) for g in graphs]
        if isinstance(vals[0], torch.Tensor):
            fields[f.name] = torch.stack(vals)
        else:
            fields[f.name] = vals[0] if len(set(vals)) == 1 else tuple(vals)
    return GraphBatch(**fields)


def _unstack(stacked: GraphBatch, k: int) -> GraphBatch:
    fields = {}
    for f in dataclasses.fields(stacked):
        v = getattr(stacked, f.name)
        fields[f.name] = v[k] if isinstance(v, (torch.Tensor, tuple)) else v
    return GraphBatch(**fields)


def make_batch_rollout(model_cfg, *, needs_hierarchy: bool = False
                       ) -> Callable:
    """Returns (params, stacked_graphs[, hierarchies]) -> predictions
    [K, N_pad, Dy]: ``stacked_graphs`` from ``stack_graphs``,
    ``hierarchies`` one per graph for ``needs_hierarchy`` models."""

    def rollout(params, stacked: GraphBatch, hierarchies=None):
        k_graphs = stacked.x.shape[0]
        with torch.inference_mode():
            return torch.stack([
                apply_model(model_cfg, params, _unstack(stacked, k),
                            hierarchies[k] if needs_hierarchy else None,
                            needs_hierarchy, params.device)
                for k in range(k_graphs)])

    return rollout


def autoregressive_rollout(model_cfg, params, graph: GraphBatch, *,
                           steps: int,
                           feedback_columns: Optional[Sequence[int]] = None
                           ) -> torch.Tensor:
    """Feed predictions back into node features for ``steps`` iterations.

    ``feedback_columns``: which x columns receive the prediction (defaults
    to the LAST Dy columns). Returns the trajectory [steps, N_pad, Dy]. The
    caller's graph is not written: the feedback goes into a copy of x.
    """
    dy = graph.y.shape[1]
    n_x = graph.x.shape[1]
    cols = (torch.arange(n_x - dy, n_x) if feedback_columns is None
            else torch.as_tensor(feedback_columns, dtype=torch.long))
    cols = cols.to(graph.x.device)
    traj = []
    with torch.inference_mode():
        g = dataclasses.replace(graph, x=graph.x.clone())
        for _ in range(steps):
            pred = apply_model(model_cfg, params, g, None, False,
                               params.device)
            traj.append(pred)
            x = g.x.clone()
            x[:, cols] = pred.to(x.dtype)
            g = dataclasses.replace(g, x=x)
    return torch.stack(traj)
