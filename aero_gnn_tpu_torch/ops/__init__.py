"""Gather / segment ops with a switchable backend (counterpart of
aero_gnn_tpu.ops).

``backend()`` is ``"cuda"`` (default) or ``"torch"``:

  * ``"cuda"``: the model's fused-path gates hold, and the kernel wrappers
    (``ops.hopper_fused``, ``ops.hopper_node``, ``ops.hopper_segment``,
    ``ops.hopper_gather``) launch the Hopper kernels on CUDA tensors. Given
    CPU tensors, a wrapper runs its plain version.
  * ``"torch"``: every gate fails and the model runs the plain PyTorch
    composition everywhere: the explicit reference mode.

Switch globally with ``set_backend`` or scoped with ``use_backend``.
``segment_sum_weighted2`` (kernel K10, two weighted segment sums over one
receiver stream) is the WEC pair probe of the JAX package
(``segment_agg_weighted2_pallas``), on no model path.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from aero_gnn_tpu_torch.ops.hopper_segment import (  # noqa: F401
    segment_sum_weighted2,
)
from aero_gnn_tpu_torch.ops.scatter import (  # noqa: F401
    degree,
    gather,
    gather_chunked,
    gather_receivers,
    gather_senders,
    graph_broadcast,
    graph_pool,
    segment_max,
    segment_mean,
    segment_pool_sum,
    segment_sum,
    segment_sum_masked,
    segment_sum_sorted,
    segment_sum_weighted,
)

_BACKENDS = ("torch", "cuda")
_BACKEND = "cuda"


def backend() -> str:
    return _BACKEND


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"Unknown ops backend: {name}")
    _BACKEND = name


@contextlib.contextmanager
def use_backend(name: str):
    global _BACKEND
    prev = _BACKEND
    set_backend(name)
    try:
        yield
    finally:
        _BACKEND = prev


def aggregate_edges(messages: torch.Tensor, receivers: torch.Tensor,
                    num_nodes: int, *, aggregation: str,
                    edge_mask: Optional[torch.Tensor] = None,
                    aligned: bool = False,
                    pad_sink: bool = False) -> torch.Tensor:
    """Aggregate edge messages to destination nodes ([E, D] -> [N, D]),
    'add' or 'mean'; ValueError on any other mode. On the cuda backend the
    sum runs on kernel K5 (its plain version on CPU tensors); on an aligned
    stream the 'mean' degree is K5's sum of the mask, as segment_agg_pallas
    does, elsewhere ``degree``'s exact counts. ``pad_sink`` declares the
    stream one of ``graph.padded`` (GraphBatch, HierarchyLevel): every row
    keyed by the last node, the pad sink, is masked, so K5 skips those rows
    (a Loader batch's pad tail) and writes the sink's row as 0, the exact
    sum. Without it the last node's rows are summed like any other."""
    if aggregation not in ("add", "mean"):
        raise ValueError(f"Unsupported aggregation method: {aggregation}")
    if aligned and _BACKEND == "cuda":
        mask = (torch.ones(messages.shape[0], dtype=messages.dtype,
                           device=messages.device)
                if edge_mask is None else edge_mask)
        summed = segment_sum_masked(messages, receivers, mask, num_nodes,
                                    pad_sink=pad_sink)
        if aggregation == "mean":
            deg = segment_sum_masked(mask[:, None].to(messages.dtype),
                                     receivers, mask, num_nodes,
                                     pad_sink=pad_sink)
            summed = summed / torch.clamp(deg, min=1.0)
        return summed
    if edge_mask is not None:
        messages = messages * edge_mask[:, None].to(messages.dtype)
    summed = segment_sum_sorted(messages, receivers, num_nodes,
                                pad_sink=pad_sink)
    if aggregation == "mean":
        deg = degree(receivers, num_nodes, mask=edge_mask,
                     dtype=messages.dtype)
        summed = summed / torch.clamp(deg, min=1.0)[:, None]
    return summed


def aggregate_edges_weighted(messages: torch.Tensor, weights: torch.Tensor,
                             receivers: torch.Tensor, num_nodes: int, *,
                             aligned: bool = False,
                             mask: Optional[torch.Tensor] = None,
                             rows: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """``out[n] = sum_{e: recv(e) = n} weights[e] * messages[e]``, the
    messages ``messages[rows[e]]`` when ``rows`` is given. On the cuda
    backend an aligned stream takes kernel K7 (its plain version on CPU
    tensors; the gather read inside the kernel), the weight at the
    messages' precision, differentiable in both with the JAX package's
    ``_sswp_bwd``. Elsewhere an explicit gather, multiply and sorted
    segment sum (K5 on the cuda backend). Pad edges: pass ``mask``, or
    give them zero weights. The model's only caller, the BSMS WEC, calls
    it inside its own autograd Functions, so no card path differentiates
    the ``rows`` gather (its backward is the plain ``index_add``)."""
    if aligned and _BACKEND == "cuda":
        return segment_sum_weighted(messages, weights, receivers, num_nodes,
                                    mask=mask, rows=rows)
    m = messages if rows is None else gather(messages, rows)
    if mask is not None:
        m = m * mask[:, None].to(m.dtype)
    return segment_sum_sorted(m * weights[:, None].to(m.dtype), receivers,
                              num_nodes)
