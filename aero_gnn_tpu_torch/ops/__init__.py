"""Gather / segment ops with a switchable backend (counterpart of
aero_gnn_tpu.ops).

``backend()`` is ``"cuda"`` (default) or ``"torch"``:

  * ``"cuda"``: the model's fused-path gates hold, and the kernel wrappers
    (``ops.hopper_fused``, ``ops.hopper_node``) launch the Hopper kernels on
    CUDA tensors. Given CPU tensors, a wrapper runs its plain version.
  * ``"torch"``: every gate fails and the model runs the plain PyTorch
    composition everywhere: the explicit reference mode.

Switch globally with ``set_backend`` or scoped with ``use_backend``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from aero_gnn_tpu_torch.ops.scatter import (  # noqa: F401
    degree,
    gather_receivers,
    gather_senders,
    segment_sum_sorted,
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


def refuse_unported_kernel(what: str, kernel: str, t: torch.Tensor) -> None:
    """On the cuda backend an aligned stream on the card belongs to a Hopper
    kernel that is not ported yet; refuse rather than run the plain op."""
    if _BACKEND == "cuda" and t.is_cuda:
        raise NotImplementedError(
            f"{what} on an aligned edge stream needs Hopper kernel {kernel} "
            "(the port of aero_gnn_tpu/ops/pallas_segment.py), which is not "
            "ported yet; use ops.use_backend('torch') for the plain path")


def aggregate_edges(messages: torch.Tensor, receivers: torch.Tensor,
                    num_nodes: int, *, aggregation: str,
                    edge_mask: Optional[torch.Tensor] = None,
                    aligned: bool = False) -> torch.Tensor:
    """Aggregate edge messages to destination nodes ([E, D] -> [N, D]),
    'add' or 'mean'; ValueError on any other mode."""
    if aggregation not in ("add", "mean"):
        raise ValueError(f"Unsupported aggregation method: {aggregation}")
    if aligned:
        refuse_unported_kernel("aggregate_edges", "K5 (segment_agg_pallas)",
                               messages)
    if edge_mask is not None:
        messages = messages * edge_mask[:, None].to(messages.dtype)
    summed = segment_sum_sorted(messages, receivers, num_nodes)
    if aggregation == "mean":
        deg = degree(receivers, num_nodes, mask=edge_mask,
                     dtype=messages.dtype)
        summed = summed / torch.clamp(deg, min=1.0)[:, None]
    return summed

