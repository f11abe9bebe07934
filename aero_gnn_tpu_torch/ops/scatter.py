"""Forward gather / segment primitives in plain PyTorch (forward subset of
aero_gnn_tpu.ops.scatter).

Shape-static and mask-aware: pad edges/nodes contribute exact zeros and
empty segments are zero rows. Segment sums accumulate in float32 and round
once to the data's dtype (``index_add_`` on a float32 buffer; on CUDA its
atomics make the summation order, and so the last bits, vary run to run).
"""

from __future__ import annotations

from typing import Optional

import torch


def gather(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather ``values[indices]``: [N, D] -> [E, D]."""
    return values.index_select(0, indices)


def gather_senders(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """``x[senders]``. The JAX package leaves this forward gather to XLA,
    so the port leaves it to ``index_select``."""
    return gather(x, senders)


def gather_receivers(x: torch.Tensor, receivers: torch.Tensor,
                     aligned: bool = False) -> torch.Tensor:
    """``x[receivers]`` (ascending ids). On the cuda backend an aligned
    stream on the card belongs to kernel K6, which is not ported yet."""
    if aligned:
        from aero_gnn_tpu_torch import ops as _ops

        _ops.refuse_unported_kernel(
            "gather_receivers", "K6 (gather_receivers_pallas)", x)
    return gather(x, receivers)


def segment_sum_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """[E, D] -> [N, D] sum over rows with equal (ascending) ids."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=torch.float32, device=data.device)
    out.index_add_(0, segment_ids, data.float())
    return out.to(data.dtype)


def degree(segment_ids: torch.Tensor, num_segments: int, *,
           mask: Optional[torch.Tensor] = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-segment counts (in-degree when fed receivers). [E] -> [N]."""
    ones = torch.ones(segment_ids.shape[0], dtype=dtype,
                      device=segment_ids.device)
    if mask is not None:
        ones = ones * mask.to(dtype)
    return segment_sum_sorted(ones, segment_ids, num_segments)
