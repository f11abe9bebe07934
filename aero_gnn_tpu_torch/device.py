"""Device selection for the port's entry points.

Every entry point takes a ``device`` argument. ``None`` means the CUDA card;
the CPU is used only when the caller asks for it explicitly. There is no
silent CPU fallback and no environment variable that picks the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"cuda"`` -> the current CUDA device; ``"cpu"`` -> the CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r} (expected cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        # the index tensors report, so device checks compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
