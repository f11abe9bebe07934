"""Seeded weights, made on the device in one draw and handed alike to the
port and to the reference.

The layout (names, shapes, init kind, fan-in) is the reference's
(``reference.<model>.layout``), in the port's parameter names. Linear
weights and biases are U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as
torch.nn.Linear draws them; LayerNorm scales 1 + U(-0.1, 0.1) and biases
U(-0.1, 0.1), so that every leaf carries seeded values.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def make(layout: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} from one uniform draw of a
    generator on ``device`` seeded with ``seed``."""
    sizes = [math.prod(shape) for _, shape, _, _ in layout]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device).mul_(2).sub_(1)
    out = {}
    for (name, shape, kind, fan_in), part in zip(layout,
                                                 torch.split(u, sizes)):
        part = part.view(shape)
        if kind in ("w", "b"):
            out[name] = part * (1.0 / math.sqrt(fan_in))
        elif kind == "ln_scale":
            out[name] = 1.0 + 0.1 * part
        else:
            out[name] = 0.1 * part
    return out


def load_into(module: torch.nn.Module, w: Dict[str, torch.Tensor]) -> None:
    """Copy ``w`` into ``module``'s parameters; ValueError unless the names
    and shapes are the same sets."""
    params = dict(module.named_parameters())
    if set(params) != set(w):
        raise ValueError(
            "weights layout differs from the port's parameters: only in the "
            f"port {sorted(set(params) - set(w))[:5]}, only in the layout "
            f"{sorted(set(w) - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(w[name].shape):
                raise ValueError(f"{name}: port {tuple(p.shape)}, layout "
                                 f"{tuple(w[name].shape)}")
            p.copy_(w[name])
