"""MLP with the reference stacking rule (counterpart of aero_gnn_tpu.nn.mlp).

  * layer stack = Linear(in, h) + Linear(h, h) * num_hidden_layers
    + Linear(h, out); with num_hidden_layers == 0 it degenerates to a single
    Linear(in, out);
  * activation (+ optional dropout) after every layer except the last;
  * optional LayerNorm AFTER the final linear, statistics in float32.

Weights are stored ``[in, out]`` (``x @ w + b``), the JAX package's layout,
so carrying JAX parameters over is a copy. Init mirrors torch.nn.Linear:
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, drawn from an
explicit CPU ``torch.Generator``; move the module to its device afterwards.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5  # torch.nn.LayerNorm default


class Linear(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.empty(fan_in, fan_out)
        b = torch.empty(fan_out)
        w.uniform_(-bound, bound, generator=generator)
        b.uniform_(-bound, bound, generator=generator)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim with statistics in float32 (bf16-safe),
    two-pass variance; the result is rounded once to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + LN_EPS)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def layer_norm_apply(ln: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, ln.scale, ln.bias)


_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
    "gelu_exact": F.gelu,  # the erf form, torch.nn.GELU's default
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "elu": F.elu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "sigmoid": torch.sigmoid,
}


def activation_fn(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f"Unsupported activation: {name}")
    return _ACTIVATIONS[name]


def mlp_dims(input_dim: int, hidden_dim: int, output_dim: int,
             num_hidden_layers: int) -> Sequence[tuple]:
    """(fan_in, fan_out) per linear, following the reference stacking rule."""
    if num_hidden_layers == 0:
        return [(input_dim, output_dim)]
    dims = [(input_dim, hidden_dim)]
    dims += [(hidden_dim, hidden_dim)] * num_hidden_layers
    dims += [(hidden_dim, output_dim)]
    return dims


class MLP(nn.Module):
    """``linears`` (ModuleList of Linear) + optional final ``ln``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_hidden_layers: int = 1, use_layer_norm: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = mlp_dims(input_dim, hidden_dim, output_dim, num_hidden_layers)
        self.linears = nn.ModuleList(
            Linear(fi, fo, generator=generator) for fi, fo in dims)
        self.ln = LayerNorm(output_dim) if use_layer_norm else None


def mlp_apply(mlp: MLP, x: torch.Tensor, *, activation: str = "relu",
              dropout: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Forward pass. Dropout (inverted, after each activation) is active
    only when a ``generator`` on x's device is given and ``dropout > 0``;
    the masks come from that generator, so they are not the JAX package's
    bits."""
    act = activation_fn(activation)
    for lin in mlp.linears[:-1]:
        x = act(lin(x))
        if dropout > 0.0 and generator is not None:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) >= dropout
            x = torch.where(keep, x / (1.0 - dropout), torch.zeros_like(x))
    x = mlp.linears[-1](x)
    if mlp.ln is not None:
        x = layer_norm_apply(mlp.ln, x)
    return x
