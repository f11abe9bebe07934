"""Matmuls of the reference at a stated precision.

* ``fp32``: float32 with TF32 off (the judge).
* ``tf32``: the same matmuls with TF32 on, the control of a float32
  configuration.
* ``fp8``: float8 e4m3 (per-tensor scale amax / 448) wherever a
  bfloat16 program holds bfloat16: every matmul operand, the inputs, each
  MLP's output, the aggregated messages and the residual stream, with
  float32 products and LayerNorm statistics, and the gradient passed
  straight through in float32: the control of a bfloat16 configuration.

``matmul(precision)`` returns the product; its attribute ``q`` rounds a
stored activation (the identity outside ``fp8``).
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _mm32(a, b):
    return a @ b


def _mm8(a, b):
    return _RoundFp8.apply(a) @ _RoundFp8.apply(b)


_mm32.q = lambda t: t
_mm8.q = _RoundFp8.apply


def matmul(precision: str):
    if precision in ("fp32", "tf32"):
        return _mm32
    if precision == "fp8":
        return _mm8
    raise ValueError(f"unknown precision {precision!r}")


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 in matmuls and convolutions on or off inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
