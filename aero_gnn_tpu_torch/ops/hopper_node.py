"""Fused node block + residual: Hopper kernel K3 (forward) and its plain
version (counterpart of aero_gnn_tpu.ops.pallas_node).

    z  = relu(x @ W1x + agg @ W1a + b1)    (concat first linear, split)
    z  = relu(z @ W_i + b_i) ...           (square hidden chain)
    x' = x + LayerNorm(z @ W_out + b_out)  (fp32 statistics)

``fused_node_layer`` launches ``csrc/fused_node_fwd.cu`` on CUDA tensors
and runs ``fused_node_layer_ref`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from aero_gnn_tpu_torch.nn.mlp import layer_norm
from aero_gnn_tpu_torch.ops import _build

ROW_CHUNK = 128  # rows per CTA step of the kernel
KERNEL_WIDTHS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I64, _I, _I, _I, _P]


def fused_node_layer_ref(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                         ln_scale, ln_bias):
    """Plain PyTorch composition, in the order of the JAX package's _equiv
    (pallas_node.py)."""
    z = torch.relu(x @ w1x + agg @ w1a + b1)
    for i in range(ws.shape[0]):
        z = torch.relu(z @ ws[i] + bs[i])
    d = z @ w_out + b_out
    return x + layer_norm(d, ln_scale, ln_bias)


def fused_node_layer(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out, ln_scale,
                     ln_bias):
    """x + LN(MLP([x, agg])). CUDA tensors launch kernel K3; CPU tensors run
    the plain version. Forward only."""
    if not x.is_cuda:
        return fused_node_layer_ref(x, agg, w1x, w1a, b1, ws, bs, w_out,
                                    b_out, ln_scale, ln_bias)
    n, h = x.shape
    n_hidden = ws.shape[0]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused node kernel takes float32 or bfloat16, "
                         f"not {x.dtype}")
    if h not in KERNEL_WIDTHS:
        raise ValueError(f"fused node kernel takes h in {KERNEL_WIDTHS}, "
                         f"not {h}")
    if n % ROW_CHUNK:
        raise ValueError(f"fused node kernel needs N % {ROW_CHUNK} == 0, "
                         f"got N={n}")
    shapes = {"agg": (agg, (n, h)), "w1x": (w1x, (h, h)),
              "w1a": (w1a, (h, h)), "b1": (b1, (h,)),
              "ws": (ws, (n_hidden, h, h)), "bs": (bs, (n_hidden, h)),
              "w_out": (w_out, (h, h)), "b_out": (b_out, (h,)),
              "ln_scale": (ln_scale, (h,)), "ln_bias": (ln_bias, (h,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    _build.check_tensors(x.device, x.dtype, x=x, agg=agg, w1x=w1x, w1a=w1a,
                         b1=b1, ws=ws, bs=bs, w_out=w_out, b_out=b_out,
                         ln_scale=ln_scale, ln_bias=ln_bias)

    out = torch.empty_like(x)
    fn = _build.c_function("fused_node_fwd", "aero_fused_node_fwd",
                           _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), agg.data_ptr(), w1x.data_ptr(),
                 w1a.data_ptr(), b1.data_ptr(), ws.data_ptr(), bs.data_ptr(),
                 w_out.data_ptr(), b_out.data_ptr(), ln_scale.data_ptr(),
                 ln_bias.data_ptr(), out.data_ptr(), n, h, n_hidden,
                 _DTYPE_CODE[x.dtype], stream)
    _build.check_launch("aero_fused_node_fwd", err)
    fused_node_layer.launches += 1
    return out


# launches of kernel K3 since the count was last set to 0
fused_node_layer.launches = 0
