"""Fused concat-trick edge layer: Hopper kernel K1 (forward) and its plain
version (counterpart of aero_gnn_tpu.ops.pallas_fused).

One pass over the receiver-sorted, block-aligned edge rows computes the
whole edge update and the destination aggregation:

    dg  = mask * d_proj[recv]
    h0  = e @ W_e + sg + dg;   z = relu(h0);   z = relu(z @ W_i + b_i) ...
    e'  = e + LayerNorm(z @ W_out + b_out)      (fp32 statistics)
    agg[n] = sum_{recv(e) = n} mask * e'

``fused_edge_layer`` launches ``csrc/fused_edge_fwd.cu`` on CUDA tensors
and runs ``fused_edge_layer_ref`` on CPU tensors. Pad-edge rows of e' are
never observed (every consumer masks by edge_mask); agg is defined on every
row, with exact zeros for nodes without a real edge.
"""

from __future__ import annotations

import ctypes

import torch

from aero_gnn_tpu_torch.graph.padded import ALIGN_EDGE_TILE, ALIGN_NODE_BLOCK
from aero_gnn_tpu_torch.nn.mlp import layer_norm
from aero_gnn_tpu_torch.ops import _build
from aero_gnn_tpu_torch.ops.scatter import gather_receivers, segment_sum_sorted

NB = ALIGN_NODE_BLOCK
ET = ALIGN_EDGE_TILE
KERNEL_WIDTHS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_P] * 14 + [_I64, _I64, _I, _I, _I, _I, _I, _P]


def fused_edge_layer_ref(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                         b_out, ln_scale, ln_bias, num_nodes: int):
    """Plain PyTorch composition of the fused edge layer, in the order of
    the JAX package's _equiv (pallas_fused.py); the segment sum of mask * e'
    accumulates in fp32 and rounds once."""
    m = mask[:, None].to(e.dtype)
    dg = gather_receivers(d_proj, receivers) * m
    z = torch.relu(e @ w_e + sg + dg)
    for i in range(ws.shape[0]):
        z = torch.relu(z @ ws[i] + bs[i])
    de = z @ w_out + b_out
    e_new = e + layer_norm(de, ln_scale, ln_bias)
    agg = segment_sum_sorted(e_new * m, receivers, num_nodes)
    return e_new, agg


def fused_edge_layer(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                     b_out, ln_scale, ln_bias, num_nodes: int,
                     activation: str = "relu"):
    """(e', agg) of the fused edge layer. CUDA tensors launch kernel K1;
    CPU tensors run the plain version. Forward only."""
    if activation != "relu":
        raise ValueError("fused edge layer supports relu (the reference "
                         "hardcodes ReLU in EdgeBlockSum)")
    if not e.is_cuda:
        return fused_edge_layer_ref(e, sg, d_proj, mask, receivers, w_e, ws,
                                    bs, w_out, b_out, ln_scale, ln_bias,
                                    num_nodes)
    n_edges, h = e.shape
    n_hidden = ws.shape[0]
    if e.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused edge kernel takes float32 or bfloat16, "
                         f"not {e.dtype}")
    if h not in KERNEL_WIDTHS:
        raise ValueError(f"fused edge kernel takes h in {KERNEL_WIDTHS}, "
                         f"not {h}")
    if n_edges == 0 or n_edges % ET or num_nodes % NB:
        raise ValueError(
            f"fused edge kernel needs the block-aligned layout: E={n_edges} "
            f"a positive multiple of {ET}, N={num_nodes} a multiple of {NB}")
    shapes = {"sg": (sg, (n_edges, h)), "d_proj": (d_proj, (num_nodes, h)),
              "mask": (mask, (n_edges,)), "receivers": (receivers, (n_edges,)),
              "w_e": (w_e, (h, h)), "ws": (ws, (n_hidden, h, h)),
              "bs": (bs, (n_hidden, h)), "w_out": (w_out, (h, h)),
              "b_out": (b_out, (h,)), "ln_scale": (ln_scale, (h,)),
              "ln_bias": (ln_bias, (h,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    floats = dict(e=e, sg=sg, d_proj=d_proj, mask=mask, w_e=w_e, ws=ws, bs=bs,
                  w_out=w_out, b_out=b_out, ln_scale=ln_scale,
                  ln_bias=ln_bias)
    _build.check_tensors(e.device, e.dtype, **floats)
    _build.check_tensors(e.device, torch.int32, receivers=receivers)

    e_out = torch.empty_like(e)
    agg = torch.empty((num_nodes, h), dtype=e.dtype, device=e.device)
    fn = _build.c_function("fused_edge_fwd", "aero_fused_edge_fwd",
                           _ARGTYPES)
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream(e.device).cuda_stream
        err = fn(e.data_ptr(), sg.data_ptr(), d_proj.data_ptr(),
                 mask.data_ptr(), receivers.data_ptr(), w_e.data_ptr(),
                 ws.data_ptr(), bs.data_ptr(), w_out.data_ptr(),
                 b_out.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                 e_out.data_ptr(), agg.data_ptr(), n_edges, num_nodes, h,
                 n_hidden, NB, ET, _DTYPE_CODE[e.dtype], stream)
    _build.check_launch("aero_fused_edge_fwd", err)
    fused_edge_layer.launches += 1
    return e_out, agg


# launches of kernel K1 since the count was last set to 0
fused_edge_layer.launches = 0
