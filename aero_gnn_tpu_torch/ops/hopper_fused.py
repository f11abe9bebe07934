"""Fused concat-trick edge layer: Hopper kernels K1 (forward) and K2
(backward) with their plain versions (counterpart of
aero_gnn_tpu.ops.pallas_fused).

One pass over the receiver-sorted, block-aligned edge rows computes the
whole edge update and the destination aggregation:

    dg  = mask * d_proj[recv]
    h0  = e @ W_e + sg + dg;   z = relu(h0);   z = relu(z @ W_i + b_i) ...
    e'  = e + LayerNorm(z @ W_out + b_out)      (fp32 statistics)
    agg[n] = sum_{recv(e) = n} mask * e'

``fused_edge_layer`` launches ``csrc/fused_edge_fwd.cu`` on CUDA tensors
and runs ``fused_edge_layer_ref`` on CPU tensors; ``fused_edge_layer_bwd``
launches ``csrc/fused_edge_bwd.cu`` / runs ``fused_edge_layer_bwd_ref``.
Both raw wrappers have no autograd; ``fused_edge_layer_autograd`` is the
differentiable layer (forward K1, backward K2), saving the layer's inputs
only, as the JAX package's ``_fel_fwd`` does. Pad-edge rows of e' are never
observed (every consumer masks by edge_mask); agg is defined on every row,
with exact zeros for nodes without a real edge.

The kernels skip pad tiles, tiles whose first row is masked (in the
aligned layout those hold pad rows only: an empty node block's alignment
tile, and the pad-sink tail a Loader batch leaves after its stream, which
would otherwise all fall to the last node block's CTA), and fill their rows
across the grid: e' = e (a zero update), d_e = ct_e and d_sg = 0, which is
the VJP wherever the cotangent of pad rows is zero, as it is on the
training path. The plain versions compute every row.
"""

from __future__ import annotations

import ctypes

import torch

from aero_gnn_tpu_torch.graph.padded import ALIGN_EDGE_TILE, ALIGN_NODE_BLOCK
from aero_gnn_tpu_torch.nn.mlp import LN_EPS, layer_norm
from aero_gnn_tpu_torch.ops import _build
from aero_gnn_tpu_torch.ops.hopper_segment import segment_sum_ref
from aero_gnn_tpu_torch.ops.scatter import gather

NB = ALIGN_NODE_BLOCK
ET = ALIGN_EDGE_TILE
KERNEL_WIDTHS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_P] * 14 + [_I64, _I64, _I, _I, _I, _I, _I, _P]
_BWD_ARGTYPES = [_P] * 16 + [_I64, _I64, _I64, _I, _I, _I, _I, _I, _P]
_WS_ARGTYPES = [_I64, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int64)]


def fused_edge_layer_ref(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                         b_out, ln_scale, ln_bias, num_nodes: int):
    """Plain PyTorch composition of the fused edge layer, in the order of
    the JAX package's _equiv (pallas_fused.py); the segment sum of mask * e'
    accumulates in fp32 and rounds once."""
    m = mask[:, None].to(e.dtype)
    dg = gather(d_proj, receivers) * m
    z = torch.relu(e @ w_e + sg + dg)
    for i in range(ws.shape[0]):
        z = torch.relu(z @ ws[i] + bs[i])
    de = z @ w_out + b_out
    e_new = e + layer_norm(de, ln_scale, ln_bias)
    agg = segment_sum_ref(e_new * m, receivers, num_nodes)
    return e_new, agg


def fused_edge_layer_bwd_ref(e, sg, d_proj, mask, receivers, w_e, ws, bs,
                             w_out, b_out, ln_scale, ln_bias, ct_e, ct_agg,
                             num_nodes: int):
    """Plain VJP of the fused edge layer for the cotangents (ct_e, ct_agg),
    in the order of the JAX package's fused backward kernel
    (pallas_fused.py:653-696): the chain recomputed, LayerNorm backward in
    fp32, every product rounded to the compute type, weight gradients in
    fp32. Returns (d_e, d_sg, d_dproj, dW_e, dWs, dbs, dW_out, db_out,
    dscale, dbias)."""
    dt, h, nh = e.dtype, e.shape[1], ws.shape[0]
    m = mask[:, None].to(dt)
    acts = [torch.relu(e @ w_e + sg + gather(d_proj, receivers) * m)]
    for i in range(nh):
        acts.append(torch.relu(acts[-1] @ ws[i] + bs[i]))
    d32 = (acts[-1] @ w_out + b_out).float()
    mu = d32.mean(-1, keepdim=True)
    inv = torch.rsqrt((d32 - mu).square().mean(-1, keepdim=True) + LN_EPS)
    xn = (d32 - mu) * inv
    ct = ct_e + gather(ct_agg, receivers) * m
    ct32 = ct.float()
    g = ct32 * ln_scale.float()
    d_d = ((g - g.mean(-1, keepdim=True)
            - xn * (g * xn).mean(-1, keepdim=True)) * inv).to(dt)
    dscale, dbias = (ct32 * xn).sum(0), ct32.sum(0)
    dwo, dbo = acts[-1].float().T @ d_d.float(), d_d.float().sum(0)
    dz = (d_d @ w_out.T) * (acts[-1] > 0).to(dt)
    dws = torch.zeros((nh, h, h), dtype=torch.float32, device=e.device)
    dbs = torch.zeros((nh, h), dtype=torch.float32, device=e.device)
    for i in reversed(range(nh)):
        dws[i] = acts[i].float().T @ dz.float()
        dbs[i] = dz.float().sum(0)
        dz = (dz @ ws[i].T) * (acts[i] > 0).to(dt)
    dwe = e.float().T @ dz.float()
    d_e = ct + dz @ w_e.T
    d_dproj = segment_sum_ref(dz * m, receivers, num_nodes)
    return d_e, dz, d_dproj, dwe, dws, dbs, dwo, dbo, dscale, dbias


def _check_args(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out, b_out,
                ln_scale, ln_bias, num_nodes, **cotangents):
    """Validate the layer's tensors for the kernels; returns (E, h, nh)."""
    n_edges, h = e.shape
    n_hidden = ws.shape[0]
    if e.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused edge kernel takes float32 or bfloat16, "
                         f"not {e.dtype}")
    if h not in KERNEL_WIDTHS:
        raise ValueError(f"fused edge kernel takes h in {KERNEL_WIDTHS}, "
                         f"not {h}")
    if n_edges == 0 or n_edges % ET or num_nodes % NB or num_nodes == 0:
        raise ValueError(
            f"fused edge kernel needs the block-aligned layout: E={n_edges} "
            f"a positive multiple of {ET}, N={num_nodes} a positive multiple "
            f"of {NB}")
    shapes = {"sg": (sg, (n_edges, h)), "d_proj": (d_proj, (num_nodes, h)),
              "mask": (mask, (n_edges,)), "receivers": (receivers, (n_edges,)),
              "w_e": (w_e, (h, h)), "ws": (ws, (n_hidden, h, h)),
              "bs": (bs, (n_hidden, h)), "w_out": (w_out, (h, h)),
              "b_out": (b_out, (h,)), "ln_scale": (ln_scale, (h,)),
              "ln_bias": (ln_bias, (h,))}
    shapes.update({k: (v, (num_nodes if k == "ct_agg" else n_edges, h))
                   for k, v in cotangents.items()})
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    floats = dict(e=e, sg=sg, d_proj=d_proj, mask=mask, w_e=w_e, ws=ws, bs=bs,
                  w_out=w_out, b_out=b_out, ln_scale=ln_scale,
                  ln_bias=ln_bias, **cotangents)
    _build.check_tensors(e.device, e.dtype, **floats)
    _build.check_tensors(e.device, torch.int32, receivers=receivers)
    return n_edges, h, n_hidden


def fused_edge_layer(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                     b_out, ln_scale, ln_bias, num_nodes: int,
                     activation: str = "relu"):
    """(e', agg) of the fused edge layer. CUDA tensors launch kernel K1;
    CPU tensors run the plain version. No autograd (see
    fused_edge_layer_autograd)."""
    if activation != "relu":
        raise ValueError("fused edge layer supports relu (the reference "
                         "hardcodes ReLU in EdgeBlockSum)")
    if not e.is_cuda:
        return fused_edge_layer_ref(e, sg, d_proj, mask, receivers, w_e, ws,
                                    bs, w_out, b_out, ln_scale, ln_bias,
                                    num_nodes)
    n_edges, h, n_hidden = _check_args(e, sg, d_proj, mask, receivers, w_e,
                                       ws, bs, w_out, b_out, ln_scale,
                                       ln_bias, num_nodes)
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


def fused_edge_layer_bwd(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                         b_out, ln_scale, ln_bias, ct_e, ct_agg,
                         num_nodes: int):
    """VJP of the fused edge layer: (d_e, d_sg, d_dproj, dW_e, dWs, dbs,
    dW_out, db_out, dscale, dbias), the weight gradients in fp32. CUDA
    tensors launch kernel K2 (deterministic: per-CTA partials summed in a
    fixed order); CPU tensors run the plain version."""
    if not e.is_cuda:
        return fused_edge_layer_bwd_ref(e, sg, d_proj, mask, receivers, w_e,
                                        ws, bs, w_out, b_out, ln_scale,
                                        ln_bias, ct_e, ct_agg, num_nodes)
    n_edges, h, nh = _check_args(e, sg, d_proj, mask, receivers, w_e, ws,
                                 bs, w_out, b_out, ln_scale, ln_bias,
                                 num_nodes, ct_e=ct_e, ct_agg=ct_agg)
    code = _DTYPE_CODE[e.dtype]
    ws_bytes = ctypes.c_int64(0)
    ws_fn = _build.c_function("fused_edge_bwd",
                              "aero_fused_edge_bwd_workspace", _WS_ARGTYPES)
    with torch.cuda.device(e.device):
        _build.check_launch("aero_fused_edge_bwd_workspace",
                            ws_fn(num_nodes, h, nh, NB, code,
                                  ctypes.byref(ws_bytes)))
        workspace = torch.empty(ws_bytes.value, dtype=torch.uint8,
                                device=e.device)
        d_e, d_sg = torch.empty_like(e), torch.empty_like(e)
        d_dproj = torch.empty((num_nodes, h), dtype=e.dtype, device=e.device)
        n_mat = (nh + 2) * h * h
        dw = torch.empty(n_mat + (nh + 3) * h, dtype=torch.float32,
                         device=e.device)
        fn = _build.c_function("fused_edge_bwd", "aero_fused_edge_bwd",
                               _BWD_ARGTYPES)
        wb = _build.mma_b_operands([w_e, ws, w_out])
        stream = torch.cuda.current_stream(e.device).cuda_stream
        err = fn(e.data_ptr(), sg.data_ptr(), d_proj.data_ptr(),
                 mask.data_ptr(), receivers.data_ptr(), wb.data_ptr(),
                 bs.data_ptr(), b_out.data_ptr(), ln_scale.data_ptr(),
                 ct_e.data_ptr(), ct_agg.data_ptr(), d_e.data_ptr(),
                 d_sg.data_ptr(),
                 d_dproj.data_ptr(), dw.data_ptr(), workspace.data_ptr(),
                 ws_bytes.value, n_edges, num_nodes, h, nh, NB, ET, code,
                 stream)
    _build.check_launch("aero_fused_edge_bwd", err)
    fused_edge_layer_bwd.launches += 1
    mats = dw[:n_mat].view(nh + 2, h, h)
    vecs = dw[n_mat:].view(nh + 3, h)
    return (d_e, d_sg, d_dproj, mats[0], mats[1:nh + 1], vecs[3:],
            mats[nh + 1], vecs[0], vecs[1], vecs[2])


# launches of kernels K1 / K2 since the counts were last set to 0
fused_edge_layer.launches = 0
fused_edge_layer_bwd.launches = 0


class _FusedEdgeLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                b_out, ln_scale, ln_bias, num_nodes):
        ctx.save_for_backward(e, sg, d_proj, mask, receivers, w_e, ws, bs,
                              w_out, b_out, ln_scale, ln_bias)
        ctx.num_nodes = num_nodes
        return fused_edge_layer(e, sg, d_proj, mask, receivers, w_e, ws, bs,
                                w_out, b_out, ln_scale, ln_bias, num_nodes)

    @staticmethod
    def backward(ctx, ct_e, ct_agg):
        saved = ctx.saved_tensors
        grads = fused_edge_layer_bwd(*saved, ct_e.contiguous(),
                                     ct_agg.contiguous(), ctx.num_nodes)
        d_e, d_sg, d_dproj = grads[:3]
        # weight gradients rounded to the weights' (compute) dtype, as the
        # JAX package's _fused_bwd returns them
        wgrads = [g.to(w.dtype) for g, w in zip(grads[3:], saved[5:])]
        return (d_e, d_sg, d_dproj, None, None, *wgrads, None)


def fused_edge_layer_autograd(e, sg, d_proj, mask, receivers, w_e, ws, bs,
                              w_out, b_out, ln_scale, ln_bias,
                              num_nodes: int, activation: str = "relu"):
    """The differentiable fused edge layer: (e', agg) by K1 (plain version
    on CPU tensors); its backward by K2 (plain version on CPU tensors)."""
    if activation != "relu":
        raise ValueError("fused edge layer supports relu (the reference "
                         "hardcodes ReLU in EdgeBlockSum)")
    return _FusedEdgeLayer.apply(e, sg, d_proj, mask, receivers, w_e, ws, bs,
                                 w_out, b_out, ln_scale, ln_bias, num_nodes)
