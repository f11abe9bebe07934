"""Fused node block + residual: Hopper kernels K3 (forward) and K4
(backward) with their plain versions (counterpart of
aero_gnn_tpu.ops.pallas_node).

    z  = relu(x @ W1x + agg @ W1a + b1)    (concat first linear, split)
    z  = relu(z @ W_i + b_i) ...           (square hidden chain)
    x' = x + LayerNorm(z @ W_out + b_out)  (fp32 statistics)

``fused_node_layer`` launches ``csrc/fused_node_fwd.cu`` on CUDA tensors
and runs ``fused_node_layer_ref`` on CPU tensors; ``fused_node_layer_bwd``
launches ``csrc/fused_node_bwd.cu`` / runs ``fused_node_layer_bwd_ref``.
``fused_node_layer_autograd`` is the differentiable layer (forward K3,
backward K4), saving the layer's inputs only, as ``_fnl_fwd`` does.

K3 is a barrier-free row kernel (``csrc/node_fwd_rows.cuh``, on the
machinery of ``csrc/rows_bwd.cuh``) that reads the weights as they lie;
``node_fwd_plan`` plans its grid and shared memory. K4 is the same kind of
row kernel plus a split-K weight-gradient kernel
(``csrc/node_bwd_rows.cuh``); ``node_bwd_plan`` lays out its launch and
workspace and ``_build.edge_bwd_operands`` its weights.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aero_gnn_tpu_torch.nn.mlp import LN_EPS, layer_norm
from aero_gnn_tpu_torch.ops import _build
from aero_gnn_tpu_torch.utils.profiling import count

ROW_CHUNK = 128  # rows per CTA step of the kernels
KERNEL_WIDTHS = (64, 128)
# the rows of a weight-gradient slab (csrc/rows_bwd.cuh kSlab)
DW_SLAB = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I64, _I, _I, _I, _I, _I, _P]
_BWD_ARGTYPES = [_P] * 12 + [_I64, _I64, _I, _I, _I, _I, _I, _P]


def _first_linear(x, agg, w1x, w1a):
    return torch.cat([x, agg], dim=-1) @ torch.cat([w1x, w1a], dim=0)


def fused_node_layer_ref(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                         ln_scale, ln_bias):
    """Plain PyTorch composition, in the order of the JAX package's _equiv
    (pallas_node.py), except that x @ W1x + agg @ W1a is one product of the
    concatenations, summed before one rounding as the kernels, the TPU
    kernel and the unfused node block do (_equiv rounds each product)."""
    z = torch.relu(_first_linear(x, agg, w1x, w1a) + b1)
    for i in range(ws.shape[0]):
        z = torch.relu(z @ ws[i] + bs[i])
    d = z @ w_out + b_out
    return x + layer_norm(d, ln_scale, ln_bias)


def fused_node_layer_bwd_ref(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                             ln_scale, ln_bias, ct):
    """Plain VJP of the fused node layer for the cotangent ct of x', in the
    order of the JAX package's backward kernel (pallas_node.py:211-265).
    Returns (d_x, d_agg, dW1x, dW1a, db1, dWs, dbs, dW_out, db_out, dscale,
    dbias), the weight gradients in fp32."""
    dt, h, nh = x.dtype, x.shape[1], ws.shape[0]
    acts = [torch.relu(_first_linear(x, agg, w1x, w1a) + b1)]
    for i in range(nh):
        acts.append(torch.relu(acts[-1] @ ws[i] + bs[i]))
    d32 = (acts[-1] @ w_out + b_out).float()
    mu = d32.mean(-1, keepdim=True)
    inv = torch.rsqrt((d32 - mu).square().mean(-1, keepdim=True) + LN_EPS)
    xn = (d32 - mu) * inv
    ct32 = ct.float()
    g = ct32 * ln_scale.float()
    d_d = ((g - g.mean(-1, keepdim=True)
            - xn * (g * xn).mean(-1, keepdim=True)) * inv).to(dt)
    dscale, dbias = (ct32 * xn).sum(0), ct32.sum(0)
    dwo, dbo = acts[-1].float().T @ d_d.float(), d_d.float().sum(0)
    dz = (d_d @ w_out.T) * (acts[-1] > 0).to(dt)
    dws = torch.zeros((nh, h, h), dtype=torch.float32, device=x.device)
    dbs = torch.zeros((nh, h), dtype=torch.float32, device=x.device)
    for i in reversed(range(nh)):
        dws[i] = acts[i].float().T @ dz.float()
        dbs[i] = dz.float().sum(0)
        dz = (dz @ ws[i].T) * (acts[i] > 0).to(dt)
    dz32 = dz.float()
    return (ct + dz @ w1x.T, dz @ w1a.T, x.float().T @ dz32,
            agg.float().T @ dz32, dz32.sum(0), dws, dbs, dwo, dbo, dscale,
            dbias)


def _check_args(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out, ln_scale,
                ln_bias, **cotangents):
    """Validate the layer's tensors for the kernels; returns (N, h, nh)."""
    n, h = x.shape
    n_hidden = ws.shape[0]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused node kernel takes float32 or bfloat16, "
                         f"not {x.dtype}")
    if h not in KERNEL_WIDTHS:
        raise ValueError(f"fused node kernel takes h in {KERNEL_WIDTHS}, "
                         f"not {h}")
    if n % ROW_CHUNK or n == 0:
        raise ValueError(f"fused node kernel needs N a positive multiple of "
                         f"{ROW_CHUNK}, got N={n}")
    shapes = {"agg": (agg, (n, h)), "w1x": (w1x, (h, h)),
              "w1a": (w1a, (h, h)), "b1": (b1, (h,)),
              "ws": (ws, (n_hidden, h, h)), "bs": (bs, (n_hidden, h)),
              "w_out": (w_out, (h, h)), "b_out": (b_out, (h,)),
              "ln_scale": (ln_scale, (h,)), "ln_bias": (ln_bias, (h,))}
    shapes.update({k: (v, (n, h)) for k, v in cotangents.items()})
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    _build.check_tensors(x.device, x.dtype, x=x, agg=agg, w1x=w1x, w1a=w1a,
                         b1=b1, ws=ws, bs=bs, w_out=w_out, b_out=b_out,
                         ln_scale=ln_scale, ln_bias=ln_bias, **cotangents)
    return n, h, n_hidden


def node_fwd_plan(n_rows: int, h: int, n_hidden: int, dtype, sm_count: int,
                  max_smem: int) -> dict:
    """K3's launch plan (csrc/node_fwd_rows.cuh, which checks it against its
    own reckoning): ``grid`` CTAs (one per SM, at most one per 128-row
    chunk of ``n_chunks``); ``resident``: the n_hidden + 3 weights stay in
    shared memory for the CTA's life (``smem_bytes`` of the ``max_smem`` a
    CTA may have), else they stream through a ring of two slots; fp32 adds
    the warps' A operand slices."""
    return dict(_node_fwd_plan(n_rows, h, n_hidden, dtype, sm_count,
                               max_smem))


@functools.lru_cache(maxsize=64)
def _node_fwd_plan(n_rows, h, n_hidden, dtype, sm_count, max_smem):
    if n_rows <= 0 or n_rows % ROW_CHUNK:
        raise ValueError(f"K3 takes a positive multiple of {ROW_CHUNK} rows, "
                         f"not {n_rows}")
    if n_hidden < 0:
        raise ValueError(f"K3 takes 0 or more hidden layers, not {n_hidden}")
    isz = torch.finfo(dtype).bits // 8
    n_chunks = n_rows // ROW_CHUNK
    # csrc/chain.cuh Layout: [h][ld] weight tiles, rows padded by 16 bytes;
    # rows_bwd.cuh fwd_rows_smem
    ld = h + 16 // isz
    mat = h * ld * isz
    fixed = ROW_CHUNK * ld * 4 if isz == 4 else 0
    resident = (n_hidden + 3) * mat + fixed <= max_smem
    smem = (n_hidden + 3 if resident else 2) * mat + fixed
    if smem > max_smem:
        raise ValueError(f"K3 at h={h} needs {smem} bytes of shared memory, "
                         f"more than {max_smem}")
    return {"grid": max(1, min(sm_count, n_chunks)), "n_chunks": n_chunks,
            "resident": resident, "smem_bytes": smem}


def fused_node_layer(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out, ln_scale,
                     ln_bias):
    """x + LN(MLP([x, agg])). CUDA tensors launch kernel K3; CPU tensors run
    the plain version. No autograd (see fused_node_layer_autograd)."""
    if not x.is_cuda:
        return fused_node_layer_ref(x, agg, w1x, w1a, b1, ws, bs, w_out,
                                    b_out, ln_scale, ln_bias)
    n, h, n_hidden = _check_args(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                                 ln_scale, ln_bias)
    plan = _node_fwd_plan(n, h, n_hidden, x.dtype,
                          *_build.device_limits(x.device))
    out = torch.empty_like(x)
    fn = _build.c_function("fused_node_fwd", "aero_fused_node_fwd",
                           _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), agg.data_ptr(), w1x.data_ptr(),
                 w1a.data_ptr(), b1.data_ptr(), ws.data_ptr(), bs.data_ptr(),
                 w_out.data_ptr(), b_out.data_ptr(), ln_scale.data_ptr(),
                 ln_bias.data_ptr(), out.data_ptr(), n, h, n_hidden,
                 plan["grid"], int(plan["resident"]), _DTYPE_CODE[x.dtype],
                 stream)
    _build.check_launch("aero_fused_node_fwd", err)
    count("launch.K3")
    return out


def node_bwd_plan(n_rows: int, h: int, n_hidden: int, dtype, sm_count: int,
                  max_smem: int) -> dict:
    """K4's launch plan (csrc/node_bwd_rows.cuh, which checks it):
    ``grid`` CTAs for the row and the weight-gradient kernels (one per SM,
    at most one per 128-row chunk), each with a fp32 partial of
    ``part_len`` = (n_hidden + 3) h^2 + (n_hidden + 4) h floats at the
    front of the workspace (padded to 256 bytes), then the activations
    a(0..n_hidden) at ``acts_offset`` and the cotangents dz(0..n_hidden),
    d_d at ``cots_offset``, each [n_rows, h] of ``dtype``; ``ws_bytes`` in
    all. ``resident``: the row kernel keeps every weight in shared memory
    (``smem_bytes`` of the ``max_smem`` a CTA may have) rather than
    streaming them through a ring of two slots; ``dw_smem_bytes`` the
    weight-gradient kernel's."""
    return dict(_node_bwd_plan(n_rows, h, n_hidden, dtype, sm_count,
                               max_smem))


@functools.lru_cache(maxsize=64)
def _node_bwd_plan(n_rows, h, n_hidden, dtype, sm_count, max_smem):
    if n_rows <= 0 or n_rows % ROW_CHUNK:
        raise ValueError(f"K4 takes a positive multiple of {ROW_CHUNK} rows, "
                         f"not {n_rows}")
    if n_hidden < 0:
        raise ValueError(f"K4 takes 0 or more hidden layers, not {n_hidden}")
    isz = torch.finfo(dtype).bits // 8
    n_chunks = n_rows // ROW_CHUNK
    grid = max(1, min(sm_count, n_chunks))
    part_len = (n_hidden + 3) * h * h + (n_hidden + 4) * h
    part_bytes = -(-grid * part_len * 4 // 256) * 256
    act_bytes = (n_hidden + 1) * n_rows * h * isz
    # csrc/chain.cuh Layout (rows padded by 16 bytes) and rows_bwd.cuh
    # rows_fixed_smem / dw_smem: fp32 stages the A operands ([128][ld]);
    # both keep the warps' LayerNorm column sums ([2][2][8][h] fp32)
    ld = h + 16 // isz
    mat = h * ld * isz
    fixed = (ROW_CHUNK * ld * 4 if isz == 4 else 0) + 2 * 2 * 8 * h * 4
    n_stored = (n_hidden + 3) * (2 if isz == 4 else 1)
    resident = n_stored * mat + fixed <= max_smem
    smem = (n_stored if resident else 2) * mat + fixed
    dw_smem = 2 * 2 * DW_SLAB * ld * isz
    if max(smem, dw_smem) > max_smem:
        raise ValueError(f"K4 at h={h} needs {max(smem, dw_smem)} bytes of "
                         f"shared memory, more than {max_smem}")
    return {"grid": grid, "n_chunks": n_chunks, "part_len": part_len,
            "acts_offset": part_bytes, "cots_offset": part_bytes + act_bytes,
            "ws_bytes": part_bytes + act_bytes
            + (n_hidden + 2) * n_rows * h * isz,
            "resident": resident, "smem_bytes": smem,
            "dw_smem_bytes": dw_smem}


def fused_node_layer_bwd(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                         ln_scale, ln_bias, ct):
    """VJP of the fused node layer: (d_x, d_agg, dW1x, dW1a, db1, dWs, dbs,
    dW_out, db_out, dscale, dbias), the weight gradients in fp32. CUDA
    tensors launch kernel K4 (deterministic: per-split partials summed in a
    fixed order); CPU tensors run the plain version."""
    if not x.is_cuda:
        return fused_node_layer_bwd_ref(x, agg, w1x, w1a, b1, ws, bs, w_out,
                                        b_out, ln_scale, ln_bias, ct)
    n, h, nh = _check_args(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                           ln_scale, ln_bias, ct=ct)
    dev = x.device
    plan = node_bwd_plan(n, h, nh, x.dtype, *_build.device_limits(dev))
    wb = _build.edge_bwd_operands([w1x, w1a, ws, w_out])
    d_x, d_agg = torch.empty_like(x), torch.empty_like(x)
    n_mat = (nh + 3) * h * h
    dw = torch.empty(n_mat + (nh + 4) * h, dtype=torch.float32, device=dev)
    workspace = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=dev)
    fn = _build.c_function("fused_node_bwd", "aero_fused_node_bwd",
                           _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in (
                     x, agg, wb, b1, bs, b_out, ln_scale, ct, d_x, d_agg, dw,
                     workspace)],
                 plan["ws_bytes"], n, h, nh, plan["grid"],
                 int(plan["resident"]), _DTYPE_CODE[x.dtype], stream)
    _build.check_launch("aero_fused_node_bwd", err)
    count("launch.K4")
    mats = dw[:n_mat].view(nh + 3, h, h)
    vecs = dw[n_mat:].view(nh + 4, h)
    return (d_x, d_agg, mats[0], mats[1], vecs[3], mats[2:nh + 2], vecs[4:],
            mats[nh + 2], vecs[0], vecs[1], vecs[2])


class _FusedNodeLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, agg, w1x, w1a, b1, ws, bs, w_out, b_out, ln_scale,
                ln_bias):
        ctx.save_for_backward(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                              ln_scale, ln_bias)
        return fused_node_layer(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                                ln_scale, ln_bias)

    @staticmethod
    def backward(ctx, ct):
        saved = ctx.saved_tensors
        grads = fused_node_layer_bwd(*saved, ct.contiguous())
        # weight gradients rounded to the weights' (compute) dtype, as the
        # JAX package's _fnl_bwd returns them
        wgrads = [g.to(w.dtype) for g, w in zip(grads[2:], saved[2:])]
        return (grads[0], grads[1], *wgrads)


def fused_node_layer_autograd(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                              ln_scale, ln_bias):
    """The differentiable fused node layer: x' by K3, its backward by K4
    (the plain versions on CPU tensors)."""
    return _FusedNodeLayer.apply(x, agg, w1x, w1a, b1, ws, bs, w_out, b_out,
                                 ln_scale, ln_bias)
