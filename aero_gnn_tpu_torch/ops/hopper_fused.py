"""Fused concat-trick edge layer: Hopper kernels K1 (forward, and its save
variant), K2 (backward) and K8 (backward from saved activations) with their
plain versions (counterpart of aero_gnn_tpu.ops.pallas_fused).

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

With ``AERO_GNN_SAVE_ACTS=1`` (``save_acts_enabled``, read at call time,
off by default as in JAX) a differentiable call that needs a gradient runs
the save variant of K1 (``fused_edge_layer_save``), which also writes the
post-ReLU activations zs [n_hidden + 1, E, h], the rounded pre-LayerNorm
output d [E, h] and its fp32 statistics mu, inv [E], and saves those with
e instead of sg / d_proj; its backward is K8
(``fused_edge_layer_bwd_saved``, ``csrc/fused_edge_bwd_saved.cu``), which
starts at the LayerNorm backward instead of recomputing the chain. Serving
(no gradient) keeps K1.

The kernels skip pad tiles, tiles whose first row is masked (in the
aligned layout those hold pad rows only: an empty node block's alignment
tile, and the pad-sink tail a Loader batch leaves after its stream, which
would otherwise all fall to the last node block's CTA), and fill their rows
across the grid: e' = e (a zero update), d_e = ct_e and d_sg = 0, which is
the VJP wherever the cotangent of pad rows is zero, as it is on the
training path. The save variant leaves the saved rows of pad tiles
unwritten, and K8 skips the same tiles. The plain versions compute every
row. K2 sums d_dproj with the pad sink declared (``graph.padded`` reserves
the last node as the sink of the pad rows, so it has no real edge and its
row is 0).

K1 runs as a row kernel (each warp's 16 rows through the whole chain
without a CTA barrier, the weights read as they lie) and K5's segmented
sum over e' for agg (``csrc/edge_fwd_rows.cuh``); ``edge_fwd_plan`` plans
its grid, shared memory and the row pointer's workspace. K2 runs as a row
kernel, a segmented sum for d_dproj and a split-K weight-gradient kernel
(``csrc/edge_bwd_rows.cuh``), at any depth; ``edge_bwd_plan`` lays out its
workspace and ``_build.edge_bwd_operands`` its weights (in bf16 one copy
each). K8 runs K2's three kernels without the forward recompute (the
row kernel's masks read from zs, the weight-gradient kernel reading zs),
on K2's grid, so its ten outputs are K2's bit for bit;
``edge_bwd_saved_plan`` plans it (no activation workspace; the weights
resident or in the ring) and ``_build.bwd_only_operands`` lays out the
W^T its backward products read.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from aero_gnn_tpu_torch.graph.padded import ALIGN_EDGE_TILE, ALIGN_NODE_BLOCK
from aero_gnn_tpu_torch.nn.mlp import LN_EPS
from aero_gnn_tpu_torch.ops import _build
from aero_gnn_tpu_torch.ops.hopper_node import DW_SLAB
from aero_gnn_tpu_torch.ops.hopper_segment import segment_sum_ref
from aero_gnn_tpu_torch.ops.scatter import gather
from aero_gnn_tpu_torch.utils.profiling import count

NB = ALIGN_NODE_BLOCK
ET = ALIGN_EDGE_TILE
KERNEL_WIDTHS = (64, 128)
# the row kernels' chunk: 8 warps of 16 rows (csrc/chain.cuh kRows)
CHUNK_ROWS = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_P] * 19 + [_I64, _I64, _I64, _I, _I, _I, _I, _I, _I, _P]
_BWD_ARGTYPES = [_P] * 16 + [_I64, _I64, _I64, _I, _I, _I, _I, _I, _P]
_SAVED_ARGTYPES = [_P] * 16 + [_I64, _I64, _I64] + [_I] * 6 + [_P]


def save_acts_enabled() -> bool:
    """AERO_GNN_SAVE_ACTS=1: a differentiable call that needs a gradient
    runs the save variant of K1 and its backward on K8 (module docstring).
    Read at call time; off by default, as the JAX package's
    pallas_fused.save_acts_enabled."""
    return os.environ.get("AERO_GNN_SAVE_ACTS", "0") == "1"


def fused_edge_layer_save_ref(e, sg, d_proj, mask, receivers, w_e, ws, bs,
                              w_out, b_out, ln_scale, ln_bias,
                              num_nodes: int):
    """Plain version of the save variant: (e', agg, zs, d, mu, inv), in the
    order of the JAX package's _equiv (pallas_fused.py). zs [n_hidden + 1,
    E, h] are the post-ReLU activations, d = z @ W_out + b_out in the
    compute type, mu / inv [E] its fp32 mean and 1 / sqrt(var + eps)
    (two-pass); the segment sum of mask * e' accumulates in fp32 and rounds
    once."""
    m = mask[:, None].to(e.dtype)
    zs = [torch.relu(e @ w_e + sg + gather(d_proj, receivers) * m)]
    for i in range(ws.shape[0]):
        zs.append(torch.relu(zs[-1] @ ws[i] + bs[i]))
    d = zs[-1] @ w_out + b_out
    d32 = d.float()
    mu = d32.mean(-1)
    inv = torch.rsqrt((d32 - mu[:, None]).square().mean(-1) + LN_EPS)
    xn = (d32 - mu[:, None]) * inv[:, None]
    e_new = e + (xn * ln_scale.float() + ln_bias.float()).to(e.dtype)
    agg = segment_sum_ref(e_new * m, receivers, num_nodes)
    return e_new, agg, torch.stack(zs), d, mu, inv


def fused_edge_layer_ref(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                         b_out, ln_scale, ln_bias, num_nodes: int):
    """Plain PyTorch composition of the fused edge layer: (e', agg) of
    fused_edge_layer_save_ref."""
    return fused_edge_layer_save_ref(e, sg, d_proj, mask, receivers, w_e, ws,
                                     bs, w_out, b_out, ln_scale, ln_bias,
                                     num_nodes)[:2]


def fused_edge_layer_bwd_saved_ref(e, mask, receivers, w_e, ws, w_out,
                                   ln_scale, zs, d, mu, inv, ct_e, ct_agg,
                                   num_nodes: int):
    """Plain version of K8: the VJP of the fused edge layer for the
    cotangents (ct_e, ct_agg) from the save variant's zs, d, mu, inv, in the
    order of the JAX package's saved backward kernel (pallas_fused.py:
    1067-1097): xn from the saved d and statistics, LayerNorm backward in
    fp32, every product rounded to the compute type, weight gradients in
    fp32. Returns (d_e, d_sg, d_dproj, dW_e, dWs, dbs, dW_out, db_out,
    dscale, dbias)."""
    dt, h, nh = e.dtype, e.shape[1], ws.shape[0]
    m = mask[:, None].to(dt)
    xn = (d.float() - mu[:, None]) * inv[:, None]
    ct = ct_e + gather(ct_agg, receivers) * m
    ct32 = ct.float()
    g = ct32 * ln_scale.float()
    d_d = ((g - g.mean(-1, keepdim=True)
            - xn * (g * xn).mean(-1, keepdim=True)) * inv[:, None]).to(dt)
    dscale, dbias = (ct32 * xn).sum(0), ct32.sum(0)
    dwo, dbo = zs[nh].float().T @ d_d.float(), d_d.float().sum(0)
    dz = (d_d @ w_out.T) * (zs[nh] > 0).to(dt)
    dws = torch.zeros((nh, h, h), dtype=torch.float32, device=e.device)
    dbs = torch.zeros((nh, h), dtype=torch.float32, device=e.device)
    for i in reversed(range(nh)):
        dws[i] = zs[i].float().T @ dz.float()
        dbs[i] = dz.float().sum(0)
        dz = (dz @ ws[i].T) * (zs[i] > 0).to(dt)
    dwe = e.float().T @ dz.float()
    d_e = ct + dz @ w_e.T
    d_dproj = segment_sum_ref(dz * m, receivers, num_nodes)
    return d_e, dz, d_dproj, dwe, dws, dbs, dwo, dbo, dscale, dbias


def fused_edge_layer_bwd_ref(e, sg, d_proj, mask, receivers, w_e, ws, bs,
                             w_out, b_out, ln_scale, ln_bias, ct_e, ct_agg,
                             num_nodes: int):
    """Plain VJP of the fused edge layer for the cotangents (ct_e, ct_agg),
    in the order of the JAX package's fused backward kernel
    (pallas_fused.py:653-696): the chain recomputed (the save variant's
    plain version), then K8's plain version. Returns (d_e, d_sg, d_dproj,
    dW_e, dWs, dbs, dW_out, db_out, dscale, dbias)."""
    _, _, zs, d, mu, inv = fused_edge_layer_save_ref(
        e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out, b_out, ln_scale,
        ln_bias, num_nodes)
    return fused_edge_layer_bwd_saved_ref(e, mask, receivers, w_e, ws, w_out,
                                          ln_scale, zs, d, mu, inv, ct_e,
                                          ct_agg, num_nodes)


def _check_args(e, receivers, num_nodes, **tensors):
    """Validate the layer's tensors for the kernels, each by its name (its
    shape in the layout follows from e, num_nodes and ws); returns (E, h,
    n_hidden)."""
    n_edges, h = e.shape
    n_hidden = tensors["ws"].shape[0]
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
    shapes = {"sg": (n_edges, h), "d_proj": (num_nodes, h),
              "mask": (n_edges,), "w_e": (h, h), "ws": (n_hidden, h, h),
              "bs": (n_hidden, h), "w_out": (h, h), "b_out": (h,),
              "ln_scale": (h,), "ln_bias": (h,), "ct_e": (n_edges, h),
              "ct_agg": (num_nodes, h), "zs": (n_hidden + 1, n_edges, h),
              "d": (n_edges, h), "mu": (n_edges,), "inv": (n_edges,)}
    for name, t in tensors.items():
        if t.shape != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
    stats = {k: tensors.pop(k) for k in ("mu", "inv") if k in tensors}
    _build.check_tensors(e.device, e.dtype, e=e, **tensors)
    _build.check_tensors(e.device, torch.float32, **stats)
    _build.check_tensors(e.device, torch.int32, receivers=receivers)
    return n_edges, h, n_hidden


def edge_fwd_plan(n_edges: int, n_nodes: int, h: int, n_hidden: int, dtype,
                  sm_count: int, max_smem: int) -> dict:
    """K1's launch plan (csrc/edge_fwd_rows.cuh, which checks it against
    its own reckoning): ``grid`` CTAs of the row kernel (one per SM, at
    most one per 128-row chunk of ``n_chunks``); ``resident``: every
    weight stays in shared memory for the CTA's life (``smem_bytes`` of
    the ``max_smem`` a CTA may have), else the weights stream through a
    ring of two slots; fp32 adds the warps' A operand slices. The
    workspace (``ws_bytes``) holds the receiver stream's row pointer,
    n_nodes + 1 int32, for the aggregation."""
    return dict(_edge_fwd_plan(n_edges, n_nodes, h, n_hidden, dtype,
                               sm_count, max_smem))


@functools.lru_cache(maxsize=64)
def _edge_fwd_plan(n_edges, n_nodes, h, n_hidden, dtype, sm_count,
                   max_smem):
    if n_edges <= 0 or n_edges % CHUNK_ROWS:
        raise ValueError(f"K1 takes a positive multiple of {CHUNK_ROWS} edge "
                         f"rows, not {n_edges}")
    if n_nodes <= 0:
        raise ValueError(f"K1 takes a positive number of nodes, not "
                         f"{n_nodes}")
    if n_hidden < 0:
        raise ValueError(f"K1 takes 0 or more hidden layers, not {n_hidden}")
    isz = torch.finfo(dtype).bits // 8
    n_chunks = n_edges // CHUNK_ROWS
    # csrc/chain.cuh Layout: [h][ld] weight tiles, rows padded by 16 bytes
    ld = h + 16 // isz
    mat = h * ld * isz
    fixed = CHUNK_ROWS * ld * 4 if isz == 4 else 0
    resident = (n_hidden + 2) * mat + fixed <= max_smem
    smem = (n_hidden + 2 if resident else 2) * mat + fixed
    if smem > max_smem:
        raise ValueError(f"K1 at h={h} needs {smem} bytes of shared memory, "
                         f"more than {max_smem}")
    return {"grid": max(1, min(sm_count, n_chunks)), "n_chunks": n_chunks,
            "resident": resident, "smem_bytes": smem,
            "ws_bytes": 4 * (n_nodes + 1)}


def _launch_fwd(save: bool, e, sg, d_proj, mask, receivers, w_e, ws, bs,
                w_out, b_out, ln_scale, ln_bias, num_nodes: int):
    """K1 (save False: (e', agg)) or its save variant (e', agg, zs, d, mu,
    inv) on CUDA tensors."""
    n_edges, h, n_hidden = _check_args(
        e, receivers, num_nodes, sg=sg, d_proj=d_proj, mask=mask, w_e=w_e,
        ws=ws, bs=bs, w_out=w_out, b_out=b_out, ln_scale=ln_scale,
        ln_bias=ln_bias)
    dev = e.device
    plan = edge_fwd_plan(n_edges, num_nodes, h, n_hidden, e.dtype,
                         *_build.device_limits(dev))
    e_out = torch.empty_like(e)
    agg = torch.empty((num_nodes, h), dtype=e.dtype, device=dev)
    workspace = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=dev)
    saved = ()
    if save:
        saved = (torch.empty((n_hidden + 1, n_edges, h), dtype=e.dtype,
                             device=dev), torch.empty_like(e),
                 torch.empty(n_edges, dtype=torch.float32, device=dev),
                 torch.empty(n_edges, dtype=torch.float32, device=dev))
    fn = _build.c_function("fused_edge_fwd", "aero_fused_edge_fwd",
                           _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(e.data_ptr(), sg.data_ptr(), d_proj.data_ptr(),
                 mask.data_ptr(), receivers.data_ptr(), w_e.data_ptr(),
                 ws.data_ptr(), bs.data_ptr(), w_out.data_ptr(),
                 b_out.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                 e_out.data_ptr(), agg.data_ptr(),
                 *([t.data_ptr() for t in saved] or [None] * 4),
                 workspace.data_ptr(), plan["ws_bytes"], n_edges, num_nodes,
                 h, n_hidden, plan["grid"], int(plan["resident"]), ET,
                 _DTYPE_CODE[e.dtype], stream)
    _build.check_launch("aero_fused_edge_fwd", err)
    return (e_out, agg, *saved)


def fused_edge_layer(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                     b_out, ln_scale, ln_bias, num_nodes: int,
                     activation: str = "relu"):
    """(e', agg) of the fused edge layer. CUDA tensors launch kernel K1;
    CPU tensors run the plain version. No autograd (see
    fused_edge_layer_autograd)."""
    if activation != "relu":
        raise ValueError("fused edge layer supports relu (the reference "
                         "hardcodes ReLU in EdgeBlockSum)")
    args = (e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out, b_out,
            ln_scale, ln_bias, num_nodes)
    if not e.is_cuda:
        return fused_edge_layer_ref(*args)
    out = _launch_fwd(False, *args)
    count("launch.K1")
    return out


def fused_edge_layer_save(e, sg, d_proj, mask, receivers, w_e, ws, bs,
                          w_out, b_out, ln_scale, ln_bias, num_nodes: int):
    """(e', agg, zs, d, mu, inv): CUDA tensors launch the save variant of
    K1, which leaves the rows of pad tiles of zs, d, mu and inv unwritten
    (K8 never reads them); CPU tensors run the plain version. No
    autograd."""
    args = (e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out, b_out,
            ln_scale, ln_bias, num_nodes)
    if not e.is_cuda:
        return fused_edge_layer_save_ref(*args)
    out = _launch_fwd(True, *args)
    count("launch.K1-save")
    return out


def _split_grads(d_e, d_sg, d_dproj, dw, h: int, n_hidden: int):
    """The backward kernels' outputs in the plain versions' order, the fp32
    weight gradients cut from ``dw`` ([dW_e, dWs, dW_out] then [db_out,
    dscale, dbias, dbs])."""
    n_mat = (n_hidden + 2) * h * h
    mats = dw[:n_mat].view(n_hidden + 2, h, h)
    vecs = dw[n_mat:].view(n_hidden + 3, h)
    return (d_e, d_sg, d_dproj, mats[0], mats[1:n_hidden + 1], vecs[3:],
            mats[n_hidden + 1], vecs[0], vecs[1], vecs[2])


def _bwd_splits(n_edges: int, h: int, n_hidden: int, sm_count: int,
                kernel: str) -> tuple:
    """K2's and K8's grid rule: (grid, n_chunks, part_len, bytes of the
    partials padded to 256)."""
    if n_edges <= 0 or n_edges % CHUNK_ROWS:
        raise ValueError(f"{kernel} takes a positive multiple of {CHUNK_ROWS} "
                         f"edge rows, not {n_edges}")
    if n_hidden < 0:
        raise ValueError(f"{kernel} takes 0 or more hidden layers, not "
                         f"{n_hidden}")
    n_chunks = n_edges // CHUNK_ROWS
    grid = max(1, min(sm_count, n_chunks))
    part_len = (n_hidden + 2) * h * h + (n_hidden + 3) * h
    return grid, n_chunks, part_len, -(-grid * part_len * 4 // 256) * 256


def edge_bwd_plan(n_edges: int, n_nodes: int, h: int, n_hidden: int, dtype,
                  sm_count: int) -> dict:
    """K2's launch plan (csrc/edge_bwd_rows.cuh, which checks the
    workspace size against its own reckoning): ``grid`` CTAs for the row
    and the weight-gradient kernels (one per SM, at most one per 128-row
    chunk), each with a fp32 partial of ``part_len`` = (n_hidden + 2) h^2
    + (n_hidden + 3) h floats at the front of the workspace (padded to 256
    bytes), then the activations a(0..n_hidden) and the cotangents
    dz(1..n_hidden), d_d, each [n_edges, h] of ``dtype``, at
    ``acts_offset`` and ``cots_offset``, then d_dproj's row pointer
    (n_nodes + 1 int32) at ``offsets_offset``; ``ws_bytes`` in all."""
    grid, n_chunks, part_len, part_bytes = _bwd_splits(n_edges, h, n_hidden,
                                                       sm_count, "K2")
    act_bytes = (n_hidden + 1) * n_edges * h * torch.finfo(dtype).bits // 8
    offsets_at = part_bytes + 2 * act_bytes
    return {"grid": grid, "n_chunks": n_chunks, "part_len": part_len,
            "acts_offset": part_bytes, "cots_offset": part_bytes + act_bytes,
            "offsets_offset": offsets_at,
            "ws_bytes": offsets_at + 4 * (n_nodes + 1)}


def edge_bwd_saved_plan(n_edges: int, n_nodes: int, h: int, n_hidden: int,
                        dtype, sm_count: int, max_smem: int) -> dict:
    """K8's launch plan (csrc/edge_bwd_rows.cuh, which checks it against
    its own reckoning): K2's ``grid`` and partials (so K2's bits), then the
    cotangents dz(1..n_hidden), d_d at ``cots_offset`` and d_dproj's row
    pointer at ``offsets_offset``: no activations, which K8 reads from the
    save variant's zs (``ws_bytes`` is K2's less (n_hidden + 1) n_edges h
    elements). ``resident``: the row kernel keeps the n_hidden + 2 weights
    its backward products read (W^T, one copy each) in shared memory
    (``smem_bytes`` of the ``max_smem`` a CTA may have, with fp32's A
    operand slices and the warps' LayerNorm column sums), else streams
    them through a ring of two slots; ``dw_smem_bytes`` the
    weight-gradient kernel's."""
    return dict(_edge_bwd_saved_plan(n_edges, n_nodes, h, n_hidden, dtype,
                                     sm_count, max_smem))


@functools.lru_cache(maxsize=64)
def _edge_bwd_saved_plan(n_edges, n_nodes, h, n_hidden, dtype, sm_count,
                         max_smem):
    grid, n_chunks, part_len, part_bytes = _bwd_splits(n_edges, h, n_hidden,
                                                       sm_count, "K8")
    isz = torch.finfo(dtype).bits // 8
    cot_bytes = (n_hidden + 1) * n_edges * h * isz
    # csrc/chain.cuh Layout (rows padded by 16 bytes) and rows_bwd.cuh
    # rows_fixed_smem / dw_smem: fp32 stages the A operands ([128][ld]);
    # both keep the warps' LayerNorm column sums ([2][2][8][h] fp32)
    ld = h + 16 // isz
    mat = h * ld * isz
    fixed = (CHUNK_ROWS * ld * 4 if isz == 4 else 0) + 2 * 2 * 8 * h * 4
    resident = (n_hidden + 2) * mat + fixed <= max_smem
    smem = (n_hidden + 2 if resident else 2) * mat + fixed
    dw_smem = 2 * 2 * DW_SLAB * ld * isz
    if max(smem, dw_smem) > max_smem:
        raise ValueError(f"K8 at h={h} needs {max(smem, dw_smem)} bytes of "
                         f"shared memory, more than {max_smem}")
    return {"grid": grid, "n_chunks": n_chunks, "part_len": part_len,
            "cots_offset": part_bytes,
            "offsets_offset": part_bytes + cot_bytes,
            "ws_bytes": part_bytes + cot_bytes + 4 * (n_nodes + 1),
            "resident": resident, "smem_bytes": smem,
            "dw_smem_bytes": dw_smem}


def fused_edge_layer_bwd(e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                         b_out, ln_scale, ln_bias, ct_e, ct_agg,
                         num_nodes: int):
    """VJP of the fused edge layer: (d_e, d_sg, d_dproj, dW_e, dWs, dbs,
    dW_out, db_out, dscale, dbias), the weight gradients in fp32. CUDA
    tensors launch kernel K2 (deterministic: per-split partials summed in a
    fixed order); CPU tensors run the plain version."""
    if not e.is_cuda:
        return fused_edge_layer_bwd_ref(e, sg, d_proj, mask, receivers, w_e,
                                        ws, bs, w_out, b_out, ln_scale,
                                        ln_bias, ct_e, ct_agg, num_nodes)
    n_edges, h, nh = _check_args(
        e, receivers, num_nodes, sg=sg, d_proj=d_proj, mask=mask, w_e=w_e,
        ws=ws, bs=bs, w_out=w_out, b_out=b_out, ln_scale=ln_scale,
        ln_bias=ln_bias, ct_e=ct_e, ct_agg=ct_agg)
    dev = e.device
    plan = edge_bwd_plan(n_edges, num_nodes, h, nh, e.dtype,
                         _build.device_limits(dev)[0])
    wb = _build.edge_bwd_operands([w_e, ws, w_out])
    d_e, d_sg = torch.empty_like(e), torch.empty_like(e)
    d_dproj = torch.empty((num_nodes, h), dtype=e.dtype, device=dev)
    n_mat = (nh + 2) * h * h
    dw = torch.empty(n_mat + (nh + 3) * h, dtype=torch.float32, device=dev)
    workspace = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=dev)
    fn = _build.c_function("fused_edge_bwd", "aero_fused_edge_bwd",
                           _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in (
                     e, sg, d_proj, mask, receivers, wb, bs, b_out, ln_scale,
                     ct_e, ct_agg, d_e, d_sg, d_dproj, dw, workspace)],
                 plan["ws_bytes"], n_edges, num_nodes, h, nh, plan["grid"],
                 ET, _DTYPE_CODE[e.dtype], stream)
    _build.check_launch("aero_fused_edge_bwd", err)
    count("launch.K2")
    return _split_grads(d_e, d_sg, d_dproj, dw, h, nh)


def fused_edge_layer_bwd_saved(e, mask, receivers, w_e, ws, w_out, ln_scale,
                               zs, d, mu, inv, ct_e, ct_agg, num_nodes: int):
    """VJP of the fused edge layer from the save variant's zs, d, mu, inv:
    the outputs of fused_edge_layer_bwd. CUDA tensors launch kernel K8
    (deterministic, and K2's bits); CPU tensors run the plain version."""
    if not e.is_cuda:
        return fused_edge_layer_bwd_saved_ref(e, mask, receivers, w_e, ws,
                                              w_out, ln_scale, zs, d, mu,
                                              inv, ct_e, ct_agg, num_nodes)
    n_edges, h, nh = _check_args(
        e, receivers, num_nodes, mask=mask, w_e=w_e, ws=ws, w_out=w_out,
        ln_scale=ln_scale, zs=zs, d=d, mu=mu, inv=inv, ct_e=ct_e,
        ct_agg=ct_agg)
    dev = e.device
    plan = edge_bwd_saved_plan(n_edges, num_nodes, h, nh, e.dtype,
                               *_build.device_limits(dev))
    wb = _build.bwd_only_operands([w_e, ws, w_out])
    d_e, d_sg = torch.empty_like(e), torch.empty_like(e)
    d_dproj = torch.empty((num_nodes, h), dtype=e.dtype, device=dev)
    n_mat = (nh + 2) * h * h
    dw = torch.empty(n_mat + (nh + 3) * h, dtype=torch.float32, device=dev)
    workspace = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=dev)
    fn = _build.c_function("fused_edge_bwd_saved",
                           "aero_fused_edge_bwd_saved", _SAVED_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in (
                     e, mask, receivers, wb, ln_scale, zs, d, mu, inv, ct_e,
                     ct_agg, d_e, d_sg, d_dproj, dw, workspace)],
                 plan["ws_bytes"], n_edges, num_nodes, h, nh, plan["grid"],
                 int(plan["resident"]), ET, _DTYPE_CODE[e.dtype], stream)
    _build.check_launch("aero_fused_edge_bwd_saved", err)
    count("launch.K8")
    return _split_grads(d_e, d_sg, d_dproj, dw, h, nh)


class _FusedEdgeLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out,
                b_out, ln_scale, ln_bias, num_nodes, save):
        ctx.num_nodes, ctx.save = num_nodes, save
        weights = (w_e, ws, bs, w_out, b_out, ln_scale, ln_bias)
        if not save:
            ctx.save_for_backward(e, sg, d_proj, mask, receivers, *weights)
            return fused_edge_layer(e, sg, d_proj, mask, receivers, *weights,
                                    num_nodes)
        e_out, agg, *acts = fused_edge_layer_save(
            e, sg, d_proj, mask, receivers, *weights, num_nodes)
        # sg / d_proj are no residuals here, as in _fel_fwd: K8 never reads
        # them
        ctx.save_for_backward(e, mask, receivers, *weights, *acts)
        return e_out, agg

    @staticmethod
    def backward(ctx, ct_e, ct_agg):
        ct_e, ct_agg = ct_e.contiguous(), ct_agg.contiguous()
        if ctx.save:
            (e, mask, receivers, w_e, ws, bs, w_out, b_out, ln_scale, ln_bias,
             zs, d, mu, inv) = ctx.saved_tensors
            weights = (w_e, ws, bs, w_out, b_out, ln_scale, ln_bias)
            grads = fused_edge_layer_bwd_saved(
                e, mask, receivers, w_e, ws, w_out, ln_scale, zs, d, mu, inv,
                ct_e, ct_agg, ctx.num_nodes)
        else:
            saved = ctx.saved_tensors
            weights = saved[5:]
            grads = fused_edge_layer_bwd(*saved, ct_e, ct_agg, ctx.num_nodes)
        d_e, d_sg, d_dproj = grads[:3]
        # weight gradients rounded to the weights' (compute) dtype, as the
        # JAX package's _fused_bwd / _fused_bwd_saved return them
        wgrads = [g.to(w.dtype) for g, w in zip(grads[3:], weights)]
        return (d_e, d_sg, d_dproj, None, None, *wgrads, None, None)


def fused_edge_layer_autograd(e, sg, d_proj, mask, receivers, w_e, ws, bs,
                              w_out, b_out, ln_scale, ln_bias,
                              num_nodes: int, activation: str = "relu"):
    """The differentiable fused edge layer: (e', agg) by K1, its backward
    by K2; with AERO_GNN_SAVE_ACTS=1 and a gradient to take, by K1's save
    variant and K8 (the plain versions on CPU tensors)."""
    if activation != "relu":
        raise ValueError("fused edge layer supports relu (the reference "
                         "hardcodes ReLU in EdgeBlockSum)")
    args = (e, sg, d_proj, mask, receivers, w_e, ws, bs, w_out, b_out,
            ln_scale, ln_bias)
    save = (save_acts_enabled() and torch.is_grad_enabled()
            and any(t.requires_grad for t in args))
    return _FusedEdgeLayer.apply(*args, num_nodes, save)
