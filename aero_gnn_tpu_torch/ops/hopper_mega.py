"""The whole MGN processor layer in one kernel each way: Hopper kernels
K9-fwd and K9-bwd with their plain versions (counterpart of
aero_gnn_tpu.ops.pallas_mega).

    e', agg = the fused edge layer (e, sg, d_proj, mask, receivers)  (K1)
    x'      = x + LayerNorm(MLP([x, agg]))                           (K3)

'add' aggregation, ReLU, the block-aligned layout of K1.
``fused_mgn_layer`` launches ``csrc/fused_mgn_fwd.cu`` on CUDA tensors and
runs ``fused_mgn_layer_ref`` (K1's plain version followed by K3's, as the
JAX package's ``_equiv`` composes them) on CPU tensors; both return
(x', e', agg). K9-fwd runs one CTA a node block: K1's row-kernel chunks
over the block's edge tiles, the block's agg, then K3's chunks over its
nodes; ``mega_fwd_plan`` plans its grid and shared memory.
``fused_mgn_layer_bwd`` launches ``csrc/fused_mgn_bwd.cu`` or runs
``fused_mgn_layer_bwd_ref``: one CTA a node block runs K4's row-kernel
chunks over its nodes, then K2's over its edge tiles with the aggregation
cotangent K4 produced, and the block's d_dproj; K2's and K4's split-K
kernels then give the weight gradients, all K4 -> K2's bits;
``mega_bwd_plan`` plans its grids, shared memory and workspace.
``fused_mgn_layer_autograd`` is the differentiable layer, (x, e) ->
(x', e'); it saves the layer's inputs and the aggregate, as ``_fmgn_fwd``
does, so the backward never re-runs the forward. ``ep`` / ``npar`` are the
edge and node parameter dicts of the JAX package (``EDGE_KEYS``,
``NODE_KEYS``). ``mega_enabled`` reads ``AERO_GNN_MEGA`` (off by default,
as in JAX); ``nn.blocks`` routes the fused layer here when it is on.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from aero_gnn_tpu_torch.ops import _build
from aero_gnn_tpu_torch.ops import hopper_fused as HF
from aero_gnn_tpu_torch.ops import hopper_node as HN
from aero_gnn_tpu_torch.utils.profiling import count

NB, ET = HF.NB, HF.ET
EDGE_KEYS = ("w_e", "ws", "bs", "w_out", "b_out", "ln_scale", "ln_bias")
NODE_KEYS = ("w1x", "w1a", "b1", "ws", "bs", "w_out", "b_out", "ln_scale",
             "ln_bias")
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_FWD_ARGTYPES = [_P] * 25 + [_I64, _I64] + [_I] * 7 + [_P]
_BWD_ARGTYPES = [_P] * 24 + [_I64] * 3 + [_I] * 9 + [_P]
# a row chunk's warps (csrc/chain.cuh kWarps)
WARPS = 8


def mega_enabled() -> bool:
    """AERO_GNN_MEGA=1: the fused MGN layer with 'add' aggregation runs as
    K9 (nn.blocks._mega_layer_ok). Read at call time; off by default, as
    the JAX package's pallas_mega.mega_enabled."""
    return os.environ.get("AERO_GNN_MEGA", "0") == "1"


def fused_mgn_layer_ref(e, sg, d_proj, x, mask, receivers, ep, npar,
                        num_nodes: int):
    """Plain version: (x', e', agg), the fused edge layer's plain version
    followed by the fused node layer's (pallas_mega.py _equiv :442-454)."""
    e_new, agg = HF.fused_edge_layer_ref(e, sg, d_proj, mask, receivers,
                                         *[ep[k] for k in EDGE_KEYS],
                                         num_nodes)
    x_new = HN.fused_node_layer_ref(x, agg.to(x.dtype),
                                    *[npar[k] for k in NODE_KEYS])
    return x_new, e_new, agg


def fused_mgn_layer_bwd_ref(e, sg, d_proj, x, agg, mask, receivers, ep,
                            npar, ct_e, ct_x, num_nodes: int):
    """Plain VJP for the cotangents ct_e of e' and ct_x of x': the node
    backward's plain version, then the edge backward's with ct_agg = its
    d_agg (pallas_mega.py:270-343). Returns (d_e, d_sg, d_dproj, d_x, d_ep,
    d_np), the weight gradients fp32 dicts keyed as ep / npar."""
    node = HN.fused_node_layer_bwd_ref(x, agg, *[npar[k] for k in NODE_KEYS],
                                       ct_x)
    edge = HF.fused_edge_layer_bwd_ref(e, sg, d_proj, mask, receivers,
                                       *[ep[k] for k in EDGE_KEYS], ct_e,
                                       node[1], num_nodes)
    return (*edge[:3], node[0], dict(zip(EDGE_KEYS, edge[3:])),
            dict(zip(NODE_KEYS, node[2:])))


def _check_args(e, sg, d_proj, x, mask, receivers, ep, npar, num_nodes,
                agg=None, ct_e=None, ct_x=None):
    """Validate the layer's tensors for the kernels (K1's and K3's rules,
    x and e of one dtype); returns (h, edge hidden layers, node hidden
    layers)."""
    h = e.shape[1]
    if tuple(x.shape) != (num_nodes, h) or x.dtype != e.dtype:
        raise ValueError(f"x is {tuple(x.shape)} {x.dtype}, expected "
                         f"({num_nodes}, {h}) {e.dtype}")
    cts = {} if ct_e is None else {"ct_e": ct_e}
    _, _, ne = HF._check_args(e, receivers, num_nodes, sg=sg, d_proj=d_proj,
                              mask=mask, **ep, **cts)
    # in the forward x stands in for agg: the same shape and type
    _, _, nn = HN._check_args(x, x if agg is None else agg,
                              *[npar[k] for k in NODE_KEYS],
                              **({} if ct_x is None else {"ct": ct_x}))
    if num_nodes % NB:
        raise ValueError(f"the single-kernel layer needs N a multiple of "
                         f"{NB}, got {num_nodes}")
    return h, ne, nn


def mega_fwd_plan(n_edges: int, n_nodes: int, h: int, ne_hidden: int,
                  nn_hidden: int, dtype, sm_count: int, max_smem: int) -> dict:
    """K9-fwd's launch plan (csrc/fused_mgn_fwd.cu, which checks it against
    its own reckoning): ``grid`` = one CTA per node block of ``NB`` nodes
    (``waves`` of ``sm_count``); ``resident``: the weights stay in shared
    memory (the edge chain's ne_hidden + 2 for the block's edge chunks,
    then the node chain's nn_hidden + 3 in the same slots), where the
    larger set fits, else both chains stream through a ring of two slots.
    ``smem_bytes`` of the ``max_smem`` a CTA may have: the weights, fp32's
    warps' A operand slices, and each node's live-row bounds and the
    block's tile range. No workspace: a block's aggregate is summed by the
    CTA that owns it."""
    return dict(_mega_fwd_plan(n_edges, n_nodes, h, ne_hidden, nn_hidden,
                               dtype, sm_count, max_smem))


@functools.lru_cache(maxsize=64)
def _mega_fwd_plan(n_edges, n_nodes, h, ne_hidden, nn_hidden, dtype,
                   sm_count, max_smem):
    if n_edges <= 0 or n_edges % ET or n_nodes <= 0 or n_nodes % NB:
        raise ValueError(f"K9-fwd needs the block-aligned layout: E={n_edges} "
                         f"a positive multiple of {ET}, N={n_nodes} a "
                         f"positive multiple of {NB}")
    if ne_hidden < 0 or nn_hidden < 0:
        raise ValueError(f"K9-fwd takes 0 or more hidden layers, not "
                         f"{ne_hidden} / {nn_hidden}")
    isz = torch.finfo(dtype).bits // 8
    n_mats = max(ne_hidden + 2, nn_hidden + 3)
    # csrc/chain.cuh Layout: [h][ld] weight tiles, rows padded by 16 bytes;
    # fused_mgn_fwd.cu mega_fixed_smem
    ld = h + 16 // isz
    mat = h * ld * isz
    fixed = (HF.CHUNK_ROWS * ld * 4 if isz == 4 else 0) + (2 * NB + 4) * 4
    resident = n_mats * mat + fixed <= max_smem
    smem = (n_mats if resident else 2) * mat + fixed
    if smem > max_smem:
        raise ValueError(f"K9-fwd at h={h} needs {smem} bytes of shared "
                         f"memory, more than {max_smem}")
    n_blocks = n_nodes // NB
    return {"grid": n_blocks, "waves": -(-n_blocks // sm_count),
            "resident": resident, "smem_bytes": smem}


def mega_bwd_plan(n_edges: int, n_nodes: int, h: int, ne_hidden: int,
                  nn_hidden: int, dtype, sm_count: int, max_smem: int) -> dict:
    """K9-bwd's launch plan (csrc/fused_mgn_bwd.cu, which checks it against
    its own reckoning): ``grid`` = one CTA per node block of ``NB`` nodes
    (``waves`` of ``sm_count``); ``resident``: the weights stay in shared
    memory (K4's nn_hidden + 3 for the block's node chunks, then K2's
    ne_hidden + 2 in the same slots; bf16 one copy each, fp32 W and W^T),
    where the larger set fits, else both chains stream through a ring of
    two slots; ``smem_bytes`` of the ``max_smem`` a CTA may have: the
    weights, fp32's warps' A operand slices, a chunk's LayerNorm column
    sums, each node's live-row bounds and the block's tile range. The
    weight gradients run on ``edge_grid`` and ``node_grid`` splits, the
    grids K2's and K4's plans choose for the same E and N (so their bits),
    in one launch of ``dw_blocks`` CTAs (``dw_smem_bytes`` each). The
    workspace (``ws_bytes``), each region at a multiple of 256 bytes:
    K2's partials (``edge_part_len`` floats a split) at
    ``edge_part_offset`` = 0, K4's at ``node_part_offset``, K2's a(0..ne_hidden) at ``edge_acts_offset`` and
    dz(1..ne_hidden), d_d at ``edge_cots_offset`` ([n_edges, h] each),
    K4's a(0..nn_hidden) then dz(0..nn_hidden), d_d at
    ``node_acts_offset`` ([n_nodes, h] each), each chunk's per-warp
    LayerNorm column sums (fp32 [chunks, 2, 8, h]) of the edge chunks at
    ``edge_sums_offset`` and of the node chunks at ``node_sums_offset``,
    and d_agg [n_nodes, h] at ``d_agg_offset``."""
    return dict(_mega_bwd_plan(n_edges, n_nodes, h, ne_hidden, nn_hidden,
                               dtype, sm_count, max_smem))


@functools.lru_cache(maxsize=64)
def _mega_bwd_plan(n_edges, n_nodes, h, ne_hidden, nn_hidden, dtype,
                   sm_count, max_smem):
    if n_edges <= 0 or n_edges % ET or n_nodes <= 0 or n_nodes % NB:
        raise ValueError(f"K9-bwd needs the block-aligned layout: E={n_edges} "
                         f"a positive multiple of {ET}, N={n_nodes} a "
                         f"positive multiple of {NB}")
    if ne_hidden < 0 or nn_hidden < 0:
        raise ValueError(f"K9-bwd takes 0 or more hidden layers, not "
                         f"{ne_hidden} / {nn_hidden}")
    isz = torch.finfo(dtype).bits // 8
    copies = 2 if isz == 4 else 1
    n_mats = max(ne_hidden + 2, nn_hidden + 3) * copies
    # csrc/chain.cuh Layout: [h][ld] weight tiles, rows padded by 16 bytes;
    # fused_mgn_bwd.cu mega_bwd_fixed_smem; rows_bwd.cuh dw_smem
    ld = h + 16 // isz
    mat = h * ld * isz
    fixed = ((HF.CHUNK_ROWS * ld * 4 if isz == 4 else 0)
             + 2 * WARPS * h * 4 + (2 * NB + 4) * 4)
    resident = n_mats * mat + fixed <= max_smem
    smem = (n_mats if resident else 2) * mat + fixed
    dw_smem = 2 * 2 * HN.DW_SLAB * ld * isz
    if max(smem, dw_smem) > max_smem:
        raise ValueError(f"K9-bwd at h={h} needs {max(smem, dw_smem)} bytes "
                         f"of shared memory, more than {max_smem}")
    e_chunks, n_chunks = n_edges // HF.CHUNK_ROWS, n_nodes // HF.CHUNK_ROWS
    e_grid, n_grid = min(sm_count, e_chunks), min(sm_count, n_chunks)
    e_part = (ne_hidden + 2) * h * h + (ne_hidden + 3) * h
    n_part = (nn_hidden + 3) * h * h + (nn_hidden + 4) * h
    regions = (("edge_part", e_grid * e_part * 4),
               ("node_part", n_grid * n_part * 4),
               ("edge_acts", (ne_hidden + 1) * n_edges * h * isz),
               ("edge_cots", (ne_hidden + 1) * n_edges * h * isz),
               ("node_acts", (2 * nn_hidden + 3) * n_nodes * h * isz),
               ("edge_sums", e_chunks * 2 * WARPS * h * 4),
               ("node_sums", n_chunks * 2 * WARPS * h * 4),
               ("d_agg", n_nodes * h * isz))
    plan, at = {}, 0
    for name, nbytes in regions:
        plan[f"{name}_offset"] = at
        at += -(-nbytes // 256) * 256
    plan["ws_bytes"] = at
    n_blocks = n_nodes // NB
    plan.update(grid=n_blocks, waves=-(-n_blocks // sm_count),
                resident=resident, smem_bytes=smem, edge_grid=e_grid,
                node_grid=n_grid, edge_part_len=e_part, node_part_len=n_part,
                dw_blocks=max(e_grid, n_grid) * (ne_hidden + nn_hidden + 7),
                dw_smem_bytes=dw_smem)
    return plan


def fused_mgn_layer(e, sg, d_proj, x, mask, receivers, ep, npar,
                    num_nodes: int):
    """(x', e', agg) of the whole MGN layer. CUDA tensors launch kernel
    K9-fwd; CPU tensors run the plain version. No autograd (see
    fused_mgn_layer_autograd)."""
    if not e.is_cuda:
        return fused_mgn_layer_ref(e, sg, d_proj, x, mask, receivers, ep,
                                   npar, num_nodes)
    h, ne, nn = _check_args(e, sg, d_proj, x, mask, receivers, ep, npar,
                            num_nodes)
    plan = _mega_fwd_plan(e.shape[0], num_nodes, h, ne, nn, e.dtype,
                          *_build.device_limits(e.device))
    e_out, x_out = torch.empty_like(e), torch.empty_like(x)
    agg = torch.empty((num_nodes, h), dtype=e.dtype, device=e.device)
    tensors = [e, sg, d_proj, x, mask, receivers,
               *[ep[k] for k in EDGE_KEYS], *[npar[k] for k in NODE_KEYS],
               e_out, agg, x_out]
    fn = _build.c_function("fused_mgn_fwd", "aero_fused_mgn_fwd",
                           _FWD_ARGTYPES)
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream(e.device).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], e.shape[0], num_nodes, h,
                 ne, nn, NB, ET, int(plan["resident"]),
                 HF._DTYPE_CODE[e.dtype], stream)
    _build.check_launch("aero_fused_mgn_fwd", err)
    count("launch.K9-fwd")
    return x_out, e_out, agg


def fused_mgn_layer_bwd(e, sg, d_proj, x, agg, mask, receivers, ep, npar,
                        ct_e, ct_x, num_nodes: int):
    """VJP of the whole MGN layer: (d_e, d_sg, d_dproj, d_x, d_ep, d_np),
    the weight gradients fp32 dicts keyed as ep / npar. CUDA tensors launch
    kernel K9-bwd (deterministic, K4 -> K2's bits); CPU tensors run the
    plain version."""
    if not e.is_cuda:
        return fused_mgn_layer_bwd_ref(e, sg, d_proj, x, agg, mask,
                                       receivers, ep, npar, ct_e, ct_x,
                                       num_nodes)
    h, ne, nn = _check_args(e, sg, d_proj, x, mask, receivers, ep, npar,
                            num_nodes, agg=agg, ct_e=ct_e, ct_x=ct_x)
    dev = e.device
    plan = _mega_bwd_plan(e.shape[0], num_nodes, h, ne, nn, e.dtype,
                          *_build.device_limits(dev))
    d_e, d_sg = torch.empty_like(e), torch.empty_like(e)
    d_dproj = torch.empty((num_nodes, h), dtype=e.dtype, device=dev)
    d_x = torch.empty_like(x)
    sizes = [(ne + 2) * h * h, (ne + 3) * h, (nn + 3) * h * h, (nn + 4) * h]
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    workspace = torch.empty(plan["ws_bytes"], dtype=torch.uint8, device=dev)
    wb_e = _build.edge_bwd_operands([ep["w_e"], ep["ws"], ep["w_out"]])
    wb_n = _build.edge_bwd_operands([npar["w1x"], npar["w1a"], npar["ws"],
                                     npar["w_out"]])
    tensors = [e, sg, d_proj, x, agg, mask, receivers, wb_e, ep["bs"],
               ep["b_out"], ep["ln_scale"], wb_n, npar["b1"], npar["bs"],
               npar["b_out"], npar["ln_scale"], ct_e, ct_x, d_e, d_sg,
               d_dproj, d_x, dw, workspace]
    fn = _build.c_function("fused_mgn_bwd", "aero_fused_mgn_bwd",
                           _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], plan["ws_bytes"],
                 e.shape[0], num_nodes, h, ne, nn, NB, ET, plan["edge_grid"],
                 plan["node_grid"], int(plan["resident"]),
                 HF._DTYPE_CODE[e.dtype], stream)
    _build.check_launch("aero_fused_mgn_bwd", err)
    count("launch.K9-bwd")
    # K2's [dW_e, dWs, dW_out], [db_out, dscale, dbias, dbs], then K4's
    # [dW1x, dW1a, dWs, dW_out], [db_out, dscale, dbias, db1, dbs]
    em, ev, nm, nv = torch.split(dw, sizes)
    em, nm = em.view(ne + 2, h, h), nm.view(nn + 3, h, h)
    ev, nv = ev.view(ne + 3, h), nv.view(nn + 4, h)
    d_ep = {"w_e": em[0], "ws": em[1:ne + 1], "bs": ev[3:],
            "w_out": em[ne + 1], "b_out": ev[0], "ln_scale": ev[1],
            "ln_bias": ev[2]}
    d_np = {"w1x": nm[0], "w1a": nm[1], "b1": nv[3], "ws": nm[2:nn + 2],
            "bs": nv[4:], "w_out": nm[nn + 2], "b_out": nv[0],
            "ln_scale": nv[1], "ln_bias": nv[2]}
    return d_e, d_sg, d_dproj, d_x, d_ep, d_np


class _FusedMGNLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, sg, d_proj, x, mask, receivers, num_nodes, *weights):
        ep = dict(zip(EDGE_KEYS, weights[:len(EDGE_KEYS)]))
        npar = dict(zip(NODE_KEYS, weights[len(EDGE_KEYS):]))
        x_new, e_new, agg = fused_mgn_layer(e, sg, d_proj, x, mask,
                                            receivers, ep, npar, num_nodes)
        ctx.save_for_backward(e, sg, d_proj, x, agg, mask, receivers,
                              *weights)
        ctx.num_nodes = num_nodes
        return x_new, e_new

    @staticmethod
    def backward(ctx, ct_x, ct_e):
        e, sg, d_proj, x, agg, mask, receivers, *weights = ctx.saved_tensors
        ep = dict(zip(EDGE_KEYS, weights[:len(EDGE_KEYS)]))
        npar = dict(zip(NODE_KEYS, weights[len(EDGE_KEYS):]))
        d_e, d_sg, d_dproj, d_x, d_ep, d_np = fused_mgn_layer_bwd(
            e, sg, d_proj, x, agg, mask, receivers, ep, npar,
            ct_e.contiguous(), ct_x.contiguous(), ctx.num_nodes)
        # weight gradients rounded to the weights' (compute) dtype, as the
        # JAX package's _mega_bwd_call returns them
        wgrads = ([d_ep[k].to(ep[k].dtype) for k in EDGE_KEYS]
                  + [d_np[k].to(npar[k].dtype) for k in NODE_KEYS])
        return (d_e, d_sg, d_dproj, d_x, None, None, None, *wgrads)


def fused_mgn_layer_autograd(e, sg, d_proj, x, mask, receivers, ep, npar,
                             num_nodes: int):
    """The differentiable whole MGN layer, (x', e'): forward K9-fwd,
    backward K9-bwd (the plain versions on CPU tensors)."""
    return _FusedMGNLayer.apply(e, sg, d_proj, x, mask, receivers, num_nodes,
                                *[ep[k] for k in EDGE_KEYS],
                                *[npar[k] for k in NODE_KEYS])
