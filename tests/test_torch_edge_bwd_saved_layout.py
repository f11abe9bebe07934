"""K8's launch layout, computed in Python and checked on the CPU against an
independent reckoning: the plan (``hopper_fused.edge_bwd_saved_plan``:
K2's grid and partials, no activation workspace, the backward products'
weights resident in shared memory or streamed through the two-slot ring,
the shared memory against the H100's 227 KB a CTA may have, the refusals)
and the weights' operand layout (``_build.bwd_only_operands``: W^T once).
Weights from a numpy seed."""

import numpy as np
import pytest
import torch

from aero_gnn_tpu_torch.ops import _build
from aero_gnn_tpu_torch.ops import hopper_fused as HF

CASES = [(dt, h, nh) for dt in (torch.bfloat16, torch.float32)
         for h in (64, 128) for nh in (0, 2, 9)]
IDS = [f"{str(dt)[6:]}-h{h}-nh{nh}" for dt, h, nh in CASES]
FLAGSHIP_E, FLAGSHIP_N, H100_SMS, H100_SMEM = 264_192, 66_048, 132, 232_448


def _expect_smem(dt, h, nh, max_smem=H100_SMEM):
    """(resident, shared bytes) of K8's row kernel: csrc/chain.cuh's Layout
    ([h][h + 16 bytes] weight tiles), the nh + 2 matrices W^T once each or
    two ring slots, and rows_bwd.cuh's rows_fixed_smem (fp32's [128][h + 4]
    A operand slices; the warps' LayerNorm column sums and their running
    totals, [2][2][8][h] fp32)."""
    isz = 2 if dt == torch.bfloat16 else 4
    mat = h * (h + 16 // isz) * isz
    fixed = (128 * (h + 4) * 4 if isz == 4 else 0) + 2 * 2 * 8 * h * 4
    resident = (nh + 2) * mat + fixed <= max_smem
    return resident, (nh + 2 if resident else 2) * mat + fixed


@pytest.mark.parametrize("dt,h,nh", CASES, ids=IDS)
def test_edge_bwd_saved_plan_flagship(dt, h, nh):
    """K2's grid and partials, then the cotangents and the row pointer:
    the workspace is K2's less its activations, (nh + 1) E h elements."""
    p = HF.edge_bwd_saved_plan(FLAGSHIP_E, FLAGSHIP_N, h, nh, dt, H100_SMS,
                               H100_SMEM)
    k2 = HF.edge_bwd_plan(FLAGSHIP_E, FLAGSHIP_N, h, nh, dt, H100_SMS)
    isz = 2 if dt == torch.bfloat16 else 4
    act = (nh + 1) * FLAGSHIP_E * h * isz
    assert p["n_chunks"] == FLAGSHIP_E // 128 == 2064
    assert p["grid"] == k2["grid"] == H100_SMS
    assert p["part_len"] == k2["part_len"] == (nh + 2) * h * h + (nh + 3) * h
    assert p["cots_offset"] % 256 == 0
    assert 0 <= p["cots_offset"] - H100_SMS * p["part_len"] * 4 < 256
    assert p["offsets_offset"] == p["cots_offset"] + act
    assert p["ws_bytes"] == p["offsets_offset"] + 4 * (FLAGSHIP_N + 1)
    assert p["ws_bytes"] == k2["ws_bytes"] - act
    resident, smem = _expect_smem(dt, h, nh)
    assert p["resident"] is resident
    assert p["smem_bytes"] == smem <= H100_SMEM
    assert p["dw_smem_bytes"] == 2 * 2 * 64 * (h + 16 // isz) * isz


@pytest.mark.parametrize("dt,h,nh,resident", [
    (torch.bfloat16, 128, 2, True), (torch.bfloat16, 128, 4, True),
    (torch.bfloat16, 128, 5, False), (torch.float32, 128, 0, True),
    (torch.float32, 128, 1, False), (torch.float32, 128, 2, False),
    (torch.float32, 64, 4, True), (torch.float32, 64, 8, True),
    (torch.float32, 64, 9, False)])
def test_edge_bwd_saved_plan_resident_or_ring(dt, h, nh, resident):
    """The flagship's bf16 W^T (4 x 34.8 KB) stay resident up to 4 hidden
    layers; fp32 at h = 128 (67.6 KB a matrix, beside 67.6 KB of A operand
    slices) streams from one hidden layer up; fp32 at h = 64 keeps W^T
    resident to 8 hidden layers, where K2's W and W^T stop at 3."""
    p = HF.edge_bwd_saved_plan(FLAGSHIP_E, FLAGSHIP_N, h, nh, dt, H100_SMS,
                               H100_SMEM)
    assert p["resident"] is resident
    assert p["smem_bytes"] == _expect_smem(dt, h, nh)[1]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("n_edges,sms,grid", [(1024, 132, 8), (128, 132, 1),
                                              (2048, 4, 4)])
def test_edge_bwd_saved_plan_small_grids(dt, n_edges, sms, grid):
    """One CTA per SM, at most one per 128-row chunk: K2's rule."""
    p = HF.edge_bwd_saved_plan(n_edges, 512, 64, 2, dt, sms, H100_SMEM)
    assert p["grid"] == grid and p["n_chunks"] == n_edges // 128
    assert p["grid"] == HF.edge_bwd_plan(n_edges, 512, 64, 2, dt,
                                         sms)["grid"]


@pytest.mark.parametrize("n_edges,nh,smem", [
    (1000, 2, H100_SMEM), (0, 2, H100_SMEM), (-128, 2, H100_SMEM),
    (1024, -1, H100_SMEM), (1024, 2, 150_000)])
def test_edge_bwd_saved_plan_refuses(n_edges, nh, smem):
    """Rows not whole chunks (none or fewer), a negative number of hidden
    layers, and fp32 at h = 128 on a card with too little shared memory for
    the ring and the A operand slices."""
    with pytest.raises(ValueError):
        HF.edge_bwd_saved_plan(n_edges, 512, 128, nh, torch.float32,
                               H100_SMS, smem)


def _weights(dt, h, nh, seed=11):
    r = np.random.default_rng(seed)
    w_e, w_out = (torch.from_numpy(r.standard_normal((h, h)).astype(
        np.float32)).to(dt) for _ in range(2))
    ws = torch.from_numpy(r.standard_normal((nh, h, h)).astype(
        np.float32)).to(dt)
    return w_e, ws, w_out


@pytest.mark.parametrize("dt,h,nh", [
    (dt, h, nh) for dt in (torch.bfloat16, torch.float32)
    for h in (64, 128) for nh in (0, 2, 4)])
def test_bwd_only_operands_layout(dt, h, nh):
    """W^T of each weight once, [n, h, h], in both dtypes: the tile K2's
    and K4's bf16 products read (edge_bwd_operands), and the backward half
    of their fp32 layout."""
    w_e, ws, w_out = _weights(dt, h, nh)
    got = _build.bwd_only_operands([w_e, ws, w_out])
    assert got.dtype == dt and got.is_contiguous()
    assert got.shape == (nh + 2, h, h)
    for m, w in enumerate([w_e, *ws, w_out]):
        assert torch.equal(got[m], w.T), m
    k2 = _build.edge_bwd_operands([w_e, ws, w_out])
    assert torch.equal(got, k2 if dt == torch.bfloat16 else k2[:, 1])
