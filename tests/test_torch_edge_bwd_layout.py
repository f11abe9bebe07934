"""K2's launch layout, computed in Python and checked on the CPU: the
weights' operand layout (``_build.edge_bwd_operands``: bf16 one copy each,
fp32 W and W^T), the workspace plan (``hopper_fused.edge_bwd_plan``), and
the widest row K7 takes (``hopper_segment.weighted_max_width``). Weights
from a numpy seed."""

import numpy as np
import pytest
import torch

from aero_gnn_tpu_torch.ops import _build
from aero_gnn_tpu_torch.ops import hopper_fused as HF
from aero_gnn_tpu_torch.ops import hopper_segment as HS

CASES = [(dt, h, nh) for dt in (torch.bfloat16, torch.float32)
         for h in (64, 128) for nh in (0, 2, 4)]
IDS = [f"{str(dt)[6:]}-h{h}-nh{nh}" for dt, h, nh in CASES]
FLAGSHIP_E, FLAGSHIP_N, H100_SMS = 264_192, 66_048, 132


def _weights(dt, h, nh, seed=11):
    r = np.random.default_rng(seed)
    w_e, w_out = (torch.from_numpy(r.standard_normal((h, h)).astype(
        np.float32)).to(dt) for _ in range(2))
    ws = torch.from_numpy(r.standard_normal((nh, h, h)).astype(
        np.float32)).to(dt)
    return w_e, ws, w_out


@pytest.mark.parametrize("dt,h,nh", CASES, ids=IDS)
def test_edge_bwd_operands_layout(dt, h, nh):
    """bf16: each W once, transposed (ldmatrix reads B as [n][k]; the
    backward product reads the same tile transposed); fp32: W and W^T."""
    w_e, ws, w_out = _weights(dt, h, nh)
    mats = [w_e, *ws, w_out]
    got = _build.edge_bwd_operands([w_e, ws, w_out])
    assert got.dtype == dt and got.is_contiguous()
    if dt == torch.bfloat16:
        assert got.shape == (nh + 2, h, h)
        for m, w in enumerate(mats):
            assert torch.equal(got[m], w.T), m
    else:
        assert got.shape == (nh + 2, 2, h, h)
        for m, w in enumerate(mats):
            assert torch.equal(got[m, 0], w) and torch.equal(got[m, 1], w.T)


@pytest.mark.parametrize("dt,h,nh", CASES, ids=IDS)
def test_edge_bwd_plan_flagship(dt, h, nh):
    p = HF.edge_bwd_plan(FLAGSHIP_E, FLAGSHIP_N, h, nh, dt, H100_SMS)
    isz = 2 if dt == torch.bfloat16 else 4
    assert p["n_chunks"] == FLAGSHIP_E // 128 == 2064
    assert p["grid"] == H100_SMS
    assert p["part_len"] == (nh + 2) * h * h + (nh + 3) * h
    assert p["acts_offset"] % 256 == 0
    assert p["acts_offset"] >= H100_SMS * p["part_len"] * 4
    assert p["acts_offset"] - H100_SMS * p["part_len"] * 4 < 256
    act = (nh + 1) * FLAGSHIP_E * h * isz
    assert p["cots_offset"] == p["acts_offset"] + act
    assert p["offsets_offset"] == p["acts_offset"] + 2 * act
    assert p["ws_bytes"] == p["offsets_offset"] + 4 * (FLAGSHIP_N + 1)


@pytest.mark.parametrize("n_edges,sms,grid", [(1024, 132, 8), (128, 132, 1),
                                              (2048, 4, 4)])
def test_edge_bwd_plan_small_grids(n_edges, sms, grid):
    p = HF.edge_bwd_plan(n_edges, 512, 64, 2, torch.float32, sms)
    assert p["grid"] == grid and p["n_chunks"] == n_edges // 128


@pytest.mark.parametrize("n_edges,nh", [(1000, 2), (0, 2), (1024, -1)])
def test_edge_bwd_plan_refuses(n_edges, nh):
    with pytest.raises(ValueError):
        HF.edge_bwd_plan(n_edges, 512, 128, nh, torch.bfloat16, H100_SMS)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("nh", [9, 12, 16])
def test_edge_bwd_plan_deep_stacks(dt, nh):
    """Stacks deeper than the ReLU masks the row kernel keeps in registers
    (csrc/rows_bwd.cuh kMaxHidden = 8; it reads the rest back from the
    activations it stored) are planned like any other: one partial a CTA,
    the workspace growing with the stack."""
    isz = 2 if dt == torch.bfloat16 else 4
    p = HF.edge_bwd_plan(FLAGSHIP_E, FLAGSHIP_N, 128, nh, dt, H100_SMS)
    assert p["grid"] == H100_SMS and p["n_chunks"] == 2064
    assert p["part_len"] == (nh + 2) * 128 * 128 + (nh + 3) * 128
    act = (nh + 1) * FLAGSHIP_E * 128 * isz
    assert p["offsets_offset"] == p["acts_offset"] + 2 * act
    assert p["ws_bytes"] == p["offsets_offset"] + 4 * (FLAGSHIP_N + 1)


@pytest.mark.parametrize("dt,width,limit", [
    (torch.float32, 128, 512), (torch.bfloat16, 128, 512),
    (torch.float32, 34, 128), (torch.bfloat16, 34, 128)])
def test_weighted_max_width(dt, width, limit):
    assert HS.weighted_max_width(dt, width) == limit
