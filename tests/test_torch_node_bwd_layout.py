"""K4's launch layout, computed in Python and checked on the CPU: the
weights' operand layout (``_build.edge_bwd_operands`` over [W1x, W1a,
ws, W_out]: one copy each in bf16, W and W^T in fp32), the launch and
workspace plan (``hopper_node.node_bwd_plan``) at the flagship and small
sizes, and its choice between weights resident in shared memory and the
two-slot ring, against the H100's 227 KB a CTA may have. Weights from a
numpy seed."""

import numpy as np
import pytest
import torch

from aero_gnn_tpu_torch.ops import _build
from aero_gnn_tpu_torch.ops import hopper_node as HN

CASES = [(dt, h, nh) for dt in (torch.bfloat16, torch.float32)
         for h in (64, 128) for nh in (0, 2, 4)]
IDS = [f"{str(dt)[6:]}-h{h}-nh{nh}" for dt, h, nh in CASES]
FLAGSHIP_N, H100_SMS, H100_SMEM = 66_048, 132, 232_448


def _weights(dt, h, nh, seed=12):
    r = np.random.default_rng(seed)
    w1x, w1a, w_out = (torch.from_numpy(r.standard_normal((h, h)).astype(
        np.float32)).to(dt) for _ in range(3))
    ws = torch.from_numpy(r.standard_normal((nh, h, h)).astype(
        np.float32)).to(dt)
    return w1x, w1a, ws, w_out


@pytest.mark.parametrize("dt,h,nh", CASES, ids=IDS)
def test_node_bwd_operands_layout(dt, h, nh):
    """The products' order: W1x, W1a, ws[0..nh), W_out; bf16 each W once,
    transposed (the backward product reads the same tile transposed),
    fp32 W and W^T."""
    w1x, w1a, ws, w_out = _weights(dt, h, nh)
    got = _build.edge_bwd_operands([w1x, w1a, ws, w_out])
    assert got.dtype == dt and got.is_contiguous()
    mats = [w1x, w1a, *ws, w_out]
    if dt == torch.bfloat16:
        assert got.shape == (nh + 3, h, h)
        for m, w in enumerate(mats):
            assert torch.equal(got[m], w.T), m
    else:
        assert got.shape == (nh + 3, 2, h, h)
        for m, w in enumerate(mats):
            assert torch.equal(got[m, 0], w) and torch.equal(got[m, 1], w.T)


@pytest.mark.parametrize("dt,h,nh", CASES, ids=IDS)
def test_node_bwd_plan_flagship(dt, h, nh):
    p = HN.node_bwd_plan(FLAGSHIP_N, h, nh, dt, H100_SMS, H100_SMEM)
    isz = 2 if dt == torch.bfloat16 else 4
    assert p["n_chunks"] == FLAGSHIP_N // 128 == 516
    assert p["grid"] == H100_SMS
    assert p["part_len"] == (nh + 3) * h * h + (nh + 4) * h
    assert p["acts_offset"] % 256 == 0
    assert p["acts_offset"] >= H100_SMS * p["part_len"] * 4
    assert p["acts_offset"] - H100_SMS * p["part_len"] * 4 < 256
    row = FLAGSHIP_N * h * isz
    assert p["cots_offset"] == p["acts_offset"] + (nh + 1) * row
    assert p["ws_bytes"] == p["cots_offset"] + (nh + 2) * row
    assert p["smem_bytes"] <= H100_SMEM
    assert p["dw_smem_bytes"] == 2 * 2 * 64 * (h + 16 // isz) * isz


def test_node_bwd_plan_flagship_bytes():
    """bf16 at the flagship (h = 128, 2 hidden): 132 partials of 82,688
    floats, then 3 activations and 4 cotangents of 16.9 MB each."""
    p = HN.node_bwd_plan(FLAGSHIP_N, 128, 2, torch.bfloat16, H100_SMS,
                         H100_SMEM)
    assert p["part_len"] == 82_688
    assert p["acts_offset"] == 43_659_264
    assert p["ws_bytes"] == 43_659_264 + 7 * 16_908_288


# (dtype, h, n_hidden) -> (resident, smem bytes of the row kernel): the
# weights (bf16 one [h][h + 8] tile each, fp32 two [h][h + 4] tiles) plus
# fp32's operand staging ([128][h + 4]) and the LayerNorm column sums
RESIDENCY = {
    (torch.bfloat16, 128, 0): (True, 3 * 34_816 + 16_384),
    (torch.bfloat16, 128, 2): (True, 5 * 34_816 + 16_384),
    (torch.bfloat16, 128, 4): (False, 2 * 34_816 + 16_384),
    (torch.float32, 128, 0): (False, 2 * 67_584 + 67_584 + 16_384),
    (torch.float32, 128, 2): (False, 2 * 67_584 + 67_584 + 16_384),
    (torch.float32, 128, 4): (False, 2 * 67_584 + 67_584 + 16_384),
    (torch.bfloat16, 64, 0): (True, 3 * 9_216 + 8_192),
    (torch.bfloat16, 64, 2): (True, 5 * 9_216 + 8_192),
    (torch.bfloat16, 64, 4): (True, 7 * 9_216 + 8_192),
    (torch.float32, 64, 0): (True, 6 * 17_408 + 34_816 + 8_192),
    (torch.float32, 64, 2): (True, 10 * 17_408 + 34_816 + 8_192),
    (torch.float32, 64, 4): (False, 2 * 17_408 + 34_816 + 8_192),
}


@pytest.mark.parametrize("dt,h,nh", CASES, ids=IDS)
def test_node_bwd_plan_resident_or_ring(dt, h, nh):
    resident, smem = RESIDENCY[(dt, h, nh)]
    p = HN.node_bwd_plan(4096, h, nh, dt, H100_SMS, H100_SMEM)
    assert p["resident"] is resident
    assert p["smem_bytes"] == smem <= H100_SMEM


@pytest.mark.parametrize("n_rows,sms,grid", [(1024, 132, 8), (128, 132, 1),
                                             (2048, 4, 4)])
def test_node_bwd_plan_small_grids(n_rows, sms, grid):
    p = HN.node_bwd_plan(n_rows, 64, 2, torch.float32, sms, H100_SMEM)
    assert p["grid"] == grid and p["n_chunks"] == n_rows // 128


@pytest.mark.parametrize("n_rows,nh,smem", [
    (1000, 2, H100_SMEM), (0, 2, H100_SMEM), (-128, 2, H100_SMEM),
    (1024, -1, H100_SMEM), (1024, 2, 100_000)])
def test_node_bwd_plan_refuses(n_rows, nh, smem):
    """Rows not whole chunks (none or fewer), a negative number of hidden
    layers, and fp32 at h = 128 on a card with too little shared memory."""
    with pytest.raises(ValueError):
        HN.node_bwd_plan(n_rows, 128, nh, torch.float32, H100_SMS, smem)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("nh", [9, 12, 16])
def test_node_bwd_plan_deep_stacks(dt, nh):
    """Stacks deeper than the ReLU masks the row kernel keeps in registers
    (csrc/rows_bwd.cuh kMaxHidden = 8; it reads the rest back from the
    activations it stored) are planned like any other: the weights stream
    through the ring, the workspace grows with the stack."""
    isz = 2 if dt == torch.bfloat16 else 4
    ld = 128 + 16 // isz
    p = HN.node_bwd_plan(FLAGSHIP_N, 128, nh, dt, H100_SMS, H100_SMEM)
    assert p["resident"] is False
    assert p["smem_bytes"] == (2 * 128 * ld * isz
                               + (128 * ld * 4 if isz == 4 else 0)
                               + 2 * 2 * 8 * 128 * 4) <= H100_SMEM
    assert p["part_len"] == (nh + 3) * 128 * 128 + (nh + 4) * 128
    row = FLAGSHIP_N * 128 * isz
    assert p["ws_bytes"] == p["acts_offset"] + (2 * nh + 3) * row
