"""K1's launch plan (``hopper_fused.edge_fwd_plan``), computed in Python
and checked on the CPU: the row kernel's grid, whether the chain's weights
stay resident in shared memory or stream through the two-slot ring, the
shared memory against the H100's 227 KB a CTA may have, the row pointer's
workspace, and the refusals."""

import pytest
import torch

from aero_gnn_tpu_torch.ops import hopper_fused as HF

CASES = [(dt, h, nh) for dt in (torch.bfloat16, torch.float32)
         for h in (64, 128) for nh in (0, 2, 4, 9)]
IDS = [f"{str(dt)[6:]}-h{h}-nh{nh}" for dt, h, nh in CASES]
FLAGSHIP_E, FLAGSHIP_N, H100_SMS, H100_SMEM = 264_192, 66_048, 132, 232_448


def _expect(dt, h, nh, max_smem=H100_SMEM):
    """(resident, shared bytes) from csrc/chain.cuh's Layout: [h][h + 16
    bytes] weight tiles, and in fp32 the warps' [128][h + 4] A operand
    slices."""
    isz = 2 if dt == torch.bfloat16 else 4
    mat = h * (h + 16 // isz) * isz
    fixed = 128 * (h + 4) * 4 if isz == 4 else 0
    resident = (nh + 2) * mat + fixed <= max_smem
    return resident, (nh + 2 if resident else 2) * mat + fixed


@pytest.mark.parametrize("dt,h,nh", CASES, ids=IDS)
def test_edge_fwd_plan_flagship(dt, h, nh):
    p = HF.edge_fwd_plan(FLAGSHIP_E, FLAGSHIP_N, h, nh, dt, H100_SMS,
                         H100_SMEM)
    resident, smem = _expect(dt, h, nh)
    assert p["n_chunks"] == FLAGSHIP_E // 128 == 2064
    assert p["grid"] == H100_SMS
    assert p["resident"] is resident
    assert p["smem_bytes"] == smem <= H100_SMEM
    assert p["ws_bytes"] == 4 * (FLAGSHIP_N + 1)


@pytest.mark.parametrize("dt,h,nh,resident", [
    (torch.bfloat16, 128, 2, True), (torch.bfloat16, 128, 4, True),
    (torch.bfloat16, 128, 5, False), (torch.float32, 128, 0, True),
    (torch.float32, 128, 1, False),
    (torch.float32, 64, 9, True), (torch.float32, 64, 10, False)])
def test_edge_fwd_plan_resident_or_ring(dt, h, nh, resident):
    """The flagship's bf16 weights (4 x 34.8 KB) stay resident up to 4
    hidden layers; fp32 at h = 128 (67.6 KB a weight) streams from one
    hidden layer up."""
    p = HF.edge_fwd_plan(FLAGSHIP_E, FLAGSHIP_N, h, nh, dt, H100_SMS,
                         H100_SMEM)
    assert p["resident"] is resident


@pytest.mark.parametrize("dt,n_edges,sms,grid", [
    (torch.float32, 1024, 132, 8), (torch.float32, 128, 132, 1),
    (torch.float32, 2048, 4, 4), (torch.bfloat16, 1024, 132, 8),
    (torch.bfloat16, 128, 132, 1)])
def test_edge_fwd_plan_small_grids(dt, n_edges, sms, grid):
    """One CTA per 128-row chunk (8 warps of 16 rows) at most."""
    p = HF.edge_fwd_plan(n_edges, 512, 64, 2, dt, sms, H100_SMEM)
    assert p["grid"] == grid and p["n_chunks"] == n_edges // 128


@pytest.mark.parametrize("n_edges,n_nodes,nh,smem", [
    (1000, 512, 2, H100_SMEM), (0, 512, 2, H100_SMEM),
    (-128, 512, 2, H100_SMEM), (1024, 0, 2, H100_SMEM),
    (1024, 512, -1, H100_SMEM), (1024, 512, 2, 150_000)])
def test_edge_fwd_plan_refuses(n_edges, n_nodes, nh, smem):
    """Rows not whole chunks (none or fewer), no nodes, a negative number
    of hidden layers, and fp32 at h = 128 on a card with too little shared
    memory for the ring and the A operand slices."""
    with pytest.raises(ValueError):
        HF.edge_fwd_plan(n_edges, n_nodes, 128, nh, torch.float32, H100_SMS,
                         smem)
