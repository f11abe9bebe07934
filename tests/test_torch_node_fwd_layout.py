"""K3's launch plan (``hopper_node.node_fwd_plan``) and K9-fwd's
(``hopper_mega.mega_fwd_plan``), computed in Python and checked on the
CPU against an independent reckoning: the grid, whether each chain's
weights stay resident in shared memory or stream through the two-slot
ring, the shared memory against the H100's 227 KB a CTA may have, and the
refusals."""

import pytest
import torch

from aero_gnn_tpu_torch.ops import hopper_mega as HM
from aero_gnn_tpu_torch.ops import hopper_node as HN

CASES = [(dt, h, nh) for dt in (torch.bfloat16, torch.float32)
         for h in (64, 128) for nh in (0, 2, 4, 9)]
IDS = [f"{str(dt)[6:]}-h{h}-nh{nh}" for dt, h, nh in CASES]
FLAGSHIP_E, FLAGSHIP_N, H100_SMS, H100_SMEM = 264_192, 66_048, 132, 232_448


def _mat_and_slices(dt, h):
    """csrc/chain.cuh's Layout: an [h][h + 16 bytes] weight tile, and in
    fp32 the warps' [128][h + 4] A operand slices."""
    isz = 2 if dt == torch.bfloat16 else 4
    mat = h * (h + 16 // isz) * isz
    return mat, (128 * (h + 4) * 4 if isz == 4 else 0)


def _expect_node(dt, h, nh, max_smem=H100_SMEM):
    """(resident, shared bytes) of K3: the nh + 3 weights, or two slots."""
    mat, slices = _mat_and_slices(dt, h)
    resident = (nh + 3) * mat + slices <= max_smem
    return resident, (nh + 3 if resident else 2) * mat + slices


def _expect_mega(dt, h, nh, max_smem=H100_SMEM):
    """(resident, shared bytes) of K9-fwd with nh hidden layers in both
    chains: the node chain's nh + 3 weights (the larger set; the edge
    chain's nh + 2 use the same slots first), or a ring of two slots;
    besides, each of the 256 nodes' two live-row bounds and 4 ints of tile
    range."""
    mat, slices = _mat_and_slices(dt, h)
    fixed = slices + (2 * 256 + 4) * 4
    resident = (nh + 3) * mat + fixed <= max_smem
    return resident, (nh + 3 if resident else 2) * mat + fixed


@pytest.mark.parametrize("dt,h,nh", CASES, ids=IDS)
def test_node_fwd_plan_flagship(dt, h, nh):
    p = HN.node_fwd_plan(FLAGSHIP_N, h, nh, dt, H100_SMS, H100_SMEM)
    resident, smem = _expect_node(dt, h, nh)
    assert p["n_chunks"] == FLAGSHIP_N // 128 == 516
    assert p["grid"] == H100_SMS
    assert p["resident"] is resident
    assert p["smem_bytes"] == smem <= H100_SMEM


@pytest.mark.parametrize("dt,h,nh,resident", [
    (torch.bfloat16, 128, 2, True), (torch.bfloat16, 128, 3, True),
    (torch.bfloat16, 128, 4, False), (torch.float32, 128, 0, False),
    (torch.float32, 64, 8, True), (torch.float32, 64, 9, False)])
def test_node_fwd_plan_resident_or_ring(dt, h, nh, resident):
    """The flagship's bf16 weights (5 x 34.8 KB) stay resident up to 3
    hidden layers; fp32 at h = 128 (67.6 KB a weight, and the A operand
    slices) always streams."""
    p = HN.node_fwd_plan(FLAGSHIP_N, h, nh, dt, H100_SMS, H100_SMEM)
    assert p["resident"] is resident


@pytest.mark.parametrize("dt,n_rows,sms,grid", [
    (torch.float32, 1024, 132, 8), (torch.float32, 128, 132, 1),
    (torch.float32, 2048, 4, 4), (torch.bfloat16, 1024, 132, 8),
    (torch.bfloat16, 128, 132, 1)])
def test_node_fwd_plan_small_grids(dt, n_rows, sms, grid):
    """One CTA per 128-row chunk (8 warps of 16 rows) at most."""
    p = HN.node_fwd_plan(n_rows, 64, 2, dt, sms, H100_SMEM)
    assert p["grid"] == grid and p["n_chunks"] == n_rows // 128


@pytest.mark.parametrize("n_rows,nh,smem", [
    (1000, 2, H100_SMEM), (0, 2, H100_SMEM), (-128, 2, H100_SMEM),
    (1024, -1, H100_SMEM), (1024, 2, 150_000)])
def test_node_fwd_plan_refuses(n_rows, nh, smem):
    """Rows not whole chunks (none or fewer), a negative number of hidden
    layers, and fp32 at h = 128 on a card with too little shared memory
    for the ring and the A operand slices."""
    with pytest.raises(ValueError):
        HN.node_fwd_plan(n_rows, 128, nh, torch.float32, H100_SMS, smem)


@pytest.mark.parametrize("dt,h,nh", CASES, ids=IDS)
def test_mega_fwd_plan_flagship(dt, h, nh):
    p = HM.mega_fwd_plan(FLAGSHIP_E, FLAGSHIP_N, h, nh, nh, dt, H100_SMS,
                         H100_SMEM)
    resident, smem = _expect_mega(dt, h, nh)
    assert p["grid"] == FLAGSHIP_N // 256 == 258 and p["waves"] == 2
    assert p["resident"] is resident
    assert p["smem_bytes"] == smem <= H100_SMEM


@pytest.mark.parametrize("dt,h,nh,ne_hidden,resident", [
    (torch.bfloat16, 128, 2, 2, True), (torch.bfloat16, 128, 3, 3, True),
    (torch.bfloat16, 128, 4, 4, False), (torch.bfloat16, 128, 0, 5, False),
    (torch.bfloat16, 64, 9, 9, True), (torch.float32, 128, 0, 0, False),
    (torch.float32, 64, 8, 8, True), (torch.float32, 64, 9, 9, False)])
def test_mega_fwd_plan_resident_or_ring(dt, h, nh, ne_hidden, resident):
    """The flagship's bf16 weights stay resident (5 x 34.8 KB, the node
    chain's, in the slots the edge chain's 4 used first) up to 3 hidden
    layers, and the deeper of the two chains decides; fp32 at h = 128
    streams both chains."""
    p = HM.mega_fwd_plan(FLAGSHIP_E, FLAGSHIP_N, h, ne_hidden, nh, dt,
                         H100_SMS, H100_SMEM)
    assert p["resident"] is resident


@pytest.mark.parametrize("n_nodes,sms,waves", [
    (66_048, 132, 2), (78_336, 132, 3), (33_792, 132, 1), (512, 4, 1)])
def test_mega_fwd_plan_waves(n_nodes, sms, waves):
    """One CTA a node block of 256: the flagship's 258 blocks take 2 waves
    on 132 SMs, the Loader graph's 306 take 3."""
    p = HM.mega_fwd_plan(2048, n_nodes, 128, 2, 2, torch.bfloat16, sms,
                         H100_SMEM)
    assert p["grid"] == n_nodes // 256 and p["waves"] == waves


@pytest.mark.parametrize("n_edges,n_nodes,nh,smem", [
    (1000, 512, 2, H100_SMEM), (0, 512, 2, H100_SMEM),
    (2048, 500, 2, H100_SMEM), (2048, 0, 2, H100_SMEM),
    (2048, 512, -1, H100_SMEM), (2048, 512, 2, 150_000)])
def test_mega_fwd_plan_refuses(n_edges, n_nodes, nh, smem):
    """Edge rows not whole tiles, nodes not whole blocks, a negative number
    of hidden layers, and fp32 at h = 128 on a card with too little shared
    memory for the ring and the A operand slices."""
    with pytest.raises(ValueError):
        HM.mega_fwd_plan(n_edges, n_nodes, 128, nh, 2, torch.float32,
                         H100_SMS, smem)
