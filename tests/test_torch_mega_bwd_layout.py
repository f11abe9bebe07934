"""K9-bwd's launch plan (``hopper_mega.mega_bwd_plan``), computed in
Python and checked on the CPU against an independent reckoning: one CTA a
node block and its waves, the weights resident in shared memory or both
chains streamed through the two-slot ring, the shared memory against the
H100's 227 KB a CTA may have, the weight gradients' splits (K2's and K4's
grids), the workspace's regions, and the refusals."""

import pytest
import torch

from aero_gnn_tpu_torch.ops import hopper_fused as HF
from aero_gnn_tpu_torch.ops import hopper_mega as HM
from aero_gnn_tpu_torch.ops import hopper_node as HN

CASES = [(dt, h, nh) for dt in (torch.bfloat16, torch.float32)
         for h in (64, 128) for nh in (0, 2, 9)]
IDS = [f"{str(dt)[6:]}-h{h}-nh{nh}" for dt, h, nh in CASES]
FLAGSHIP_E, FLAGSHIP_N, H100_SMS, H100_SMEM = 264_192, 66_048, 132, 232_448


def _expect_smem(dt, h, ne, nn, max_smem=H100_SMEM):
    """(resident, shared bytes): the larger chain's matrices (K2's ne + 2,
    K4's nn + 3; bf16 one copy each, fp32 W and W^T) in [h][h + 16 bytes]
    tiles, or two ring slots; fp32's [128][h + 4] A operand slices; a
    chunk's LayerNorm column sums ([2][8][h] fp32); 256 nodes' two live-row
    bounds and 4 ints of tile range."""
    isz = 2 if dt == torch.bfloat16 else 4
    mat = h * (h + 16 // isz) * isz
    n_mats = max(ne + 2, nn + 3) * (2 if isz == 4 else 1)
    fixed = ((128 * (h + 4) * 4 if isz == 4 else 0) + 2 * 8 * h * 4
             + (2 * 256 + 4) * 4)
    resident = n_mats * mat + fixed <= max_smem
    return resident, (n_mats if resident else 2) * mat + fixed


def _round(x):
    return (x + 255) // 256 * 256


@pytest.mark.parametrize("dt,h,nh", CASES, ids=IDS)
def test_mega_bwd_plan_flagship(dt, h, nh):
    p = HM.mega_bwd_plan(FLAGSHIP_E, FLAGSHIP_N, h, nh, nh, dt, H100_SMS,
                         H100_SMEM)
    resident, smem = _expect_smem(dt, h, nh, nh)
    assert p["grid"] == FLAGSHIP_N // 256 == 258 and p["waves"] == 2
    assert p["resident"] is resident
    assert p["smem_bytes"] == smem <= H100_SMEM
    # the weight gradients on K2's and K4's own splits
    k2 = HF.edge_bwd_plan(FLAGSHIP_E, FLAGSHIP_N, h, nh, dt, H100_SMS)
    k4 = HN.node_bwd_plan(FLAGSHIP_N, h, nh, dt, H100_SMS, H100_SMEM)
    assert p["edge_grid"] == k2["grid"] == H100_SMS
    assert p["node_grid"] == k4["grid"] == H100_SMS
    assert p["edge_part_len"] == k2["part_len"]
    assert p["node_part_len"] == k4["part_len"]
    assert p["dw_blocks"] == H100_SMS * ((nh + 2) + (nh + 3) + 2)
    assert p["dw_smem_bytes"] == k4["dw_smem_bytes"]
    # the regions in order, each at a multiple of 256 bytes
    isz = 2 if dt == torch.bfloat16 else 4
    eh, nh_rows = FLAGSHIP_E * h * isz, FLAGSHIP_N * h * isz
    sizes = [H100_SMS * k2["part_len"] * 4, H100_SMS * k4["part_len"] * 4,
             (nh + 1) * eh, (nh + 1) * eh, (2 * nh + 3) * nh_rows,
             2064 * 2 * 8 * h * 4, 516 * 2 * 8 * h * 4, nh_rows]
    names = ["edge_part", "node_part", "edge_acts", "edge_cots", "node_acts",
             "edge_sums", "node_sums", "d_agg"]
    at = 0
    for name, size in zip(names, sizes):
        assert p[f"{name}_offset"] == at, name
        at += _round(size)
    assert p["ws_bytes"] == at


@pytest.mark.parametrize("dt,h,ne,nn,resident", [
    (torch.bfloat16, 128, 2, 2, True), (torch.bfloat16, 128, 3, 3, True),
    (torch.bfloat16, 128, 4, 4, False), (torch.bfloat16, 128, 5, 0, False),
    (torch.bfloat16, 128, 4, 3, True), (torch.float32, 128, 0, 0, False),
    (torch.float32, 64, 2, 2, True), (torch.float32, 64, 3, 3, False)])
def test_mega_bwd_plan_resident_or_ring(dt, h, ne, nn, resident):
    """The flagship's bf16 weights stay resident (K4's 5 x 34.8 KB, in the
    slots K2's 4 take after them) up to 3 hidden layers, and the larger
    chain decides; fp32 at h = 128 (W and W^T, 67.6 KB each) streams both
    chains."""
    p = HM.mega_bwd_plan(FLAGSHIP_E, FLAGSHIP_N, h, ne, nn, dt, H100_SMS,
                         H100_SMEM)
    assert p["resident"] is resident
    assert p["smem_bytes"] == _expect_smem(dt, h, ne, nn)[1]


@pytest.mark.parametrize("n_edges,n_nodes,sms,waves,e_grid,n_grid", [
    (FLAGSHIP_E, 66_048, 132, 2, 132, 132),
    (558_080, 78_336, 132, 3, 132, 132), (2048, 33_792, 132, 1, 16, 132),
    (2048, 512, 4, 1, 4, 4), (2048, 512, 132, 1, 16, 4)])
def test_mega_bwd_plan_grids(n_edges, n_nodes, sms, waves, e_grid, n_grid):
    """One CTA a node block of 256: the flagship's 258 blocks take 2 waves
    on 132 SMs, the Loader graph's 306 take 3; the weight gradients split
    one per SM, at most one per 128-row chunk, for each chain apart."""
    p = HM.mega_bwd_plan(n_edges, n_nodes, 128, 2, 2, torch.bfloat16, sms,
                         H100_SMEM)
    assert p["grid"] == n_nodes // 256 and p["waves"] == waves
    assert (p["edge_grid"], p["node_grid"]) == (e_grid, n_grid)
    assert p["dw_blocks"] == max(e_grid, n_grid) * (4 + 5 + 2)


@pytest.mark.parametrize("n_edges,n_nodes,nh,smem", [
    (1000, 512, 2, H100_SMEM), (1152, 512, 2, H100_SMEM),
    (0, 512, 2, H100_SMEM), (2048, 500, 2, H100_SMEM),
    (2048, 0, 2, H100_SMEM), (2048, 512, -1, H100_SMEM),
    (2048, 512, 2, 150_000)])
def test_mega_bwd_plan_refuses(n_edges, n_nodes, nh, smem):
    """Edge rows not whole tiles (nor whole chunks, or whole chunks but not
    tiles, or none), nodes not whole blocks (or none), a negative number of
    hidden layers, and fp32 at h = 128 on a card with too little shared
    memory for the ring and the A operand slices."""
    with pytest.raises(ValueError):
        HM.mega_bwd_plan(n_edges, n_nodes, 128, nh, 2, torch.float32,
                         H100_SMS, smem)
