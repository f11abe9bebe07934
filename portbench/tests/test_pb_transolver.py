"""The Transolver cell and the 1M-node MGN cell: tiny runs of
``transolver-train-65k`` through ``run.run_cell`` on the CPU (untraced,
traced, each fault planted) and of ``mgn-train-1m``; Transolver's
operation and byte counts against counts made by hand; the new traffic
and limits files."""

import json
import math

import pytest

from portbench import flops_transolver as FT
from portbench import run
from portbench.tests.conftest import ROOT

# the program's spans and counters a CPU trace can read in the cell
ON_CPU = ("graph_build_ms.train", "to_device_ms.train", "pad_ratio.train",
          "node_pad_ratio.train")


def test_transolver_cell_runs(tiny):
    m = run.Manifest(tiny)
    out = run.run_cell(m, "transolver-train-65k", 2**31 + 21, 0.3, False,
                       device="cpu")
    line = out["line"]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"setup_s", "train_step_ms"}
    assert line["attempted"] > 0 and line["failed"] == 0
    traced = run.run_cell(m, "transolver-train-65k", 2**31 + 22, 0.3, True,
                          device="cpu")
    got = traced["line"]["metrics"]
    assert traced["line"]["correct"] is True, traced["line"]["checks"]
    for name in ON_CPU:
        assert name in got and math.isfinite(got[name]["value"]), name
    # the MGN-only readers are not asked in this cell
    assert "mfu.train" not in got and "edge_bwd_roofline.train" not in got


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_transolver_fault_is_caught(tiny, fault):
    m = run.Manifest(tiny)
    out = run.run_cell(m, "transolver-train-65k", 2**33 + 9, 0.2, False,
                       device="cpu", fault=fault)
    assert out["line"]["correct"] is False, out["line"]["checks"]


def test_1m_cell_runs_at_a_tiny_size(tiny):
    m = run.Manifest(tiny)
    out = run.run_cell(m, "mgn-train-1m", 2**31 + 23, 0.2, False,
                       device="cpu")
    assert out["line"]["correct"] is True, out["line"]["checks"]
    assert set(out["line"]["checks"]) == {"loss_gap", "grad_gap",
                                          "update_med_gap"}


CFG = {"model": {"hidden_dim": 8, "num_heads": 2, "slice_num": 3,
                 "mlp_ratio": 2},
       "dims": {"input_node_dim": 6, "input_edge_dim": 3,
                "output_node_dim": 4},
       "peak_ops_per_s": 100.0, "peak_bytes_per_s": 10.0}


def test_physattn_counts_by_hand():
    # h = 8, 2 heads of C = 4, 3 slices. A point: in_fx, in_x 2 x 64,
    # in_slice 2 heads x 4 x 3 = 24, w^T fx and w z' 2 x 24, to_out 64:
    # 264 MACs. A graph: q, k, v 2 x 3 x 3 x 16 = 288, q k^T and attn v
    # 2 x 2 x 9 x 4 = 144: 432 MACs.
    assert FT.physattn_point_ops(CFG) == 2 * 264
    assert FT.physattn_graph_ops(CFG) == 2 * 432
    # weights: 3 x (64 + 8) + 12 + 3 + 2 + 3 x 16 = 281; u and out 2 x 5 x 8
    ops, nbytes = FT.physattn_fwd_work(CFG, 5)
    assert ops == 2 * (5 * 264 + 432)
    assert nbytes == 4 * (80 + 281)
    # backward: twice the operations; u, d_out, weights read, d_u and the
    # weight gradients written
    ops, nbytes = FT.physattn_bwd_work(CFG, 5)
    assert ops == 4 * (5 * 264 + 432)
    assert nbytes == 4 * (80 + 281 + 40 + 281)


def test_transolver_forward_by_hand():
    # preprocess 6 -> 16 -> 8: 96 + 128 = 224 a point; head 32; a layer's
    # MLP 8 -> 16 -> 8: 256 a point
    per_point = 224 + 32 + 3 * (264 + 256)
    macs = 5 * per_point + 3 * 432
    assert FT.forward_ops(CFG, [(3, 5, 0)]) == 2 * macs
    assert FT.train_ops(CFG, [(3, 5, 0)]) == 3 * 2 * macs


def test_least_time_over_profiled_graphs():
    class View:
        config = CFG
        profiled = [[[(3, 5, 0)]], [[(3, 5, 0)], [(3, 7, 0)]]]

    def least(work, n):
        ops, nbytes = work(CFG, n)
        return 3 * max(ops / 100.0, nbytes / 10.0)

    assert FT.least_physattn_s(View, backward=False) == pytest.approx(
        2 * least(FT.physattn_fwd_work, 5) + least(FT.physattn_fwd_work, 7))
    assert FT.least_physattn_s(View, backward=True) == pytest.approx(
        2 * least(FT.physattn_bwd_work, 5) + least(FT.physattn_bwd_work, 7))


def test_new_data_files():
    tr = json.loads((ROOT / "portbench/traffic/train-1m.json").read_text())
    assert {k: tr[k] for k in ("kind", "nodes", "avg_degree", "pool",
                               "batch_size", "warm_epochs", "check_steps",
                               "profile_steps")} == {
        "kind": "train", "nodes": 1048576, "avg_degree": 6, "pool": 4,
        "batch_size": 1, "warm_epochs": 1, "check_steps": 2,
        "profile_steps": 3}
    limits = {c: json.loads((ROOT / "portbench/limits" / (c + ".json"))
                            .read_text())
              for c in ("mgn-train-1m", "transolver-train-65k")}
    assert set(limits["mgn-train-1m"]) == {"loss_gap", "grad_gap",
                                           "update_med_gap"}
    assert set(limits["transolver-train-65k"]) == {"loss_gap", "grad_gap",
                                                   "update_med_gap"}
    assert all(0 < v < 1 for d in limits.values() for v in d.values())
