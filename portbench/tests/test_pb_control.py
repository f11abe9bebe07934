"""The control -- the reference in the precision below the
configuration's, in the program's place -- comes out not correct under
each cell's limits, with the configurations uncut on small meshes (the
rounding error grows with depth). fp8 rounding runs on the CPU; TF32
exists only on the card, so the float32 configuration's control runs there
(marked ``card``); the calibration on the chip (``portbench.calibrate``)
reads it at the cells' own sizes."""

import pytest

from portbench import calibrate, check, run
from portbench.tests.conftest import tiny_manifest

SEEDS = (2**32 + 1, 7, 8)


@pytest.mark.parametrize("workload", ["mgn-train-65k", "mgn-serve-65k"])
def test_fp8_control_fails(tmp_path, workload):
    m = run.Manifest(tiny_manifest(tmp_path, nodes=512, cut=False))
    limits = m.limits(m.cells[workload])
    for seed in SEEDS:
        got, _ = calibrate.control_numbers(m, workload, seed, "cpu")
        assert check.judge(got, limits) is False, got


@pytest.mark.card
@pytest.mark.parametrize("workload", ["mgn-train-65k", "bsms-train-65k",
                                      "mgn-serve-65k"])
def test_control_fails_on_card(tmp_path, cuda_device, workload):
    m = run.Manifest(tiny_manifest(tmp_path, nodes=8192, cut=False))
    limits = m.limits(m.cells[workload])
    for seed in SEEDS:
        got, _ = calibrate.control_numbers(m, workload, seed, cuda_device)
        assert check.judge(got, limits) is False, got
