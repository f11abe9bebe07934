"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a chip skipped, each fault a cell can have planted in
the port's timed path, the cell's own limits."""

import pytest

from portbench import run


@pytest.mark.parametrize("workload,fault", [
    ("mgn-train-65k", "frozen_state"), ("mgn-train-65k", "half_batch"),
    ("bsms-train-65k", "frozen_state"), ("bsms-train-65k", "half_batch"),
    ("mgn-serve-65k", "altered_answer")])
def test_fault_is_caught(tiny, workload, fault):
    m = run.Manifest(tiny)
    out = run.run_cell(m, workload, 2**33 + 9, 0.2, False, device="cpu",
                       fault=fault, min_requests=4)
    assert out["line"]["correct"] is False, out["line"]["checks"]
