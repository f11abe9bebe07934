"""The readers of the program's own spans and counters (portbench/program.py):
a tiny traced CPU run of each cell gives every such metric of the cell a
finite value (launches.train reads CUDA launch calls, which a CPU trace
lacks, so it is absent there), and the parts add up to what they split."""

import math

import pytest

from portbench import run

# metrics whose source the CPU has, by the cell that reports them
ON_CPU = {
    "mgn-train-65k": ("graph_build_ms.train", "to_device_ms.train",
                      "node_pad_ratio.train", "pad_ratio.train"),
    "bsms-train-65k": ("graph_build_ms.train", "to_device_ms.train",
                       "hierarchy_ms.train", "node_pad_ratio.train",
                       "pad_ratio.train"),
    "mgn-serve-65k": ("graph_build_ms.serve", "to_device_ms.serve",
                      "engine_wait_ms.serve", "node_pad_ratio.serve",
                      "pad_ratio.serve"),
}


@pytest.mark.parametrize("workload", sorted(ON_CPU))
def test_traced_cpu_run_reads_the_program(tiny, workload):
    from aero_gnn_tpu_torch.utils import profiling

    profiling.clear()
    m = run.Manifest(tiny)
    out = run.run_cell(m, workload, 2**31 + 11, 0.3, True, device="cpu",
                       min_requests=2)
    got = out["line"]["metrics"]
    for name in ON_CPU[workload]:
        assert name in got, name
        assert math.isfinite(got[name]["value"]), (name, got[name])
        assert got[name]["value"] >= 0, (name, got[name])
    assert "launches.train" not in got
    for ratio in ON_CPU[workload][-2:]:
        assert got[ratio]["value"] >= 1.0, (ratio, got[ratio])
    # the Loader's parts account for the benchmark's span around it
    kind = out["record"]["view"].kind
    parts = sum(got[n]["value"] for n in got
                if n.split(".")[0] in ("graph_build_ms", "to_device_ms",
                                       "hierarchy_ms"))
    loader = got[f"loader_ms.{kind}"]["value"]
    assert 0 < parts <= loader * 1.5
