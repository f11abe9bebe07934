"""A run loads neither JAX nor the JAX package, and the reference loads
nothing of the port."""

import json
import subprocess
import sys

from portbench.tests.conftest import ROOT

JAX = ("jax", "jaxlib", "flax", "aero_gnn_tpu")


def _fresh(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
                              "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_run_loads_no_jax(tiny):
    got = _fresh(
        "import json, sys\n"
        "from pathlib import Path\n"
        "from portbench import run\n"
        f"m = run.Manifest(Path({str(tiny)!r}))\n"
        "r = run.run_cell(m, 'mgn-train-65k', 2**31 + 7, 0.2, False, "
        "device='cpu')\n"
        "tops = sorted({k.split('.', 1)[0] for k in sys.modules})\n"
        "print(json.dumps({'tops': tops, 'line': r['line']}))\n")
    assert "aero_gnn_tpu_torch" in got["tops"]
    assert not set(got["tops"]) & set(JAX)
    assert got["line"]["attempted"] > 0


def test_reference_loads_nothing_of_the_port():
    got = _fresh(
        "import json, sys\n"
        "import portbench.reference.mgn, portbench.reference.bsms\n"
        "import portbench.reference.train, portbench.check\n"
        "import portbench.flops, portbench.inputs, portbench.weights\n"
        "print(json.dumps(sorted({k.split('.', 1)[0] "
        "for k in sys.modules})))\n")
    assert "aero_gnn_tpu_torch" not in got
    assert not set(got) & set(JAX)


def test_no_card_no_result(tiny):
    """On a machine without enough CUDA devices the command fails and
    prints no result line."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mgn-train-65k", "--seed", "1", "--seconds", "1", "--trace", "0",
         "--manifest", str(tiny)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
