"""Tests of the benchmark. Tiny manifests on the CPU, except those marked
``card``, which need a CUDA device and skip without one (decided inside
the ``cuda_device`` fixture, never at import).

Run with ``python -m pytest portbench/tests -q`` from the repository root.
"""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 and the port's kernels exist "
                    "only on the card")
    return "cuda"


def tiny_manifest(dest: Path, nodes: int = 300, cut: bool = True) -> Path:
    """A copy of BENCHMARK.json whose traffic is cut to ``nodes``-node
    meshes and (``cut``) whose configurations to width 16 (2 layers MGN, 6
    layers BSMS), with the cells' own limits, under ``dest``."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits"):
        (dest / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        if cut:
            cfg["model"]["hidden_dim"] = 16
            cfg["model"]["processor_size"] = 6 if "bsms" in c["name"] else 2
        c["file"] = c["file"].replace(".json", "-tiny.json")
        (dest / c["file"]).write_text(json.dumps(cfg))
    for w in b["workloads"]:
        t = json.loads((ROOT / "portbench/traffic" /
                        (w["traffic"] + ".json")).read_text())
        t["nodes"], t["pool"] = nodes, min(t["pool"], 4)
        w["traffic"] += "-tiny"
        (dest / "portbench/traffic" / (w["traffic"] + ".json")).write_text(
            json.dumps(t))
        shutil.copy(ROOT / "portbench/limits" / (w["name"] + ".json"),
                    dest / "portbench/limits")
    path = dest / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    return path


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_manifest(tmp_path)
