"""The port stands alone: it imports neither JAX nor aero_gnn_tpu, and its
entry points need device="cpu" when there is no CUDA device."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "aero_gnn_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import aero_gnn_tpu_torch
for m in pkgutil.walk_packages(aero_gnn_tpu_torch.__path__,
                               "aero_gnn_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "aero_gnn_tpu"))
print("imported", len([n for n in sys.modules
                       if n.startswith("aero_gnn_tpu_torch")]))
assert not bad, bad
"""


def test_import_pulls_in_no_jax():
    # a subprocess: tests/conftest.py has already imported JAX here
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "aero_gnn_tpu"}, roots


def test_entry_points_need_explicit_cpu(monkeypatch):
    from aero_gnn_tpu_torch.graph import padded
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.models.mgn import MGNConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 8
    s = np.arange(n)
    g = dict(senders=s, receivers=(s + 1) % n,
             x=np.zeros((n, 2), np.float32),
             edge_attr=np.zeros((n, 3), np.float32),
             pos=np.zeros((n, 2), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        padded.build_graph_batch(**g)
    gb = padded.build_graph_batch(**g, device="cpu")
    cfg = MGNConfig(input_node_dim=2, input_edge_dim=3, output_node_dim=1,
                    processor_size=1, hidden_dim_processor=8,
                    hidden_dim_node_encoder=8, hidden_dim_edge_encoder=8,
                    hidden_dim_decoder=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.init(0)
    params = cfg.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AeroInference(cfg, params, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gb.to(None)
    eng = AeroInference(cfg, params, {"target_mean": 0.0, "target_std": 1.0},
                        device="cpu")
    assert eng.predict_single(gb)[0].shape == (n, 1)
