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
print(" ".join(sorted(n for n in sys.modules
                      if n.startswith("aero_gnn_tpu_torch"))))
assert not bad, bad
"""

# modules the walk must reach: the CLI path's (config, data I/O, reports,
# persistence) besides the model and kernel modules
_MUST_IMPORT = ("cli", "config.config", "data.vtk_core", "data.vtk_geometry",
                "data.vtk_reader", "data.vtk_writer", "data.mesh_io",
                "inference.aero_coeffs", "inference.rollout",
                "training.checkpoint", "training.artifacts",
                "utils.logging")


def test_import_pulls_in_no_jax():
    # a subprocess: tests/conftest.py has already imported JAX here
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 15
    missing = [m for m in _MUST_IMPORT
               if f"aero_gnn_tpu_torch.{m}" not in imported]
    assert not missing, missing


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

    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.data.dataset import MeshSample
    from aero_gnn_tpu_torch.training import loop

    opt = loop.make_optimizer(params, 1e-3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.make_step_fns(cfg, opt)
    fns = loop.make_step_fns(cfg, opt, device="cpu")
    assert np.isfinite(float(fns.train_step(params, gb)))
    sample = MeshSample(pos=g["pos"], normals=g["pos"], senders=s,
                        receivers=(s + 1) % n, y=np.zeros((n, 1), np.float32),
                        meta={}, x=g["x"], edge_attr=g["edge_attr"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Loader([sample], 1)
    loader = Loader([sample], 1, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.fit(model_cfg=cfg, params=params, train_loader=loader,
                 val_loader=loader, training_config={"epochs": 1})
    res = loop.fit(model_cfg=cfg, params=params, train_loader=loader,
                   val_loader=loader, training_config={"epochs": 1},
                   log_fn=lambda _: None, device="cpu")
    assert res.epochs_run == 1


@pytest.mark.parametrize("name", ["meshgraphnet", "fouriermgn", "poolMGN",
                                  "trial1", "mlpnet"])
def test_registry_models_need_explicit_cpu(monkeypatch, name):
    """A registry model (build_model -> init -> AeroInference /
    make_step_fns over a Loader batch) raises without device="cpu" when
    there is no CUDA device, and serves and trains with it."""
    from aero_gnn_tpu_torch.data import dataset as D
    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.data.synthetic import make_random_mesh_sample
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.models.registry import build_model
    from aero_gnn_tpu_torch.training import loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = make_random_mesh_sample(n_nodes=300, seed=0)
    D.compute_features([s], ["mach", "alpha"])
    cfg = build_model({"name": name, "hidden_dim": 8, "processor_size": 2,
                       "num_message_passing_layers": 2},
                      dict(input_node_dim=6, input_edge_dim=3,
                           output_node_dim=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.init(0)
    params = cfg.init(0, device="cpu")
    stats = {"target_mean": 0.0, "target_std": 1.0}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AeroInference(cfg, params, stats)
    g, aux = next(iter(Loader([s], 1, device="cpu")))
    eng = AeroInference(cfg, params, stats, device="cpu")
    pred = eng.predict_batch(g, aux)[0][0]
    assert pred.shape == (s.num_nodes, 4) and np.isfinite(pred).all()
    opt = loop.make_optimizer(params, 1e-3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.make_step_fns(cfg, opt)
    fns = loop.make_step_fns(cfg, opt, device="cpu")
    assert np.isfinite(float(fns.train_step(params, g)))


def test_bsms_entry_points_need_explicit_cpu(monkeypatch):
    """The BSMS entry points (the Loader with hierarchies, the hierarchy
    builders, BSMSConfig.init, the engine and the steps with
    needs_hierarchy) raise without device="cpu" when there is no CUDA
    device, and run with it."""
    from aero_gnn_tpu_torch.data import dataset as D
    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.data.synthetic import make_random_mesh_sample
    from aero_gnn_tpu_torch.graph import hierarchy as H
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.models.bsms import BSMSConfig
    from aero_gnn_tpu_torch.training import loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = make_random_mesh_sample(n_nodes=300, seed=0)
    D.compute_features([s], ["mach", "alpha"])
    kw = dict(senders=s.senders, receivers=s.receivers,
              node_graph=np.zeros(s.num_nodes, np.int64),
              num_nodes=s.num_nodes, pos=s.pos, num_scales=3,
              mode="bistride")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Loader([s], 1, num_scales=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H.build_hierarchy(**kw)
    levels = H.build_hierarchy(**kw, device="cpu")
    real = [H.build_hierarchy_real(**kw)]
    plan = [(lv.num_coarse_nodes_pad, lv.num_coarse_edges_pad)
            for lv in levels]
    ckw = dict(num_fine_nodes_pad=512, num_fine_edges_pad=2048,
               pad_plan=plan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H.collate_hierarchies(real, **ckw)
    collated = H.collate_hierarchies(real, **ckw, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H.align_hierarchy(collated)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        levels[0].to(None)
    cfg = BSMSConfig(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
                     processor_size=3, num_scales=3, layers_per_scale=1,
                     hidden_dim_processor=8, hidden_dim_node_encoder=8,
                     hidden_dim_edge_encoder=8, hidden_dim_decoder=8,
                     hierarchy_mode="bistride", transfer="weighted")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.init(0)
    params = cfg.init(0, device="cpu")
    stats = {"target_mean": 0.0, "target_std": 1.0}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AeroInference(cfg, params, stats, needs_hierarchy=True)
    opt = loop.make_optimizer(params, 1e-3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.make_step_fns(cfg, opt, needs_hierarchy=True)
    loader = Loader([s], 1, num_scales=3, hierarchy_mode="bistride",
                    device="cpu")
    g, aux = next(iter(loader))
    eng = AeroInference(cfg, params, stats, device="cpu",
                        needs_hierarchy=True)
    assert eng.predict_single(g, aux)[0].shape == (s.num_nodes, 4)
    fns = loop.make_step_fns(cfg, opt, device="cpu", needs_hierarchy=True)
    assert np.isfinite(float(fns.train_step(params, g, aux["hierarchy"])))
    res = loop.fit(model_cfg=cfg, params=params, train_loader=loader,
                   val_loader=loader, training_config={"epochs": 1},
                   needs_hierarchy=True, log_fn=lambda _: None, device="cpu")
    assert res.epochs_run == 1


def test_default_device_is_the_indexed_current_card(monkeypatch):
    """None / "cuda" resolve to the current card with its index, the device
    tensors report, so the entry points' device checks (make_step_fns,
    apply_model) compare equal on the card."""
    from aero_gnn_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
