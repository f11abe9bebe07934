"""The port's CLI on the CPU (``--device cpu``): train -> infer with the
artifact contract of tests/test_cli.py, run directories crossing between
the two packages both ways (errors.txt numbers within the report
tolerance), resume through the config, the precision mapping and the
refusals."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from aero_gnn_tpu import cli as jcli
from aero_gnn_tpu_torch import cli
from test_torch_inference_report import assert_report_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("model_weights.pkl", "normalization_stats.npz",
             "experiment_params.json", "training_losses.json",
             "training_summary.txt", "metrics.jsonl")
TINY = {"dataset": "synthetic_airfoil", "model": "meshgraphnet",
        "training": "default", "n_cases": 16, "n_points": 48,
        "hidden_dim": 16, "processor_size": 2, "batch_size": 4,
        "epochs": 3, "early_stopping": False, "checkpoint_every": 2,
        "validation_split": 0.25, "test_split": 0.25}
# model sections of the port's default.yaml that the JAX package lacks
PORT_ONLY_MODELS = ("transolver",)


@pytest.fixture(autouse=True)
def _restore_matmul_precision():
    """setup_precision sets torch's process-wide matmul precision."""
    prev = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    cfg = yaml.safe_load(open(cli.DEFAULT_CONFIG))
    port_only = {k: cfg["model"].pop(k) for k in PORT_ONLY_MODELS}
    assert cfg == yaml.safe_load(open(jcli.DEFAULT_CONFIG)), \
        "the port's default.yaml holds the JAX package's experiments"
    cfg["model"].update(port_only)
    cfg["experiments"]["tiny"] = TINY
    cfg["experiments"]["tiny_resume"] = dict(TINY, epochs=4, resume=True)
    path = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    yaml.safe_dump(cfg, open(path, "w"))
    return str(path)


def _inference_dirs(run_dir):
    return sorted(d for d in os.listdir(run_dir)
                  if d.startswith("inference_results_"))


def _errors(run_dir):
    (d,) = _inference_dirs(run_dir)
    return open(os.path.join(run_dir, d, "errors.txt")).read()


def _copy_without_reports(src, dst):
    shutil.copytree(src, dst)
    for d in _inference_dirs(dst):
        shutil.rmtree(os.path.join(dst, d))


@pytest.fixture(scope="module")
def port_run(tiny_config, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port") / "run")
    cli.main(["train", "--exp", "tiny", "--config", tiny_config,
              "--output_dir", out, "--device", "cpu"])
    return out


@pytest.fixture(scope="module")
def jax_run(tiny_config, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "run")
    jcli.main(["train", "--exp", "tiny", "--config", tiny_config,
               "--output_dir", out])
    return out


def test_train_then_infer_roundtrip(port_run, tmp_path):
    for f in ARTIFACTS:
        assert os.path.exists(os.path.join(port_run, f)), f
    losses = json.load(open(os.path.join(port_run, "training_losses.json")))
    assert losses["total_epochs"] == 3 and len(losses["train_losses"]) == 3
    assert os.listdir(os.path.join(port_run, "checkpoints")) == \
        ["ckpt_00000002.pt"]
    metrics = [json.loads(ln) for ln in
               open(os.path.join(port_run, "metrics.jsonl"))]
    assert [m["step"] for m in metrics] == [0, 1, 2]
    errors = _errors(port_run)
    assert errors.startswith("TEST_MEAN | rrmse:")
    # infer reproduces the post-train report from the saved artifacts
    run = str(tmp_path / "run")
    _copy_without_reports(port_run, run)
    cli.main(["infer", "--training_dir", run, "--device", "cpu"])
    assert _errors(run).splitlines()[0] == errors.splitlines()[0]


def test_resume_through_config(port_run, tiny_config, tmp_path):
    run = str(tmp_path / "run")
    _copy_without_reports(port_run, run)
    first = json.load(open(os.path.join(run, "training_losses.json")))
    cli.main(["train", "--exp", "tiny_resume", "--config", tiny_config,
              "--output_dir", run, "--device", "cpu"])
    losses = json.load(open(os.path.join(run, "training_losses.json")))
    # resumed at epoch 2 (the checkpoint), then epochs 2 and 3
    assert losses["total_epochs"] == 4
    assert losses["train_losses"][:2] == first["train_losses"][:2]
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == \
        ["ckpt_00000002.pt", "ckpt_00000004.pt"]


def test_jax_run_served_by_port(jax_run, tmp_path):
    run = str(tmp_path / "run")
    _copy_without_reports(jax_run, run)
    cli.main(["infer", "--training_dir", run, "--device", "cpu"])
    assert_report_close(_errors(run), _errors(jax_run))


def test_port_run_served_by_jax(port_run, tmp_path):
    run = str(tmp_path / "run")
    _copy_without_reports(port_run, run)
    jcli.main(["infer", "--training_dir", run])
    assert_report_close(_errors(run), _errors(port_run))


_UNPICKLE = """
import json, os, sys
from aero_gnn_tpu_torch.models.registry import build_model
from aero_gnn_tpu_torch.training import checkpoint as C
run = sys.argv[1]
exp = json.load(open(os.path.join(run, "experiment_params.json")))
cfg = build_model(exp["model"], dict(input_node_dim=6, input_edge_dim=3,
                                     output_node_dim=4))
params = C.load_params(os.path.join(run, "model_weights.pkl"), cfg,
                       device="cpu")
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib"))
assert not bad, bad
print(sum(p.numel() for p in params.parameters()))
"""


def test_jax_weights_unpickle_without_jax(jax_run):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _UNPICKLE, jax_run],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 0


def test_unknown_experiment(tiny_config):
    with pytest.raises(ValueError, match="not found in configuration"):
        cli.main(["train", "--exp", "nope", "--config", tiny_config,
                  "--device", "cpu"])


def test_needs_a_card_or_device_cpu(monkeypatch, tiny_config, port_run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "--exp", "tiny", "--config", tiny_config])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["infer", "--training_dir", port_run])


def test_setup_precision(capsys):
    cli.setup_precision({"training": {"precision": "single"}})
    assert "single precision" in capsys.readouterr().out
    assert torch.get_float32_matmul_precision() == "highest"
    cli.setup_precision({"training": {"precision": "bf16"}})
    assert "bfloat16" in capsys.readouterr().out
    assert torch.get_float32_matmul_precision() == "medium"
    cli.setup_precision({"training": {"precision": "fp16"}})
    out = capsys.readouterr().out
    assert "no fp16 compute path" in out and "bfloat16" in out
    with pytest.raises(ValueError, match="no float64 path"):
        cli.setup_precision({"training": {"precision": "double"}})
    with pytest.raises(ValueError, match="Unknown precision"):
        cli.setup_precision({"training": {"precision": "int8"}})


@pytest.mark.parametrize("kind", ["meshgraphnet", "bsms_mgn", "fouriermgn",
                                  "poolMGN", "trial1", "mlpnet"])
def test_model_weights_round_trip(kind, tmp_path):
    """Every registry kind through model_weights.pkl: the port's save, the
    port's load and the JAX package's load give the same parameters."""
    from aero_gnn_tpu.training import checkpoint as JC
    from aero_gnn_tpu_torch.models.convert import params_to_jax
    from aero_gnn_tpu_torch.models.registry import build_model
    from aero_gnn_tpu_torch.training import checkpoint as C

    import jax

    cfg = build_model({"name": kind, "hidden_dim": 8, "processor_size": 3,
                       "num_scales": 2, "layers_per_scale": 1,
                       "num_message_passing_layers": 2},
                      dict(input_node_dim=6, input_edge_dim=3,
                           output_node_dim=4))
    params = cfg.init(3, device="cpu")
    path = str(tmp_path / "model_weights.pkl")
    C.save_params(path, params, cfg)
    back = C.load_params(path, cfg, device="cpu")
    for (n, a), (_, b) in zip(params.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n
    want = jax.tree_util.tree_leaves(params_to_jax(params, cfg))
    got = jax.tree_util.tree_leaves(JC.load_params(path))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
