"""The plain reference against the port's torch backend at a few hundred
nodes on the CPU, from the same weights: forwards of the flagship shapes
cut to width 16, and the first three training steps."""

import numpy as np
import pytest
import torch

from portbench import check, inputs, run
from portbench import weights as W
from portbench.reference import precision as P
from portbench.reference import train as RT


def _setup(tiny, workload, nodes=400):
    m = run.Manifest(tiny)
    cell = m.cells[workload]
    cfg = m.config(cell)
    cfg["model"]["compute_dtype"] = "float32"
    ref = run._ref_model(cfg)
    model, needs, kw = run.port_model(cfg, nodes)
    w0 = W.make(ref.layout(cfg), 3, "cpu")
    meshes = []
    for i in range(3):
        mesh = inputs.random_mesh(nodes, 6, 100 + i)
        inputs.compute_features(mesh)
        meshes.append(mesh)
    return cfg, ref, model, needs, kw, w0, meshes


@pytest.mark.parametrize("workload", ["mgn-train-65k", "bsms-train-65k"])
def test_forward_matches_port(tiny, workload):
    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.inference.engine import AeroInference

    cfg, ref, model, needs, kw, w0, meshes = _setup(tiny, workload)
    params = model.init(0, device="cpu")
    W.load_into(params, w0)
    stats = {"target_mean": np.zeros(4, np.float32),
             "target_std": np.ones(4, np.float32)}
    with ops.use_backend("torch"):
        eng = AeroInference(model, params, stats, device="cpu",
                            needs_hierarchy=needs, **kw)
        graph, aux = next(iter(Loader([run.port_sample(meshes[0])], 1,
                                      device="cpu", **kw)))
        got = eng.predict_batch(graph, aux)[0][2]
    want = RT.predict(ref, cfg, w0, meshes[0], "cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("workload", ["mgn-train-65k", "bsms-train-65k"])
def test_three_steps_match_port(tiny, workload):
    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.training import loop

    cfg, ref, model, needs, kw, w0, meshes = _setup(tiny, workload)
    params = model.init(0, device="cpu")
    W.load_into(params, w0)
    opt = loop.make_optimizer(params, cfg["learning_rate"])
    fns = loop.make_step_fns(model, opt, device="cpu", needs_hierarchy=needs)
    steps = run.Steps(fns, opt, w0, run.S.Spans(), 3, None)
    from aero_gnn_tpu_torch.data.batching import Loader

    with ops.use_backend("torch"):
        for mesh in meshes:
            graph, aux = next(iter(Loader([run.port_sample(mesh)], 1,
                                          device="cpu", **kw)))
            steps(params, graph, aux.get("hierarchy"))
    prog = {"losses": [float(v) for v in steps.losses],
            "grad1": steps.grad1, "delta": steps.delta}
    want = RT.adam_steps(ref, cfg, w0, meshes, "cpu",
                         lr=cfg["learning_rate"])
    got = check.train_numbers(prog, want)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4
    assert got["update_gap"] < 2e-2  # Adam's sign-like first step


def test_fp8_rounds_operands():
    # scale 3.5 / 448: 3.5 and 0 are exact, 1.07 is not (3 mantissa bits)
    x = torch.tensor([3.5, 1.07, -2.2, 0.0])
    y = P._RoundFp8.apply(x)
    assert y[0] == 3.5 and y[3] == 0.0 and y[1] != x[1]
    assert torch.all((y - x).abs() <= x.abs() / 16)


@pytest.mark.parametrize("workload", ["mgn-train-65k", "bsms-train-65k"])
def test_recompute_keeps_gradients(tiny, workload):
    """The reference's grouped recompute (1M nodes) changes no gradient."""
    cfg, ref, model, needs, kw, w0, meshes = _setup(tiny, workload)
    g = ref.prepare(cfg, meshes[0], "cpu")
    mm = P.matmul("fp32")
    grads = []
    for ckpt in (False, True):
        w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
        loss = ref.loss_fn(ref.forward(w, cfg, g, mm, ckpt=ckpt), g["y"])
        grads.append(torch.autograd.grad(loss, list(w.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
