"""Transolver (models/transolver.py) against the benchmark's plain reference
(portbench/reference/transolver.py) on the CPU, from the same seeded
weights: forward, masked loss and every parameter gradient through the
Loader's packed batches; Physics-Attention's written-out backward against
autograd; pad rows that change nothing; serving, the registry and the
spans and counters."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from aero_gnn_tpu_torch.data import dataset as D
from aero_gnn_tpu_torch.data.batching import Loader
from aero_gnn_tpu_torch.data.synthetic import make_random_mesh_sample
from aero_gnn_tpu_torch.graph import padded
from aero_gnn_tpu_torch.inference.engine import AeroInference
from aero_gnn_tpu_torch.models import registry as TR
from aero_gnn_tpu_torch.models import transolver as T
from aero_gnn_tpu_torch.training import loop
from aero_gnn_tpu_torch.utils import profiling as PR
from portbench import weights as W
from portbench.reference import precision as P
from portbench.reference import transolver as REF

CFG = {"model": {"name": "transolver", "hidden_dim": 32,
                 "processor_size": 2, "num_heads": 4, "slice_num": 8,
                 "mlp_ratio": 2, "activation": "gelu_exact", "dropout": 0.0,
                 "compute_dtype": "float32"},
       "dims": {"input_node_dim": 6, "input_edge_dim": 3,
                "output_node_dim": 4}}
STATS = {"target_mean": np.zeros(4, np.float32),
         "target_std": np.ones(4, np.float32)}
# float32 on both sides, the sums in other orders (a matmul a chunk of slots
# and a sum of the chunks against one graph's): rounding of ~1e-7 relative a
# product, grown by 2 layers and the backward, stays under these
FWD_RTOL = 1e-5  # forward and loss, relative to the output's largest value
GRAD_RTOL = 1e-4  # each gradient's gap, relative to that gradient's norm


def _samples(n, nodes=200):
    s = [make_random_mesh_sample(n_nodes=nodes + 37 * i, seed=11 + i)
         for i in range(n)]
    D.compute_features(s, ["mach", "alpha"])
    return s


def _port(seed=5):
    cfg = TR.build_model(CFG["model"], CFG["dims"])
    params = cfg.init(0, device="cpu")
    w0 = W.make(REF.layout(CFG), seed, "cpu")
    W.load_into(params, w0)
    return cfg, params, w0


def _reference(w0, samples):
    """The reference's predictions per sample and the mean squared error
    over all of their points, with every weight's gradient."""
    w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    mm = P.matmul("fp32")
    preds, ys = [], []
    for s in samples:
        g = REF.prepare(CFG, s, "cpu")
        preds.append(REF.forward(w, CFG, g, mm))
        ys.append(g["y"])
    loss = REF.loss_fn(torch.cat(preds), torch.cat(ys))
    grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
    return [p.detach() for p in preds], float(loss.detach()), grads


@pytest.mark.parametrize("batch", [1, 2])
def test_forward_loss_and_gradients_match_reference(batch):
    samples = _samples(batch)
    cfg, params, w0 = _port()
    (graph, aux), = Loader(samples, batch, device="cpu")
    assert graph.num_nodes_pad > graph.n_node  # pad rows present
    pred = cfg.apply(params, graph)
    loss = loop.masked_mse(pred, graph.y, graph.node_mask)
    loss.backward()
    want, want_loss, want_grads = _reference(w0, samples)
    off = 0
    for s, ref in zip(aux["samples"], want):
        got = pred[off:off + s.num_nodes].detach()
        off += s.num_nodes
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= FWD_RTOL * scale
    assert abs(float(loss.detach()) - want_loss) <= FWD_RTOL * abs(want_loss)
    named = dict(params.named_parameters())
    assert set(named) == set(want_grads)
    for name, p in named.items():
        ref = want_grads[name]
        gap = float((p.grad - ref).norm())
        assert gap <= GRAD_RTOL * float(ref.norm()), (name, gap)


@pytest.mark.parametrize("pad_slot", [False, True])
def test_physics_attention_backward_is_autograd_of_its_forward(pad_slot):
    """In float64, so that the written-out backward and autograd's differ
    by rounding alone: three graphs over several chunks of 8 slots, pad
    rows in a graph slot of their own or in the last graph's."""
    dt = torch.float64
    gen = torch.Generator().manual_seed(3)
    h, heads, s = 16, 4, 5
    c = h // heads

    def rand(*shape, scale=0.3):
        return (torch.randn(*shape, generator=gen, dtype=dt) * scale
                ).requires_grad_(True)

    node_graph = torch.tensor([0] * 17 + [1] * 14 + [2] * 10
                              + [3 if pad_slot else 2] * 6)
    mask = torch.ones(len(node_graph))
    mask[-6:] = 0
    plan = T.slot_plan(node_graph, mask, 4 if pad_slot else 3, rows=8)
    plan = plan._replace(mask=plan.mask.to(dt), onehot=plan.onehot.to(dt))
    weights = [rand(h, h), rand(h), rand(h, h), rand(h), rand(c, s),
               rand(s), (torch.rand(heads, generator=gen, dtype=dt) + 0.5
                         ).requires_grad_(True),
               rand(c, c), rand(c, c), rand(c, c), rand(h, h), rand(h)]
    m = plan.row_of_slot.numel()
    u = torch.randn(m, h, generator=gen, dtype=dt)
    cot = torch.randn(m, h, generator=gen, dtype=dt)
    u1 = u.clone().requires_grad_(True)
    out1 = T._PhysicsAttention.apply(u1, plan, *weights, heads)
    got = torch.autograd.grad(out1, [u1] + weights, cot)
    u2 = u.clone().requires_grad_(True)
    out2, _ = T.physics_attention_plain(u2, plan, *weights, heads)
    want = torch.autograd.grad(out2, [u2] + weights, cot)
    assert torch.equal(out1, out2)
    for a, b in zip(got, want):
        assert float((a - b).norm()) <= 1e-12 * float(b.norm())


def test_slot_plan_holds_every_row_once_by_graph():
    """Each row in one slot, each chunk of one graph slot, the graphs'
    chunks in order; K = ceil(N / R) + G chunks, whatever the split."""
    rows = 8
    node_graph = torch.tensor([0] * 17 + [1] * 3 + [2] * 16 + [3] * 5)
    mask = torch.ones(len(node_graph))
    mask[-5:] = 0
    n, g = len(node_graph), 4
    plan = T.slot_plan(node_graph, mask, g, rows=rows)
    k = -(-n // rows) + g
    assert plan.mask.shape == (k, rows)
    assert torch.equal(plan.row_of_slot[plan.slot_of_row], torch.arange(n))
    held = plan.row_of_slot[plan.row_of_slot < n]
    assert torch.equal(held.sort().values, torch.arange(n))
    chunk_of_row = plan.slot_of_row // rows
    assert torch.equal(plan.chunk_graph[chunk_of_row], node_graph.long())
    assert torch.equal(plan.chunk_graph, plan.chunk_graph.sort().values)
    # rows keep their order inside each graph
    assert bool((plan.slot_of_row[1:] > plan.slot_of_row[:-1]).all())
    assert plan.mask.sum() == mask.sum()
    assert torch.equal(plan.onehot.argmax(0), plan.chunk_graph)
    assert torch.equal(plan.onehot.sum(0), torch.ones(k))


@pytest.mark.parametrize("own_slot", [True, False])
def test_pad_rows_change_no_real_output(own_slot):
    """Pad rows in a graph slot of their own (the Loader's batches) or in
    the real graph's (build_graph_batch's default of one graph slot): the
    slice weights' mask keeps them out of every real output."""
    samples = _samples(2)
    cfg, params, _ = _port()
    if own_slot:
        (graph, _), = Loader(samples, 2, device="cpu")
    else:
        s = samples[0]
        graph = padded.build_graph_batch(
            senders=s.senders, receivers=s.receivers, x=s.x,
            edge_attr=s.edge_attr, pos=s.pos, y=s.y, device="cpu")
        assert graph.num_graphs_pad == 1
    n = graph.n_node
    assert graph.num_nodes_pad > n
    x = graph.x.clone()
    x[n:] = torch.randn(x[n:].shape, generator=torch.Generator()
                        .manual_seed(1)) * 3.0
    with torch.no_grad():
        a = cfg.apply(params, graph)
        b = cfg.apply(params, dataclasses.replace(graph, x=x))
    assert torch.equal(a[:n], b[:n])
    assert not torch.equal(a[n:], b[n:])


def test_serving_through_the_engine():
    samples = _samples(1)
    cfg, params, w0 = _port()
    eng = AeroInference(cfg, params, STATS, device="cpu")
    graph, aux = next(iter(Loader(samples, 1, device="cpu")))
    (pred, _, pred_norm, _), = eng.predict_batch(graph, aux)
    with torch.no_grad():
        want = REF.forward(w0, CFG, REF.prepare(CFG, samples[0], "cpu"),
                           P.matmul("fp32")).numpy()
    assert pred.shape == want.shape == (samples[0].num_nodes, 4)
    np.testing.assert_array_equal(pred, pred_norm)  # std 1, mean 0
    assert np.abs(pred - want).max() <= FWD_RTOL * np.abs(want).max()


def test_registry_builds_the_published_widths():
    for name in ("transolver", "Transolver", "TRANSOLVER"):
        assert TR.canonical_name(name) == "transolver"
    assert "transolver" not in TR.NEEDS_HIERARCHY
    cfg = TR.build_model({"name": "transolver"}, CFG["dims"])
    assert isinstance(cfg, T.TransolverConfig)
    assert (cfg.hidden_dim, cfg.processor_size, cfg.num_heads,
            cfg.slice_num, cfg.mlp_ratio, cfg.activation, cfg.dropout) == \
        (256, 8, 8, 32, 2, "gelu_exact", 0.0)
    with pytest.raises(ValueError, match="float32 only"):
        TR.build_model({"name": "transolver", "compute_dtype": "bfloat16"},
                       CFG["dims"])
    with pytest.raises(ValueError, match="multiple of num_heads"):
        TR.build_model({"name": "transolver", "hidden_dim": 30},
                       CFG["dims"])


def test_weights_file_round_trip(tmp_path):
    """model_weights.pkl (training/checkpoint.save_params) keeps a
    Transolver's parameters by name."""
    from aero_gnn_tpu_torch.training import checkpoint as C

    cfg, params, _ = _port()
    path = str(tmp_path / "model_weights.pkl")
    C.save_params(path, params, cfg)
    back = C.load_params(path, cfg, device="cpu")
    for (n, a), (m, b) in zip(params.named_parameters(),
                              back.named_parameters()):
        assert n == m and torch.equal(a, b), n


def test_dropout_is_refused():
    """The published model at these widths has dropout 0; the port has
    no dropout path."""
    with pytest.raises(ValueError, match="without dropout"):
        TR.build_model(dict(CFG["model"], dropout=0.1), CFG["dims"])


@pytest.fixture
def registry():
    PR.clear()
    PR.reset_counters()
    yield PR
    PR.clear()
    PR.reset_counters()


def test_spans_and_counters_under_a_profiled_step(registry):
    samples = _samples(2)
    cfg, params, _ = _port()
    fns = loop.make_step_fns(cfg, loop.make_optimizer(params, 1e-3),
                             device="cpu")
    eng = AeroInference(cfg, params, STATS, device="cpu")
    batches = list(Loader(samples, 2, device="cpu"))
    (graph, aux), = batches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        loop.run_epoch_train(fns, params, batches)
        eng.predict_batch(graph, aux)
    spans = PR.spans()
    by_id = {s.id: s for s in spans}
    parent = {}
    for s in spans:
        if s.name.startswith("aero.transolver."):
            parent.setdefault(s.name, set()).add(
                by_id[s.parent].name if s.parent is not None else None)
    forward = {"aero.step.forward", "aero.engine.forward"}
    assert parent == {f"aero.transolver.{k}": forward
                      for k in ("slice", "attend", "deslice", "mlp")}
    names = [s.name for s in spans]
    # 2 layers, one step and one request
    for k in ("slice", "attend", "deslice", "mlp"):
        assert names.count(f"aero.transolver.{k}") == 4
    c = PR.counters()
    assert c["transolver.points"] == 2 * 2 * graph.n_node
    slots = (-(-graph.num_nodes_pad // T.SLOT_ROWS)
             + graph.num_graphs_pad) * T.SLOT_ROWS
    assert c["transolver.point_rows"] == 2 * 2 * slots


def test_cli_trains_and_serves_the_default_section(tmp_path):
    """The port's default.yaml names the model: ``train --exp`` over its
    ``model.transolver`` section, then ``infer`` from the saved run."""
    from aero_gnn_tpu_torch import cli

    cfg = yaml.safe_load(open(cli.DEFAULT_CONFIG))
    cfg["experiments"]["tiny_transolver"] = {
        "dataset": "synthetic_airfoil", "model": "transolver",
        "training": "default", "n_cases": 12, "n_points": 48,
        "hidden_dim": 16, "processor_size": 2, "batch_size": 4,
        "epochs": 2, "early_stopping": False, "validation_split": 0.25,
        "test_split": 0.25}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    run = str(tmp_path / "run")
    cli.main(["train", "--exp", "tiny_transolver", "--config", str(path),
              "--output_dir", run, "--device", "cpu"])
    params = json.load(open(os.path.join(run, "experiment_params.json")))
    assert params["model"]["name"] == "transolver"
    assert params["model"]["num_heads"] == 8
    first = _errors(run)
    for d in os.listdir(run):
        if d.startswith("inference_results_"):
            shutil.rmtree(os.path.join(run, d))
    cli.main(["infer", "--training_dir", run, "--device", "cpu"])
    assert _errors(run).splitlines()[0] == first.splitlines()[0]


def _errors(run_dir):
    (d,) = [d for d in os.listdir(run_dir)
            if d.startswith("inference_results_")]
    return open(os.path.join(run_dir, d, "errors.txt")).read()
