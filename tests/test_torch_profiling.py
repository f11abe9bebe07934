"""The port's span and counter registry (utils.profiling): nothing recorded
and no profiler range entered without a profiler; spans with their parents,
in the exported trace and on the trace's clock, also from a thread started
inside the profiled window; the main path's spans (Loader, graph build,
hierarchy, step, engine) with their nesting; the counters of real against
padded rows; no launch counted on the plain CPU path."""

import collections
import json
import threading

import numpy as np
import pytest
import torch

from aero_gnn_tpu_torch import ops
from aero_gnn_tpu_torch.data import dataset as D
from aero_gnn_tpu_torch.data.batching import Loader
from aero_gnn_tpu_torch.data.synthetic import make_random_mesh_sample
from aero_gnn_tpu_torch.inference.engine import AeroInference
from aero_gnn_tpu_torch.models.bsms import BSMSConfig
from aero_gnn_tpu_torch.models.mgn import MGNConfig
from aero_gnn_tpu_torch.training import loop
from aero_gnn_tpu_torch.utils import profiling as PR

H = 16
DIMS = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4)
WIDTHS = dict(hidden_dim_processor=H, hidden_dim_node_encoder=H,
              hidden_dim_edge_encoder=H, hidden_dim_decoder=H,
              do_concat_trick=True, remat=False)
# the hand-written kernels' ids (PERF.md's kernel table)
KERNELS = ("K1", "K1-save", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
           "K9-fwd", "K9-bwd", "K10")
STATS = {"target_mean": np.zeros(4, np.float32),
         "target_std": np.ones(4, np.float32)}

# span -> the span that encloses it (None: the caller's top level)
STEP_PARENTS = {
    "aero.loader.batch": None, "aero.graph.build": "aero.loader.batch",
    "aero.graph.to_device": "aero.graph.build", "aero.step": None,
    "aero.step.forward": "aero.step", "aero.step.backward": "aero.step",
    "aero.step.optimizer": "aero.step", "aero.step.sync": "aero.step",
    "aero.engine.predict": None,
    "aero.engine.forward": "aero.engine.predict",
    "aero.engine.to_host": "aero.engine.predict",
    "aero.engine.denormalize": "aero.engine.predict"}
HIERARCHY_PARENTS = {
    "aero.loader.hierarchy": "aero.loader.batch",
    "aero.hierarchy.collate": "aero.loader.hierarchy"}


@pytest.fixture
def registry():
    PR.clear()
    PR.reset_counters()
    yield PR
    PR.clear()
    PR.reset_counters()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _export(prof, tmp_path) -> dict:
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)


def _annotations(trace: dict) -> dict:
    return {e["name"]: e for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation"}


def test_no_profiler_records_nothing_and_enters_no_range(registry,
                                                          monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with PR.annotate("aero.outer"):
        with PR.annotate("aero.inner"):
            torch.ones(4).sum()
    assert PR.spans() == []
    # one shared null context: no allocation per span
    assert PR.annotate("aero.a") is PR.annotate("aero.b")


def test_spans_nest_and_appear_in_the_trace(registry, tmp_path):
    with _profile() as prof:
        with PR.annotate("aero.outer"):
            with PR.annotate("aero.inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
            with PR.annotate("aero.second"):
                pass
    got = {s.name: s for s in PR.spans()}
    assert set(got) == {"aero.outer", "aero.inner", "aero.second"}
    outer = got["aero.outer"]
    assert outer.parent is None
    assert got["aero.inner"].parent == got["aero.second"].parent == outer.id
    for s in got.values():
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
        assert s.thread == threading.get_native_id()
    assert got["aero.inner"].end_ns <= got["aero.second"].start_ns
    assert set(got) <= set(_annotations(_export(prof, tmp_path)))


def test_span_on_a_thread_started_inside_the_window(registry):
    seen = {}

    def work():
        seen["id"] = threading.get_native_id()
        with PR.annotate("aero.worker"):
            with PR.annotate("aero.worker.part"):
                torch.ones(4).sum()

    with _profile():
        with PR.annotate("aero.main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    got = {s.name: s for s in PR.spans()}
    assert set(got) == {"aero.main", "aero.worker", "aero.worker.part"}
    # parents are per thread: the worker's top span has none
    assert got["aero.worker"].parent is None
    assert got["aero.worker.part"].parent == got["aero.worker"].id
    assert got["aero.worker"].thread == seen["id"] != got["aero.main"].thread


def test_span_clock_is_the_trace_clock(registry, tmp_path):
    with _profile() as prof:
        torch.ones(4).sum()
        with PR.annotate("aero.clocked"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    span, = PR.spans()
    trace = _export(prof, tmp_path)
    event = _annotations(trace)["aero.clocked"]
    start_ns = float(event["ts"]) * 1e3 + trace["baseTimeNanoseconds"]
    assert abs(start_ns - span.start_ns) < 1e6
    assert abs(float(event["dur"]) * 1e3
               - (span.end_ns - span.start_ns)) < 1e6


def test_registry_keeps_the_newest_spans(registry, monkeypatch):
    monkeypatch.setattr(PR, "_spans", collections.deque(maxlen=3))
    with _profile():
        for i in range(5):
            with PR.annotate(f"aero.s{i}"):
                pass
    assert [s.name for s in PR.spans()] == ["aero.s2", "aero.s3", "aero.s4"]
    PR.clear()
    assert PR.spans() == []


def test_counters_add_copy_and_reset(registry):
    PR.count("graph.nodes")
    PR.count("graph.edges", 5)
    PR.count("graph.edges", 2)
    got = PR.counters()
    assert got == {"graph.nodes": 1, "graph.edges": 7}
    got["graph.edges"] = 0
    assert PR.counters()["graph.edges"] == 7
    PR.reset_counters()
    assert PR.counters() == {}


def _samples(n, nodes):
    s = [make_random_mesh_sample(n_nodes=nodes + 40 * i, seed=i + 1)
         for i in range(n)]
    D.compute_features(s, ["mach", "alpha"])
    return s


def _check_parents(spans, parents):
    by_id = {s.id: s for s in spans}
    names = {s.name for s in spans}
    assert set(parents) <= names, set(parents) - names
    for s in spans:
        if s.name not in parents:
            continue
        got = None if s.parent is None else by_id[s.parent].name
        assert got == parents[s.name], (s.name, got)


@pytest.mark.parametrize("model,align", [("mgn", False), ("bsms", True),
                                         ("bsms", False)])
def test_main_path_spans_and_counters(registry, model, align):
    samples = _samples(2, 300)
    if model == "mgn":
        cfg = MGNConfig(**DIMS, **WIDTHS, processor_size=2)
        kw = {}
    else:
        cfg = BSMSConfig(**DIMS, **WIDTHS, processor_size=5, num_scales=3,
                         layers_per_scale=1, hierarchy_mode="bistride",
                         transfer="weighted")
        kw = dict(num_scales=3, hierarchy_mode="bistride")
    needs = model == "bsms"
    params = cfg.init(0, device="cpu")
    fns = loop.make_step_fns(cfg, loop.make_optimizer(params, 1e-3),
                             device="cpu", needs_hierarchy=needs)
    loader = Loader(samples, 1, shuffle=True, align_edges=align,
                    device="cpu", **kw)
    eng = AeroInference(cfg, params, STATS, device="cpu",
                        needs_hierarchy=needs, **kw)
    with _profile():
        loop.run_epoch_train(fns, params, loader)
        graph, aux = next(iter(Loader(samples[:1], 1, align_edges=align,
                                      device="cpu", **kw)))
        eng.predict_batch(graph, aux)
    spans = PR.spans()
    parents = dict(STEP_PARENTS)
    if needs:
        parents.update(HIERARCHY_PARENTS)
        if align:
            parents["aero.hierarchy.align"] = "aero.loader.hierarchy"
            parents["aero.hierarchy.to_device"] = "aero.hierarchy.align"
        else:
            parents["aero.hierarchy.to_device"] = "aero.loader.hierarchy"
    _check_parents(spans, parents)
    names = [s.name for s in spans]
    assert names.count("aero.step") == names.count("aero.step.sync") == 2
    assert names.count("aero.loader.batch") == 3
    assert names.count("aero.engine.predict") == 1
    assert ("aero.loader.hierarchy" in names) == needs
    c = PR.counters()
    # an epoch over both samples, then the request's batch of the first
    assert c["graph.nodes"] == (2 * samples[0].num_nodes
                                + samples[1].num_nodes)
    assert c["graph.edge_rows"] >= c["graph.edges"] > 0
    assert c["graph.node_rows"] > c["graph.nodes"] > 0


def test_plain_cpu_path_counts_no_launch(registry):
    """The cuda backend's routes on CPU tensors reach the kernel wrappers,
    which run their plain versions: every launch counter stays 0."""
    samples = _samples(1, 300)
    cfg = MGNConfig(**DIMS, **WIDTHS, processor_size=2)
    params = cfg.init(0, device="cpu")
    fns = loop.make_step_fns(cfg, loop.make_optimizer(params, 1e-3),
                             device="cpu")
    with ops.use_backend("cuda"):
        (graph, aux), = Loader(samples, 1, align_edges=True, device="cpu")
        assert np.isfinite(float(fns.train_step(params, graph)))
    got = PR.counters()
    assert {k: got.get("launch." + k, 0) for k in KERNELS} == dict.fromkeys(
        KERNELS, 0)
    assert PR.counters()["graph.edges"] == samples[0].num_edges
