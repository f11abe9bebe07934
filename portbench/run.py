"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. A run makes its meshes from the seed, builds
or loads the port's kernels (timed apart: the first run in a checkout pays
nvcc), makes the weights on the device from the seed, warms up the cell's
shapes, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON line. ``--trace 1``
profiles the first steps or requests of the window and prints the per-layer
metrics instead of the end-to-end ones.

Training cells drive ``training.loop.run_epoch_train`` over the port's
``data.batching.Loader``; serving cells send ``Loader([sample], 1)`` ->
``AeroInference.predict_batch`` requests from one client in a closed loop.
Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by the name ``BENCHMARK.json`` gives it.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# A run is one process with a fixed number of host threads, whatever the
# machine it lands on: set before numpy and torch load their thread pools.
HOST_THREADS = 4
if __name__ == "__main__":
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[_var] = str(HOST_THREADS)

import tempfile  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, inputs  # noqa: E402
from portbench import spans as S  # noqa: E402
from portbench import trace as T  # noqa: E402
from portbench import weights as W  # noqa: E402
from portbench.reference import train as RT  # noqa: E402

PKG = Path(__file__).resolve().parent
JAX_MODULES = ("jax", "jaxlib", "flax", "aero_gnn_tpu")


def process_age() -> float:
    """Seconds since this process started (from /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def loaded_jax() -> List[str]:
    """Modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(JAX_MODULES))


class Manifest:
    """``BENCHMARK.json`` and the files its names lead to: configs by their
    ``file``; traffic, limits and metric readers as
    ``portbench/{traffic,limits,metrics}/<name>`` beside the manifest, or
    in this package."""

    def __init__(self, path: Path):
        self.path = Path(path).resolve()
        self.data = json.loads(self.path.read_text())
        self.dirs = [self.path.parent / "portbench", PKG]
        self.cells = {c["name"]: c for c in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def _find(self, sub: str, name: str) -> Path:
        for d in self.dirs:
            p = d / sub / name
            if p.exists():
                return p
        raise FileNotFoundError(f"{sub}/{name} not found in "
                                f"{[str(d) for d in self.dirs]}")

    def config(self, cell: dict) -> dict:
        return json.loads((self.path.parent / self.configs[cell["config"]][
            "file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads(self._find("traffic",
                                     cell["traffic"] + ".json").read_text())

    def limits(self, cell: dict) -> Dict[str, float]:
        return json.loads(self._find("limits",
                                     cell["name"] + ".json").read_text())

    def metrics(self, cell: dict, trace: bool) -> List[dict]:
        """The end-to-end metrics (``trace`` off) or per-layer metrics
        (on) the cell reports."""
        if not trace:
            return [m for m in self.data["end_to_end"]
                    if cell["name"] in m.get("workloads", [cell["name"]])]
        e2e = {m["name"] for m in self.metrics(cell, False)}
        return [m for m in self.data["per_layer"]
                if cell["name"] in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]

    def reader(self, name: str):
        path = self._find("metrics", name + ".py")
        mod = "portbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in name)
        spec = importlib.util.spec_from_file_location(mod, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(device) -> float:
    """Build (first run in a checkout) or find the port's CUDA kernels and
    its host graph core; the seconds this took."""
    from aero_gnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        _build.build_all()
    _build.host_library("graphcore")
    return time.perf_counter() - t0


def load_kernels(device) -> None:
    from aero_gnn_tpu_torch.ops import _build

    if torch.device(device).type == "cuda":
        for name in _build.sources():
            _build.library(name)


def make_pool(traffic: dict, seed: int) -> List[inputs.Mesh]:
    def one(i):
        m = inputs.random_mesh(traffic["nodes"], traffic["avg_degree"],
                               inputs.sub_seed(seed, 1, i))
        inputs.compute_features(m)
        return m

    with ThreadPoolExecutor(max_workers=min(traffic["pool"], 4)) as ex:
        return list(ex.map(one, range(traffic["pool"])))


def port_sample(mesh: inputs.Mesh):
    from aero_gnn_tpu_torch.data.dataset import MeshSample

    return MeshSample(pos=mesh.pos, normals=mesh.normals,
                      senders=mesh.senders, receivers=mesh.receivers,
                      y=mesh.y, meta=dict(mesh.meta), x=mesh.x,
                      edge_attr=mesh.edge_attr)


def port_model(cfg: dict, nodes: int):
    """(the port's model config, needs_hierarchy, Loader keywords): the
    registry's model from the config's section, with the remat rule of
    ``remat_by_nodes`` for a mesh of ``nodes``."""
    from aero_gnn_tpu_torch.models import registry

    mc = cfg["model"]
    rule = next(r for r in cfg["remat_by_nodes"]
                if r["max_nodes"] is None or nodes <= r["max_nodes"])
    model = dataclasses.replace(
        registry.build_model(mc, cfg["dims"]),
        **{k: v for k, v in rule.items() if k != "max_nodes"})
    needs = registry.canonical_name(mc["name"]) in registry.NEEDS_HIERARCHY
    kw = ({"num_scales": mc["num_scales"],
           "hierarchy_mode": mc["hierarchy_mode"], "stride": mc["stride"]}
          if needs else {})
    return model, needs, kw


class Profiler:
    """torch.profiler over the first ``n`` ticks (steps or requests) of the
    window; ``tick()`` is called before each."""

    def __init__(self, device, n: int, spans: S.Spans):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.device, self.n, self.k, self.spans = device, n, 0, spans
        self.running = self.done = False

    def tick(self):
        if self.k == 0:
            self.spans.annotate = True
            self.prof.start()
            self.running = True
        elif self.k == self.n:
            self.stop()
        self.k += 1

    def stop(self):
        if self.running:
            sync(self.device)
            self.prof.stop()
            self.spans.annotate = False
            self.running, self.done = False, True

    def reduce(self) -> T.Trace:
        fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return T.Trace.load(path)
        finally:
            os.unlink(path)


class Feed:
    """The port's Loader with a span around each ``next()`` and the pool
    indices of each batch's meshes."""

    def __init__(self, loader, spans: S.Spans, index: Dict[int, int]):
        self.loader, self.spans, self.index = loader, spans, index
        self.batches: List[List[int]] = []
        self.before = None

    def __iter__(self):
        it = iter(self.loader)
        for _ in range(len(self.loader)):
            if self.before is not None:
                self.before()
            with self.spans.span("loader.next"):
                graph, aux = next(it)
            self.batches.append([self.index[id(s)] for s in aux["samples"]])
            yield graph, aux


def _half_batch(graph):
    """Fault: the loss over the first half of the real nodes only."""
    mask = graph.node_mask.clone()
    mask[graph.n_node // 2:] = 0
    return dataclasses.replace(graph, node_mask=mask)


class Steps:
    """The port's train_step with a span, every loss kept, and the state
    of its first steps read: the first gradient from Adam's first moment
    after one step, each leaf's change after ``n_first`` steps."""

    def __init__(self, fns, opt, w0, spans: S.Spans, n_first: int,
                 fault: Optional[str]):
        self.fns, self.opt, self.w0 = fns, opt, w0
        self.spans, self.n_first, self.fault = spans, n_first, fault
        self.losses: list = []
        self.grad1 = self.delta = None

    def __call__(self, params, graph, hierarchy=None, generator=None):
        k = len(self.losses)
        if self.fault == "half_batch":
            graph = _half_batch(graph)
        with self.spans.span("train_step"):
            if self.fault == "frozen_state":
                loss = self.fns.eval_step(params, graph, hierarchy)
            else:
                loss = self.fns.train_step(params, graph, hierarchy,
                                           generator)
        self.losses.append(loss)
        if k == 0:
            b1 = self.opt.param_groups[0]["betas"][0]
            self.grad1 = {
                n: float(self.opt.state.get(p, {}).get(
                    "exp_avg", torch.zeros(1)).norm()) / (1 - b1)
                for n, p in params.named_parameters()}
        if k == self.n_first - 1:
            self.delta = {n: float((p.detach() - self.w0[n]).norm())
                          for n, p in params.named_parameters()}
        return loss


@dataclasses.dataclass
class RunView:
    """What the metric readers read."""

    kind: str
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    count: int  # steps or requests completed in the window
    latencies_s: List[float]
    spans: Dict[str, List[float]]
    peak_window_bytes: Optional[int]
    trace: Optional[T.Trace] = None
    # per profiled step or request, the (layers, real nodes, real edges)
    # per scale of each of its meshes
    profiled: Optional[List[List[list]]] = None


def _mark(ctx, phase: str) -> None:
    """The end of a set-up phase, in seconds since the process began."""
    ctx["marks"].append((phase, process_age()))


def _ref_model(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def _peak(device) -> Optional[int]:
    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def _profiled_sizes(ref, cfg, meshes, groups) -> List[List[list]]:
    cache: Dict[int, list] = {}
    out = []
    for group in groups:
        for i in group:
            if i not in cache:
                cache[i] = ref.level_sizes(cfg, meshes[i])
        out.append([cache[i] for i in group])
    return out


def train_cell(ctx) -> dict:
    cfg, tr, dev, sp = ctx["config"], ctx["traffic"], ctx["device"], \
        ctx["spans"]
    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.training import loop

    _mark(ctx, "imports")
    meshes = make_pool(tr, ctx["seed"])
    _mark(ctx, "inputs")
    build_s = build_kernels(dev)
    _mark(ctx, "build")
    load_kernels(dev)
    ref = _ref_model(cfg)
    model, needs, loader_kw = port_model(cfg, tr["nodes"])
    w0 = W.make(ref.layout(cfg), inputs.sub_seed(ctx["seed"], 2), dev)
    params = model.init(0, device=dev)
    W.load_into(params, w0)
    opt = loop.make_optimizer(params, cfg["learning_rate"])
    fns = loop.make_step_fns(model, opt, device=dev, needs_hierarchy=needs)
    samples = [port_sample(m) for m in meshes]
    _mark(ctx, "kernels, weights, model")
    loader = Loader(samples, tr["batch_size"], shuffle=True,
                    seed=inputs.sub_seed(ctx["seed"], 3), device=dev,
                    **loader_kw)
    feed = Feed(loader, sp, {id(s): i for i, s in enumerate(samples)})
    steps = Steps(fns, opt, w0, sp, tr["check_steps"], ctx["fault"])
    step_fns = dataclasses.replace(fns, train_step=steps)
    # set-up: the first epochs, through the window's own call and feed;
    # their first check_steps steps are the ones the reference follows
    _mark(ctx, "loader")
    for _ in range(tr["warm_epochs"]):
        loop.run_epoch_train(step_fns, params, feed)
    sync(dev)
    _mark(ctx, "warm-up")
    setup_peak = _peak(dev)
    setup_s = process_age() - build_s
    first = [i for b in feed.batches[:tr["check_steps"]] for i in b]

    sp.reset()
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = Profiler(dev, tr["profile_steps"], sp) if ctx["trace"] else None
    feed.before = prof.tick if prof else None
    n0, b0 = len(steps.losses), len(feed.batches)
    t0 = time.perf_counter()
    while (time.perf_counter() - t0 < ctx["seconds"]
           or (prof and not prof.done)):
        with sp.span("epoch"):
            loop.run_epoch_train(step_fns, params, feed)
    sync(dev)
    window_s = time.perf_counter() - t0
    if prof:
        prof.stop()
    peak = _peak(dev)
    window_losses = [float(v) for v in steps.losses[n0:]]
    view = RunView("train", ctx["cell"], cfg, tr, setup_s, window_s,
                   len(window_losses), [], dict(sp.durations), peak)
    if prof:
        view.trace = prof.reduce()
        view.profiled = _profiled_sizes(
            ref, cfg, meshes, feed.batches[b0:b0 + prof.n])
    prog = {"losses": [float(v) for v in steps.losses[:tr["check_steps"]]],
            "grad1": steps.grad1, "delta": steps.delta}
    del params, opt, fns, step_fns, steps, loader, feed, samples, prof
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    ref_rec = RT.adam_steps(ref, cfg, w0, [meshes[i] for i in first], dev,
                            lr=cfg["learning_rate"])
    return {"view": view, "build_s": build_s,
            "attempted": len(window_losses),
            "failed": sum(not math.isfinite(v) for v in window_losses),
            "memory_peak_bytes": max(setup_peak or 0, peak or 0),
            "numbers": check.train_numbers(prog, ref_rec),
            "program": prog, "reference": ref_rec}


def _stats(meshes: List[inputs.Mesh]) -> Dict[str, np.ndarray]:
    y = np.concatenate([m.y for m in meshes])
    return {"target_mean": y.mean(axis=0).astype(np.float32),
            "target_std": np.maximum(y.std(axis=0, ddof=1), 1e-8).astype(
                np.float32)}


def serve_cell(ctx) -> dict:
    cfg, tr, dev, sp = ctx["config"], ctx["traffic"], ctx["device"], \
        ctx["spans"]
    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.inference.engine import AeroInference

    _mark(ctx, "imports")
    meshes = make_pool(tr, ctx["seed"])
    _mark(ctx, "inputs")
    build_s = build_kernels(dev)
    _mark(ctx, "build")
    load_kernels(dev)
    ref = _ref_model(cfg)
    model, needs, loader_kw = port_model(cfg, tr["nodes"])
    w0 = W.make(ref.layout(cfg), inputs.sub_seed(ctx["seed"], 2), dev)
    params = model.init(0, device=dev)
    W.load_into(params, w0)
    stats = _stats(meshes)
    eng = AeroInference(model, params, stats, device=dev,
                        needs_hierarchy=needs, **loader_kw)
    del params
    lo_m, hi_m = tr["mach"]
    lo_a, hi_a = tr["alpha"]

    def draw(path):
        rng = np.random.default_rng(inputs.sub_seed(ctx["seed"], *path))
        return (int(rng.integers(len(meshes))), float(rng.uniform(lo_m, hi_m)),
                float(rng.uniform(lo_a, hi_a)))

    def request(gi, mach, alpha):
        mesh = meshes[gi]
        mesh.meta = {"mach": mach, "alpha": alpha}
        inputs.compute_features(mesh)  # the client's work, not timed
        sample = port_sample(mesh)
        t0 = time.perf_counter()
        with sp.span("request"):
            with sp.span("loader"):
                graph, aux = next(iter(Loader([sample], 1, device=dev,
                                              **loader_kw)))
            with sp.span("predict_batch"):
                pp = eng.predict_batch(graph, aux)[0][0]
        lat = time.perf_counter() - t0
        if ctx["fault"] == "altered_answer":  # every value moved
            pp = pp + 0.5 * stats["target_std"]
        return pp, lat

    _mark(ctx, "kernels, weights, engine")
    for gi in range(len(meshes)):  # every geometry's shapes
        request(gi, *draw((5, gi))[1:])
    sync(dev)
    _mark(ctx, "warm-up")
    setup_peak = _peak(dev)
    setup_s = process_age() - build_s

    sp.reset()
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = Profiler(dev, tr["profile_requests"], sp) if ctx["trace"] else None
    res_rng = np.random.default_rng(inputs.sub_seed(ctx["seed"], 6))
    kept, lats, failed, served = [], [], 0, []
    t0 = time.perf_counter()
    while (time.perf_counter() - t0 < ctx["seconds"]
           or len(lats) < ctx["min_requests"] or (prof and not prof.done)):
        if prof:
            prof.tick()
        desc = draw((4, len(lats)))
        pp, lat = request(*desc)
        lats.append(lat)
        served.append(desc[0])
        failed += int(not np.isfinite(pp).all())
        # reservoir sample of the finished requests, drawn from the seed
        if len(kept) < tr["check_requests"]:
            kept.append((desc, pp))
        else:
            j = int(res_rng.integers(len(lats)))
            if j < tr["check_requests"]:
                kept[j] = (desc, pp)
    sync(dev)
    window_s = time.perf_counter() - t0
    if prof:
        prof.stop()
    peak = _peak(dev)
    view = RunView("serve", ctx["cell"], cfg, tr, setup_s, window_s,
                   len(lats), lats, dict(sp.durations), peak)
    if prof:
        view.trace = prof.reduce()
        view.profiled = _profiled_sizes(
            ref, cfg, meshes, [[g] for g in served[:prof.n]])
    del eng, prof
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    gaps = []
    for (gi, mach, alpha), pp in kept:
        mesh = meshes[gi]
        mesh.meta = {"mach": mach, "alpha": alpha}
        inputs.compute_features(mesh)
        rn = RT.predict(ref, cfg, w0, mesh, dev).cpu().numpy()
        pn = (pp - stats["target_mean"]) / stats["target_std"]
        gaps.append(check.pred_rms_err(pn, rn))
    return {"view": view, "build_s": build_s, "attempted": len(lats),
            "failed": failed,
            "memory_peak_bytes": max(setup_peak or 0, peak or 0),
            "numbers": {"pred_rms_err": max(gaps)}, "gaps": gaps}


def run_cell(manifest: Manifest, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", fault: Optional[str] = None,
             min_requests: int = 0, use_limits: bool = True) -> dict:
    """One run of ``workload``; the result line's fields plus the
    run's record (``view``, ``numbers``). ``fault`` breaks the timed path
    (the tests' and the calibration's)."""
    cell = manifest.cells[workload]
    cfg = manifest.config(cell)
    tr = manifest.traffic(cell)
    ctx = {"cell": cell, "config": cfg, "traffic": tr, "seed": seed,
           "seconds": seconds, "trace": trace, "device": device,
           "fault": fault, "spans": S.Spans(), "min_requests": min_requests,
           "marks": []}
    out = (train_cell if tr["kind"] == "train" else serve_cell)(ctx)
    view = out["view"]
    metrics = {}
    for m in manifest.metrics(cell, trace):
        value = manifest.reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = manifest.limits(cell) if use_limits else None
    dev = torch.device(device)
    line = {"correct": check.judge(out["numbers"], limits),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                       "kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                       "count": cell["chips"],
                       "memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace:
        line["device"]["busy_s"] = view.trace.busy_s
        line["device"]["window_s"] = view.trace.window_s
        line["breakdown"] = {"device_ops": view.trace.device_ops(),
                             "idle_gaps": view.trace.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": (limits or {}).get(k)}
                      for k, v in out["numbers"].items()
                      if limits is None or k in limits}
    return {"line": line, "build_s": out["build_s"], "record": out,
            "marks": ctx["marks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--manifest", default="BENCHMARK.json",
                    help="the manifest (default: BENCHMARK.json here)")
    args = ap.parse_args(argv)
    torch.set_num_threads(HOST_THREADS)
    manifest = Manifest(Path(args.manifest))
    cell = manifest.cells[args.workload]
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              "device(s); none usable here", file=sys.stderr)
        return 3
    res = run_cell(manifest, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    jax = loaded_jax()
    if jax:
        print(f"portbench: the run loaded {jax}", file=sys.stderr)
        return 4
    line = res["line"]
    print(f"portbench: build {res['build_s']:.3f} s (apart from setup_s); "
          "set-up phases ended at " + ", ".join(
              f"{k} {v:.2f} s" for k, v in res["marks"]), file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
