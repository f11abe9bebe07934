"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--record PATH]

``--record PATH`` also writes the full record (every kernel's operations
and bytes, launch counts, build and total seconds) as JSON to PATH.

Phases (each prints its own lines; any failure raises and exits non-zero):

  1. device  — nvidia-smi name and power limit, CUDA and card names;
  2. build   — compile every kernel in aero_gnn_tpu_torch/csrc with nvcc
               (sm_90a), one process per source, and report the time;
  3. kernels — each Hopper kernel against its plain PyTorch version on the
               card, at the flagship shapes (the 65,536-node mesh's aligned
               layout, h = 128, 2 hidden layers), fp32 and bf16, timed with
               CUDA events (median of 20 after warm-up) beside the bound;
  3b. shapes — the kernels' other configurations (no hidden layer, weights
               streamed per stage, h = 64) against the plain versions on a
               4,096-node mesh;
  4. serve   — the flagship MeshGraphNet (15 layers, width 128) from a seeded
               init served through AeroInference on the card: 3 requests of
               65,536-node meshes in bf16 and in fp32. Launch counters are set
               to 0 before each dtype's run and read after it; every forward
               must launch K1 and K3 exactly 15 times each. Request 0 in fp32
               is cross-checked against the plain path (use_backend("torch")).
  5. profile — torch.profiler over one warm forward per dtype: device busy
               time, idle share and the kernels that take the most time.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Nothing of JAX or aero_gnn_tpu is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense): the roofline bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor / fp32 FFMA
# kernel vs plain version on the card: |k - p| <= atol + rtol * |p|
TOL = {"float32": (1e-4, 1e-4),
       # a few bf16 ulps: the kernel rounds where the plain version does but
       # accumulates its products in another order (and K3 sums its two
       # first products in fp32 before rounding, as the TPU kernel does)
       "bfloat16": (6.25e-2, 1.5625e-2)}
# fused fp32 forward vs the plain path, normalised predictions
SERVE_TOL = (1e-3, 1e-3)
N_NODES = 65536
HIDDEN = 128
N_HIDDEN = 2
LAYERS = 15


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"card {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from aero_gnn_tpu_torch.ops import _build

    secs = _build.build_all()
    log(f"[build] {', '.join(_build.sources())} built in {secs:.1f} s")
    for name, report in sorted(_build.ptxas_report.items()):
        for line in report.splitlines():
            if "entry function" in line:
                log(f"[build] {name}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                log(f"[build]   {line.replace('ptxas info    :', '').strip()}")
    return secs


def phase_shapes(torch, graph):
    """The kernels' other configurations against their plain versions at a
    small size: no hidden layer, weights streamed per stage (bf16 with 4
    hidden layers no longer fits shared memory at once), and h = 64."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_node as HN

    dev = graph.device
    E, N = graph.num_edges_pad, graph.num_nodes_pad
    real = graph.edge_mask > 0
    gen = torch.Generator(device=dev).manual_seed(99)
    for h, nh in ((128, 0), (128, 4), (64, 2)):
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)

            def r(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen, device=dev)
                        * scale).to(dt)

            w = 1.0 / h ** 0.5
            edge_args = (r(E, h), r(E, h), r(N, h), graph.edge_mask.to(dt),
                         graph.receivers, r(h, h, scale=w),
                         r(nh, h, h, scale=w), r(nh, h, scale=0.1),
                         r(h, h, scale=w), r(h, scale=0.1),
                         1 + r(h, scale=0.1), r(h, scale=0.1), N)
            ek, ak = HF.fused_edge_layer(*edge_args)
            ep, ap = HF.fused_edge_layer_ref(*edge_args)
            node_args = (r(N, h), r(N, h, scale=3.0), r(h, h, scale=w),
                         r(h, h, scale=w), r(h, scale=0.1),
                         r(nh, h, h, scale=w), r(nh, h, scale=0.1),
                         r(h, h, scale=w), r(h, scale=0.1),
                         1 + r(h, scale=0.1), r(h, scale=0.1))
            xk = HN.fused_node_layer(*node_args)
            xp = HN.fused_node_layer_ref(*node_args)
            torch.cuda.synchronize()
            tag = f"h={h} n_hidden={nh} {dtype_name}"
            errs = (check_close(torch, f"K1 {tag} e'", ek, ep, dtype_name,
                                rows=real),
                    check_close(torch, f"K1 {tag} agg", ak, ap, dtype_name),
                    check_close(torch, f"K3 {tag} x'", xk, xp, dtype_name))
            log(f"[shapes] {tag}: max abs err K1 e' {errs[0]:.3e}, agg "
                f"{errs[1]:.3e}, K3 {errs[2]:.3e}")


def flagship_graph(seed: int, device, n_nodes: int = N_NODES):
    """The benchmark's synthetic mesh (bench.py get_mesh) in its aligned
    layout, nodes padded to the next multiple of 512."""
    from aero_gnn_tpu_torch.data import dataset as D
    from aero_gnn_tpu_torch.data.synthetic import make_random_mesh_sample
    from aero_gnn_tpu_torch.graph import padded

    s = make_random_mesh_sample(n_nodes=n_nodes, avg_degree=6, seed=seed)
    D.compute_features([s], ["mach", "alpha"])
    np_pad = -(-(n_nodes + 1) // 512) * 512
    g = padded.build_graph_batch(
        senders=s.senders, receivers=s.receivers, x=s.x,
        edge_attr=s.edge_attr, pos=s.pos, y=s.y, num_nodes_pad=np_pad,
        align_edges=True, device=device)
    return s, g


def cuda_time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_close(torch, name, got, ref, dtype, rows=None):
    atol, rtol = TOL[dtype]
    if rows is not None:
        got, ref = got[rows], ref[rows]
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values from the kernel")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} values outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def phase_kernels(torch, graph):
    """K1 and K3 against their plain versions at the flagship shapes."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_node as HN
    from aero_gnn_tpu_torch.ops.scatter import degree

    dev = graph.device
    E, N, h, nh = graph.num_edges_pad, graph.num_nodes_pad, HIDDEN, N_HIDDEN
    real = graph.edge_mask > 0
    empty = degree(graph.receivers, N, mask=graph.edge_mask) == 0
    log(f"[kernels] flagship layout: E={E} (real {int(real.sum())}), N={N}, "
        f"h={h}, n_hidden={nh}; {int(empty.sum())} nodes without a real edge")
    results = []
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(1234)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=dev)
                    * scale).to(dt)

        w = 1.0 / h ** 0.5
        e, sg = randn(E, h), randn(E, h)
        d_proj, x, agg_in = randn(N, h), randn(N, h), randn(N, h, scale=3.0)
        mask = graph.edge_mask.to(dt)
        ew = dict(w_e=randn(h, h, scale=w), ws=randn(nh, h, h, scale=w),
                  bs=randn(nh, h, scale=0.1), w_out=randn(h, h, scale=w),
                  b_out=randn(h, scale=0.1),
                  ln_scale=1 + randn(h, scale=0.1), ln_bias=randn(h, scale=0.1))
        nw = dict(w1x=randn(h, h, scale=w), w1a=randn(h, h, scale=w),
                  b1=randn(h, scale=0.1), ws=randn(nh, h, h, scale=w),
                  bs=randn(nh, h, scale=0.1), w_out=randn(h, h, scale=w),
                  b_out=randn(h, scale=0.1),
                  ln_scale=1 + randn(h, scale=0.1), ln_bias=randn(h, scale=0.1))
        edge_args = (e, sg, d_proj, mask, graph.receivers, ew["w_e"], ew["ws"],
                     ew["bs"], ew["w_out"], ew["b_out"], ew["ln_scale"],
                     ew["ln_bias"], N)
        node_args = (x, agg_in, nw["w1x"], nw["w1a"], nw["b1"], nw["ws"],
                     nw["bs"], nw["w_out"], nw["b_out"], nw["ln_scale"],
                     nw["ln_bias"])

        ek, ak = HF.fused_edge_layer(*edge_args)
        ep, ap = HF.fused_edge_layer_ref(*edge_args)
        torch.cuda.synchronize()
        err_e = check_close(torch, f"K1 {dtype_name} e'", ek, ep, dtype_name,
                            rows=real)
        err_a = check_close(torch, f"K1 {dtype_name} agg", ak, ap, dtype_name)
        if not (ak[empty] == 0).all():
            raise AssertionError(f"K1 {dtype_name}: agg rows of nodes without "
                                 "a real edge are not exactly 0")
        ak2 = HF.fused_edge_layer(*edge_args)[1]
        if not torch.equal(ak, ak2):
            raise AssertionError(f"K1 {dtype_name}: agg differs between two "
                                 "launches on the same inputs")
        xk = HN.fused_node_layer(*node_args)
        xp = HN.fused_node_layer_ref(*node_args)
        torch.cuda.synchronize()
        err_x = check_close(torch, f"K3 {dtype_name} x'", xk, xp, dtype_name)

        isz = torch.finfo(dt).bits // 8
        n_w = lambda ws: sum(t.numel() for t in ws.values())  # noqa: E731
        k1_bytes = (3 * E * h + 2 * N * h + E + n_w(ew)) * isz + 4 * E
        k1_flops = 2 * E * h * h * (2 + nh)
        k3_bytes = (3 * N * h + n_w(nw)) * isz
        k3_flops = 2 * N * h * h * (3 + nh)
        for name, src, replaces, fn, ref, flops, nbytes, err in (
                ("fused_edge_fwd", "aero_gnn_tpu_torch/csrc/fused_edge_fwd.cu",
                 "aero_gnn_tpu/ops/pallas_fused.py:488",
                 lambda: HF.fused_edge_layer(*edge_args),
                 lambda: HF.fused_edge_layer_ref(*edge_args),
                 k1_flops, k1_bytes, max(err_e, err_a)),
                ("fused_node_fwd", "aero_gnn_tpu_torch/csrc/fused_node_fwd.cu",
                 "aero_gnn_tpu/ops/pallas_node.py:143",
                 lambda: HN.fused_node_layer(*node_args),
                 lambda: HN.fused_node_layer_ref(*node_args),
                 k3_flops, k3_bytes, err_x)):
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
            ms = cuda_time_ms(torch, fn)
            plain_ms = cuda_time_ms(torch, ref)
            results.append({
                "name": f"{name}[{dtype_name}]", "route": "cuda",
                "source": src, "replaces": replaces, "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "flops": flops, "bytes": nbytes})
            log(f"[kernels] {name} {dtype_name}: {ms:.3f} ms (plain "
                f"{plain_ms:.3f} ms), bound {max(t_bytes, t_ops):.4f} ms by "
                f"{results[-1]['bound_by']}, max abs err {err:.3e}")
        del e, sg, d_proj, x, agg_in, ek, ak, ak2, ep, ap, xk, xp
    return results


def phase_serve(torch, graphs):
    """Serve the flagship model; returns {dtype: (K1 launches, K3 launches)}
    counted over that dtype's run of the main path."""
    import dataclasses

    import numpy as np

    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.inference.metrics import compute_rrmse_percent
    from aero_gnn_tpu_torch.models.mgn import MGNConfig
    from aero_gnn_tpu_torch.ops.hopper_fused import fused_edge_layer
    from aero_gnn_tpu_torch.ops.hopper_node import fused_node_layer

    cfg = MGNConfig(
        input_node_dim=6, input_edge_dim=3, output_node_dim=4,
        processor_size=LAYERS, hidden_dim_processor=HIDDEN,
        hidden_dim_node_encoder=HIDDEN, hidden_dim_edge_encoder=HIDDEN,
        hidden_dim_decoder=HIDDEN,
        num_hidden_layers_node_processor=N_HIDDEN,
        num_hidden_layers_edge_processor=N_HIDDEN,
        num_hidden_layers_node_encoder=N_HIDDEN,
        num_hidden_layers_edge_encoder=N_HIDDEN,
        num_hidden_layers_decoder=N_HIDDEN,
        aggregation="add", do_concat_trick=True)
    dev = graphs[0][1].device
    params = cfg.init(torch.Generator().manual_seed(0), device=dev)
    stats = {"target_mean": np.zeros(4, np.float32),
             "target_std": np.ones(4, np.float32)}
    launches, preds = {}, {}
    for dtype in ("bfloat16", "float32"):
        eng = AeroInference(dataclasses.replace(cfg, compute_dtype=dtype),
                            params, stats, device=dev)
        fused_edge_layer.launches = 0
        fused_node_layer.launches = 0
        n_fwd = 0
        for i, (sample, g) in enumerate(graphs):
            times = []
            for rep in range(4):
                k1, k3 = fused_edge_layer.launches, fused_node_layer.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if rep == 0:
                    pred_phys, tgt_phys, pred, _ = eng.predict_single(g)
                else:
                    eng.predict(g)
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                n_fwd += 1
                d1 = fused_edge_layer.launches - k1
                d3 = fused_node_layer.launches - k3
                if (d1, d3) != (LAYERS, LAYERS):
                    raise AssertionError(
                        f"request {i} {dtype}: K1 launched {d1}x, K3 {d3}x "
                        f"in one forward (expected {LAYERS} each)")
            if pred.shape != (sample.num_nodes, 4) or \
                    not np.isfinite(pred).all():
                raise AssertionError(f"request {i} {dtype}: bad predictions "
                                     f"{pred.shape}")
            preds[(dtype, i)] = pred
            ms = statistics.median(times[1:]) * 1e3
            log(f"[serve] {dtype} request {i}: {sample.num_nodes} nodes, "
                f"{sample.num_edges} edges, first call {times[0] * 1e3:.1f} "
                f"ms, then {ms:.2f} ms per forward (median of 3), "
                f"{sample.num_edges / ms * 1e3:.4g} edges/s, "
                f"RRMSE vs synthetic target (random weights) "
                f"{compute_rrmse_percent(pred_phys, tgt_phys):.1f}%")
        launches[dtype] = (fused_edge_layer.launches,
                           fused_node_layer.launches, n_fwd)
        log(f"[serve] {dtype}: K1 launched {launches[dtype][0]}x, K3 "
            f"{launches[dtype][1]}x over {n_fwd} forwards")
    # cross-check request 0 in fp32 against the plain path on the card
    eng = AeroInference(dataclasses.replace(cfg, compute_dtype="float32"),
                        params, stats, device=dev)
    with ops.use_backend("torch"):
        k1 = fused_edge_layer.launches
        ref = eng.predict_single(graphs[0][1])[2]
        if fused_edge_layer.launches != k1:
            raise AssertionError("the plain path launched a kernel")
    atol, rtol = SERVE_TOL
    got = preds[("float32", 0)]
    err = np.abs(got - ref)
    if (err > atol + rtol * np.abs(ref)).any():
        raise AssertionError(f"fp32 serve vs plain path: max abs err "
                             f"{err.max():.3e} beyond atol={atol} rtol={rtol}")
    log(f"[serve] fp32 request 0 vs plain path: max abs err {err.max():.3e} "
        f"(atol={atol}, rtol={rtol})")
    bf = np.abs(preds[("bfloat16", 0)] - ref)
    log(f"[serve] bf16 request 0 vs fp32 plain path: max abs err "
        f"{bf.max():.3e}, mean {bf.mean():.3e} (information)")
    for dtype in ("bfloat16", "float32"):
        phase_profile(torch, AeroInference(
            dataclasses.replace(cfg, compute_dtype=dtype), params, stats,
            device=dev), graphs[0][1], dtype)
    return launches


def phase_profile(torch, eng, graph, dtype: str, top: int = 8):
    """Where one warm forward's device time goes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    eng.predict(graph)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.predict(graph)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    rows = []  # device-side kernel events only: ops would count them twice
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        log(f"[profile] {dtype}: the profiler saw no device time "
            "(not measured)")
        return
    log(f"[profile] {dtype} forward: device busy {busy:.2f} ms of "
        f"{wall_ms:.2f} ms wall (idle share {1 - busy / wall_ms:.1%})")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"[profile]   {ms:8.3f} ms {ms / busy:6.1%} x{count:<4d} "
            f"{key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", help="write the full JSON record here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import aero_gnn_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_device(torch)
    build_s = phase_build()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    graphs = [flagship_graph(seed, dev) for seed in (0, 1, 2)]
    log(f"[serve] 3 meshes built in {time.perf_counter() - t0:.1f} s")
    kernels = phase_kernels(torch, graphs[0][1])
    phase_shapes(torch, flagship_graph(3, dev, n_nodes=4096)[1])
    launches = phase_serve(torch, graphs)
    for k in kernels:
        dtype = k["name"].split("[")[1].rstrip("]")
        k1, k3, n_fwd = launches[dtype]
        k["launches"] = k1 if k["name"].startswith("fused_edge") else k3
        k["launches_per_forward"] = k["launches"] / n_fwd
        if not k["launches"]:
            raise AssertionError(f"{k['name']} never launched on the main path")
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as f:
            json.dump({"nvidia_smi": smi, "build_s": build_s,
                       "kernels": kernels, "launches": launches,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(f"{smi}")
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k not in ("flops", "bytes")}
        for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
