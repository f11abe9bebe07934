"""Compare checkouts of the port on one NVIDIA GPU, in one process each.

    python3 chip_ab.py TREE [TREE ...]

Each TREE is a directory holding a checkout (this one, ``.``, or another
unpacked with ``git archive``). In the order given -- give parent, change,
change, parent to see the spread -- each builds its kernels, times K1-K5
at the flagship shapes in both dtypes with that tree's own
``chip_smoke.phase_kernels`` (CUDA events, median of 20), times K7 at the
BSMS fine level of mesh 0's Loader batch with ``rows`` (the main path's
call, both dtypes) and on a stream without pad rows (4 rows a node),
profiles K2's kernels (device ms per call by kernel name, both dtypes),
and times 12 bf16 train steps and 10 bf16 forwards of the flagship
MeshGraphNet on mesh 0 (host clock to a synchronize, both switches
unset), with the card's name and power limit. It hashes K7's outputs and
K2's activation gradients (d_e, d_sg) on seeded inputs, and the last
line says, per output, whether every tree gave the same bits. One line
per tree starts with "AB " and holds a JSON object. Nothing of JAX is
imported.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def host_ms(torch, fn, n: int, skip: int = 2) -> float:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[skip:])


def digest(torch, t) -> str:
    """A short hash of the tensor's bytes."""
    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def measure_k7(torch, C, sample, dev) -> tuple:
    """K7 at the BSMS fine level with ``rows``, both dtypes: (ms, hashes)."""
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    requests, _ = C.bsms_requests(torch, [sample], dev)
    _, g, aux = requests[0]
    _, n, ids, rows, w = C.weighted_streams(torch, g, aux["hierarchy"])[0]
    ms, hashes = {}, {}
    for dtype_name in ("bfloat16", "float32"):
        gen = torch.Generator(device=dev).manual_seed(2024)
        data = torch.randn(n, C.HIDDEN, generator=gen, device=dev).to(
            getattr(torch, dtype_name))

        def call():
            return HS.segment_sum_weighted(data, ids, w, n, rows=rows,
                                           pad_sink=True)

        hashes[f"k7[{dtype_name}]"] = digest(torch, call())
        ms[f"segment_sum_weighted[{dtype_name}]"] = C.cuda_time_ms(torch,
                                                                    call)
    return ms, hashes


def k2_hashes(torch, C, graph) -> dict:
    """Hashes of K2's d_e and d_sg on phase_kernels' seeded inputs."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF

    out = {}
    for dtype_name in ("bfloat16", "float32"):
        gen = torch.Generator(device=graph.device).manual_seed(1234)
        dt = getattr(torch, dtype_name)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=graph.device)
                    * scale).to(dt)

        edge_bwd = C.bwd_cases(torch, graph, dt, randn, C.HIDDEN,
                               C.N_HIDDEN)[1]
        d_e, d_sg = HF.fused_edge_layer_bwd(*edge_bwd)[:2]
        out[f"k2_d_e[{dtype_name}]"] = digest(torch, d_e)
        out[f"k2_d_sg[{dtype_name}]"] = digest(torch, d_sg)
    return out


def k7_uniform_ms(torch, C, dev) -> dict:
    """K7 with ``rows`` on a stream without pad rows: 4 rows a node over
    the fine level's 78,336 nodes, random senders, weights in [0.5, 1.5),
    both dtypes (seeded)."""
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    n = 78336
    gen = torch.Generator(device=dev).manual_seed(5)
    ids = torch.arange(n, device=dev, dtype=torch.int32).repeat_interleave(4)
    rows = torch.randint(0, n, (4 * n,), generator=gen, device=dev,
                         dtype=torch.int32)
    w = torch.rand(4 * n, generator=gen, device=dev) + 0.5
    out = {}
    for dtype_name in ("bfloat16", "float32"):
        data = torch.randn(n, C.HIDDEN, generator=gen, device=dev).to(
            getattr(torch, dtype_name))
        out[f"segment_sum_weighted_uniform[{dtype_name}]"] = C.cuda_time_ms(
            torch, lambda: HS.segment_sum_weighted(data, ids, w, n,
                                                   rows=rows))
    return out


def k2_kernels_ms(torch, C, graph, calls: int = 10) -> dict:
    """Device ms per K2 call of each kernel it launches, by name
    (torch.profiler over ``calls`` calls at the flagship shapes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aero_gnn_tpu_torch.ops import hopper_fused as HF

    out = {}
    for dtype_name in ("bfloat16", "float32"):
        gen = torch.Generator(device=graph.device).manual_seed(1234)
        dt = getattr(torch, dtype_name)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=graph.device)
                    * scale).to(dt)

        edge_bwd = C.bwd_cases(torch, graph, dt, randn, C.HIDDEN,
                               C.N_HIDDEN)[1]
        for _ in range(3):
            HF.fused_edge_layer_bwd(*edge_bwd)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                HF.fused_edge_layer_bwd(*edge_bwd)
            torch.cuda.synchronize()
        rows = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0)
            if ev.device_type == DeviceType.CUDA and us > 0:
                name = ev.key.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].split("<")[0].split()[-1]
                rows[name] = rows.get(name, 0.0) + us / calls / 1e3
        out[dtype_name] = rows
        del edge_bwd
    return out


def measure(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import chip_smoke as C
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.training import loop as TL

    torch.backends.cuda.matmul.allow_tf32 = False
    device = C.phase_device(torch)  # nvidia-smi's name and power limit
    C.phase_build()
    dev = torch.device("cuda")
    sample, g = C.flagship_graph(0, dev)
    out = {"tree": tree, "device": device, "kernel_ms": {
        r["name"]: r["ms"] for r in C.phase_kernels(torch, g)}}
    k7_ms, hashes = measure_k7(torch, C, sample, dev)
    out["kernel_ms"].update(k7_ms)
    out["kernel_ms"].update(k7_uniform_ms(torch, C, dev))
    out["k2_kernels_ms"] = k2_kernels_ms(torch, C, g)
    hashes.update(k2_hashes(torch, C, g))
    out["hashes"] = hashes
    torch.cuda.empty_cache()
    cfg = C.flagship_config(compute_dtype="bfloat16")
    params = cfg.init(torch.Generator().manual_seed(0), device=g.device)
    fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3),
                           device=g.device)
    out["bf16_step_ms"] = host_ms(torch, lambda: fns.train_step(params, g),
                                  14)
    eng = AeroInference(cfg, params, {"target_mean": np.zeros(4),
                                      "target_std": np.ones(4)},
                        device=g.device)
    out["bf16_forward_ms"] = host_ms(torch, lambda: eng.predict(g), 12)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print("AB " + json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    hashes = []
    for tree in sys.argv[1:]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], check=True, text=True,
                             stdout=subprocess.PIPE)
        sys.stdout.write(run.stdout)
        line = [ln for ln in run.stdout.splitlines() if ln.startswith("AB ")]
        hashes.append(json.loads(line[-1][3:])["hashes"])
    same = {k: len({h[k] for h in hashes}) == 1 for k in hashes[0]}
    print("AB-BITS " + json.dumps(same), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
