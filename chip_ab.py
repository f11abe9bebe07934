"""Compare checkouts of the port on one NVIDIA GPU, in one process each.

    python3 chip_ab.py TREE [TREE ...]

Each TREE is a directory holding a checkout (this one, ``.``, or another
unpacked with ``git archive``). In the order given -- give parent, change,
change, parent to see the spread -- each builds its kernels, times K1-K5
at the flagship shapes in both dtypes with that tree's own
``chip_smoke.phase_kernels`` (CUDA events, median of 20), times K7 at the
BSMS fine level of mesh 0's Loader batch with ``rows`` (the main path's
call, both dtypes) and on a stream without pad rows (4 rows a node),
times K5 on the streams of its three call sites beside torch.sparse.mm
of the CSR matrix that computes the same function (the sender
backward's: the tight graph's sender stream with ``rows``; the unfused
aggregation's: the Loader graph's receivers with the edge mask; K6's
backward: the same receivers without a mask; pad sink declared on all
three) and on a stream without long runs (4 rows a node, random
``rows``),
profiles K2's, K4's and K5's kernels (device ms per call by kernel name,
both dtypes), times and profiles K1, its save variant, K10 (micro_wec2's
shapes), K3, K9-fwd and K1 -> K3 launched in turn, K8 (on what K1's
save variant saved), K9-bwd and K4 -> K2 launched in turn in both dtypes
(also the host's ms per call, without waiting for the card), and times 12
bf16
train steps and 10 bf16 forwards of the flagship MeshGraphNet on mesh 0
(host clock to a synchronize, both switches unset), with the card's name
and power limit. ``python3 chip_ab.py --steps TREE [TREE ...]`` instead
times, with each tree's own package in one process each, the flagship
BSMS fp32 train step on mesh 0's Loader batch (host clock to a
synchronize, the median of 6 after a warm step) and the flagship MGN's
halo-split bf16 step a rank at P = 2 (two gloo ranks sharing the card,
mesh 0 split as chip_smoke.py's phase parallel (a) splits it, the exchange
as the tree sets it by default, CUDA events, the median of 6 after a warm
step), one "AB-STEPS " line a tree. It hashes K7's outputs, K2's activation gradients (d_e,
d_sg), K4's (d_x, d_agg), K5's outputs on its streams, K1's (e', agg),
its save variant's six outputs, K10's two, K3's x', K9-fwd's (x', e',
agg), K8's ten outputs and K9-bwd's (d_e, d_sg, d_dproj, d_x), both
dtypes, on seeded inputs, and the last line says, per output, whether
every tree gave the same bits; the line before it
holds K4's weight gradients of each tree to the first tree's with
chip_smoke.py's GRAD_TOL rule (the gradients are saved under
build/chip_ab/, which git ignores). One line per tree starts with "AB "
and holds a JSON object. Nothing of JAX is imported.
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


def host_call_ms(torch, fn, n: int = 50) -> float:
    """Host ms per call of ``fn`` without waiting for the card (the
    wrapper's own work and the launches; the queue stays short of full)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


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


def kernels_ms(torch, fn, calls: int = 10) -> dict:
    """Device ms per call of ``fn`` of each kernel it launches, by name
    (torch.profiler over ``calls`` calls after 3 warm ones)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if ev.device_type == DeviceType.CUDA and us > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split()[-1]
            rows[name] = rows.get(name, 0.0) + us / calls / 1e3
    return rows


def chain_bwd(torch, C, graph, grads_path: str) -> tuple:
    """Device ms per call by kernel name of K2 and K4 at the flagship
    shapes, and hashes of their activation gradients (K2's d_e, d_sg;
    K4's d_x, d_agg) on phase_kernels' seeded inputs, both dtypes; K4's
    weight gradients saved to ``grads_path`` ({dtype: [tensors]})."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_node as HN

    ms, hashes, grads = {"k2": {}, "k4": {}}, {}, {}
    for dtype_name in ("bfloat16", "float32"):
        gen = torch.Generator(device=graph.device).manual_seed(1234)
        dt = getattr(torch, dtype_name)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=graph.device)
                    * scale).to(dt)

        _, edge_bwd, _, node_bwd, _ = C.bwd_cases(torch, graph, dt, randn,
                                                  C.HIDDEN, C.N_HIDDEN)
        d_e, d_sg = HF.fused_edge_layer_bwd(*edge_bwd)[:2]
        k4 = HN.fused_node_layer_bwd(*node_bwd)
        d_x, d_agg = k4[:2]
        grads[dtype_name] = [t.cpu() for t in k4[2:]]
        for key, t in (("k2_d_e", d_e), ("k2_d_sg", d_sg), ("k4_d_x", d_x),
                       ("k4_d_agg", d_agg)):
            hashes[f"{key}[{dtype_name}]"] = digest(torch, t)
        del d_e, d_sg, d_x, d_agg, k4
        ms["k2"][dtype_name] = kernels_ms(
            torch, lambda: HF.fused_edge_layer_bwd(*edge_bwd))
        ms["k4"][dtype_name] = kernels_ms(
            torch, lambda: HN.fused_node_layer_bwd(*node_bwd))
        del edge_bwd, node_bwd
    torch.save(grads, grads_path)
    return ms, hashes


def k1_k10(torch, C, graph) -> tuple:
    """K1, its save variant and K10 at their main paths' shapes, both
    dtypes: ms per call (CUDA events), device ms per call by kernel name,
    and hashes of K1's (e', agg), the save variant's six outputs (zs, d,
    mu, inv on the rows of live tiles, the only ones it writes) on
    phase_kernels' seeded inputs, and K10's (out1, out2) on
    phase_weighted2's (micro_wec2's shapes: the tight graph, h = 128,
    weights zero on pad edges; fp32 from the same bf16 messages)."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    dev, E, N = graph.device, graph.num_edges_pad, graph.num_nodes_pad
    tile = 1024  # graph.padded ALIGN_EDGE_TILE
    live = (graph.edge_mask[::tile] != 0).repeat_interleave(tile)
    ms, dev_ms, hashes = {}, {}, {}
    for dtype_name in ("bfloat16", "float32"):
        gen = torch.Generator(device=dev).manual_seed(1234)
        dt = getattr(torch, dtype_name)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=dev)
                    * scale).to(dt)

        edge_args = C.bwd_cases(torch, graph, dt, randn, C.HIDDEN,
                                C.N_HIDDEN)[0]
        k1 = HF.fused_edge_layer(*edge_args)
        sv = HF.fused_edge_layer_save(*edge_args)
        outs = {"k1_e": k1[0], "k1_agg": k1[1], "k1save_e": sv[0],
                "k1save_agg": sv[1], "k1save_zs": sv[2][:, live],
                "k1save_d": sv[3][live], "k1save_mu": sv[4][live],
                "k1save_inv": sv[5][live]}
        for key, t in outs.items():
            hashes[f"{key}[{dtype_name}]"] = digest(torch, t)
        del k1, sv, outs
        for name, fn in (
                ("fused_edge_fwd", lambda: HF.fused_edge_layer(*edge_args)),
                ("fused_edge_fwd_save",
                 lambda: HF.fused_edge_layer_save(*edge_args))):
            ms[f"{name}[{dtype_name}]"] = C.cuda_time_ms(torch, fn)
            ms[f"{name}_host[{dtype_name}]"] = host_call_ms(torch, fn)
            dev_ms[f"{name}[{dtype_name}]"] = kernels_ms(torch, fn)
        del edge_args
        gen = torch.Generator(device=dev).manual_seed(0)
        m1, m2 = (torch.randn(E, C.HIDDEN, generator=gen, device=dev).to(
            torch.bfloat16).to(dt) for _ in range(2))
        w1, w2 = (torch.randn(E, generator=gen, device=dev)
                  * graph.edge_mask for _ in range(2))
        args = (m1, w1, m2, w2, graph.receivers, N)
        out = HS.segment_sum_weighted2(*args)
        hashes[f"k10_out1[{dtype_name}]"] = digest(torch, out[0])
        hashes[f"k10_out2[{dtype_name}]"] = digest(torch, out[1])
        key = f"segment_sum_weighted2[{dtype_name}]"
        ms[key] = C.cuda_time_ms(
            torch, lambda: HS.segment_sum_weighted2(*args))
        ms[f"segment_sum_weighted2_host[{dtype_name}]"] = host_call_ms(
            torch, lambda: HS.segment_sum_weighted2(*args))
        dev_ms[key] = kernels_ms(
            torch, lambda: HS.segment_sum_weighted2(*args))
        del m1, m2, out, args
    torch.cuda.empty_cache()
    return ms, dev_ms, hashes


def k3_k9(torch, C, graph) -> tuple:
    """K3, K9-fwd and K1 -> K3 launched in turn (the two kernels K9-fwd
    fuses) at the flagship shapes, both dtypes: ms per call (CUDA events)
    and the host's ms per call, device ms per call by kernel name, and
    hashes of K3's x' and K9-fwd's (x', e', agg) on phase_kernels' seeded
    inputs."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_mega as HM
    from aero_gnn_tpu_torch.ops import hopper_node as HN

    ms, dev_ms, hashes = {}, {}, {}
    for dtype_name in ("bfloat16", "float32"):
        gen = torch.Generator(device=graph.device).manual_seed(1234)
        dt = getattr(torch, dtype_name)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=graph.device)
                    * scale).to(dt)

        edge_args, _, node_args, _, _ = C.bwd_cases(torch, graph, dt, randn,
                                                    C.HIDDEN, C.N_HIDDEN)
        ma = C.mega_args(HM, edge_args, node_args)
        hashes[f"k3_x[{dtype_name}]"] = digest(
            torch, HN.fused_node_layer(*node_args))
        for key, t in zip(("x", "e", "agg"), HM.fused_mgn_layer(*ma)):
            hashes[f"k9fwd_{key}[{dtype_name}]"] = digest(torch, t)
        for name, fn in (
                ("fused_node_fwd", lambda: HN.fused_node_layer(*node_args)),
                ("fused_mgn_fwd", lambda: HM.fused_mgn_layer(*ma)),
                ("k1_then_k3", lambda: HN.fused_node_layer(
                    ma[3], HF.fused_edge_layer(*edge_args)[1],
                    *node_args[2:]))):
            ms[f"{name}[{dtype_name}]"] = C.cuda_time_ms(torch, fn)
            ms[f"{name}_host[{dtype_name}]"] = host_call_ms(torch, fn)
            dev_ms[f"{name}[{dtype_name}]"] = kernels_ms(torch, fn)
        del edge_args, node_args, ma
    torch.cuda.empty_cache()
    return ms, dev_ms, hashes


def k8_k9bwd(torch, C, graph) -> tuple:
    """K8 (on what K1's save variant saved), K9-bwd and K4 -> K2 launched
    in turn (the two kernels K9-bwd fuses, ct_agg = K4's d_agg) at the
    flagship shapes, both dtypes: ms per call (CUDA events) and the host's
    ms per call, device ms per call by kernel name, and hashes of K8's ten
    outputs and K9-bwd's activation gradients on phase_kernels' seeded
    inputs."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_mega as HM
    from aero_gnn_tpu_torch.ops import hopper_node as HN

    ms, dev_ms, hashes = {}, {}, {}
    n_pad = graph.num_nodes_pad
    for dtype_name in ("bfloat16", "float32"):
        gen = torch.Generator(device=graph.device).manual_seed(1234)
        dt = getattr(torch, dtype_name)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=graph.device)
                    * scale).to(dt)

        edge_args, edge_bwd, node_args, _, _ = C.bwd_cases(
            torch, graph, dt, randn, C.HIDDEN, C.N_HIDDEN)
        ct_e, ct_agg = edge_bwd[12], edge_bwd[13]
        ct_x = randn(n_pad, C.HIDDEN)
        sv = HF.fused_edge_layer_save(*edge_args)
        a8 = C.k8_args(edge_args, sv[2:], ct_e, ct_agg)
        del sv
        for key, t in zip(C.EDGE_GRADS, HF.fused_edge_layer_bwd_saved(*a8)):
            hashes[f"k8_{key}[{dtype_name}]"] = digest(torch, t)
        ma = C.mega_args(HM, edge_args, node_args)
        x, agg = ma[3], HM.fused_mgn_layer(*ma)[2]
        b9_args = (*ma[:4], agg, *ma[4:8], ct_e, ct_x, n_pad)
        for key, t in zip(("d_e", "d_sg", "d_dproj", "d_x"),
                          HM.fused_mgn_layer_bwd(*b9_args)):
            hashes[f"k9bwd_{key}[{dtype_name}]"] = digest(torch, t)
        for name, fn in (
                ("fused_edge_bwd_saved",
                 lambda: HF.fused_edge_layer_bwd_saved(*a8)),
                ("fused_mgn_bwd", lambda: HM.fused_mgn_layer_bwd(*b9_args)),
                ("k4_then_k2", lambda: HF.fused_edge_layer_bwd(
                    *edge_args[:12], ct_e, HN.fused_node_layer_bwd(
                        x, agg, *node_args[2:], ct_x)[1], n_pad))):
            ms[f"{name}[{dtype_name}]"] = C.cuda_time_ms(torch, fn)
            ms[f"{name}_host[{dtype_name}]"] = host_call_ms(torch, fn)
            dev_ms[f"{name}[{dtype_name}]"] = kernels_ms(torch, fn)
        del edge_args, edge_bwd, node_args, ma, a8, b9_args, x, agg
        torch.cuda.empty_cache()
    return ms, dev_ms, hashes


def k5_streams(torch, C, sample, tight, dev) -> tuple:
    """K5 on the streams of its three call sites, both dtypes (seeded
    data): the sender backward's (the tight graph's sender stream,
    ``rows`` = sender_perm, the data zero on pad rows as on the training
    path), the unfused aggregation's (mesh 0's Loader graph: receivers,
    edge mask) and K6's backward (the same receivers, no mask, the data
    zero on pad rows); the pad sink declared on all three; and on a stream
    without long runs (4 rows a node over the tight graph's nodes, random
    ``rows``). Returns (ms per
    call with CUDA events, beside torch.sparse.mm of the CSR matrix of the
    live rows; device ms of both by kernel name; output hashes; each
    stream's rows per node: the largest count and the rows in nodes of
    more than 128)."""
    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    loader = next(iter(Loader([sample], 1, align_edges=True,
                              device=dev)))[0]
    ms, dev_ms, hashes, runs = {}, {}, {}, {}
    n_u = tight.num_nodes_pad
    gen = torch.Generator(device=dev).manual_seed(516)
    u_ids = torch.arange(n_u, device=dev, dtype=torch.int32).repeat_interleave(
        4)
    u_rows = torch.randint(0, 4 * n_u, (4 * n_u,), generator=gen, device=dev,
                           dtype=torch.int32)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(515)
        streams = {}
        g, N = tight, tight.num_nodes_pad
        real = (g.edge_mask > 0).to(dt)[:, None]
        data = torch.randn(g.num_edges_pad, C.HIDDEN, generator=gen,
                           device=dev).to(dt) * real
        live = g.senders_sorted != N - 1
        streams["sender"] = (data, g.senders_sorted, N, dict(
            rows=g.sender_perm, pad_sink=True), g.sender_perm[live],
            torch.ones(int(live.sum()), dtype=dt, device=dev), live)
        g, N = loader, loader.num_nodes_pad
        msgs = torch.randn(g.num_edges_pad, C.HIDDEN, generator=gen,
                           device=dev).to(dt)
        mask = g.edge_mask.to(dt)
        live = (g.edge_mask != 0) & (g.receivers != N - 1)
        rows = torch.nonzero(live).flatten()
        streams["receiver"] = (msgs, g.receivers, N, dict(
            mask=mask, pad_sink=True), rows, mask[rows], live)
        walked = g.receivers != N - 1
        rows = torch.nonzero(walked).flatten()
        streams["receiver_unmasked"] = (
            msgs * (g.edge_mask > 0).to(dt)[:, None], g.receivers, N,
            dict(pad_sink=True), rows,
            torch.ones(rows.numel(), dtype=dt, device=dev), walked)
        u_data = torch.randn(4 * n_u, C.HIDDEN, generator=gen,
                             device=dev).to(dt)
        streams["uniform"] = (u_data, u_ids, n_u, dict(rows=u_rows), u_rows,
                              torch.ones(4 * n_u, dtype=dt, device=dev),
                              torch.ones(4 * n_u, dtype=torch.bool,
                                         device=dev))
        for name, (d, ids, n, kw, cols, vals, live) in streams.items():
            per_node = torch.bincount(ids[live], minlength=n)
            runs[name] = {"max_rows_a_node": int(per_node.max()),
                          "rows_in_nodes_over_128": int(
                              per_node[per_node > 128].sum())}
            key = f"segment_sum_{name}[{dtype_name}]"
            hashes[f"k5_{name}[{dtype_name}]"] = digest(
                torch, HS.segment_sum(d, ids, n, **kw))
            ms[key] = C.cuda_time_ms(
                torch, lambda: HS.segment_sum(d, ids, n, **kw))
            crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
            crow[1:] = torch.cumsum(torch.bincount(ids[live], minlength=n),
                                    0)
            csr = torch.sparse_csr_tensor(crow, cols.long(), vals,
                                          size=(n, d.shape[0]))
            ms[f"sparse_mm_{name}[{dtype_name}]"] = C.cuda_time_ms(
                torch, lambda: torch.sparse.mm(csr, d))
            dev_ms[key] = kernels_ms(
                torch, lambda: HS.segment_sum(d, ids, n, **kw))
            dev_ms[f"sparse_mm_{name}[{dtype_name}]"] = kernels_ms(
                torch, lambda: torch.sparse.mm(csr, d))
            del csr
        del streams, data, msgs, u_data
    return ms, dev_ms, hashes, runs


def measure(tree: str, grads_path: str) -> dict:
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
    k5_ms, k5_dev_ms, k5_hashes, out["k5_runs"] = k5_streams(
        torch, C, sample, g, dev)
    out["kernel_ms"].update(k5_ms)
    out["k5_kernels_ms"] = k5_dev_ms
    bwd_ms, bwd_hashes = chain_bwd(torch, C, g, grads_path)
    fwd_ms, out["k1_k10_kernels_ms"], fwd_hashes = k1_k10(torch, C, g)
    out["kernel_ms"].update(fwd_ms)
    hashes.update(fwd_hashes)
    node_ms, out["k3_k9_kernels_ms"], node_hashes = k3_k9(torch, C, g)
    out["kernel_ms"].update(node_ms)
    hashes.update(node_hashes)
    sw_ms, out["k8_k9bwd_kernels_ms"], sw_hashes = k8_k9bwd(torch, C, g)
    out["kernel_ms"].update(sw_ms)
    hashes.update(sw_hashes)
    out["k2_kernels_ms"], out["k4_kernels_ms"] = bwd_ms["k2"], bwd_ms["k4"]
    hashes.update(k5_hashes)
    hashes.update(bwd_hashes)
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


def split_rank(rank: int, world: int, spec: dict) -> list:
    """One rank of the halo-split bf16 step (the tree in spec["tree"]):
    ms of each of 6 steps after a warm one (CUDA events)."""
    sys.path.insert(0, spec["tree"])
    import torch

    import chip_smoke as C
    from aero_gnn_tpu_torch.parallel import halo as HL
    from aero_gnn_tpu_torch.parallel import mesh as PM
    from aero_gnn_tpu_torch.training import loop as TL

    dev = C.par_init(spec, rank, world)
    mesh = PM.make_mesh(data=1, graph=world)
    sh = C.par_split(C.par_sample(0), world).shard(rank, dev)
    params = C.flagship_config().init(torch.Generator().manual_seed(0),
                                      device=dev)
    step = HL.make_halo_split_train_step(
        C.flagship_config(compute_dtype="bfloat16"),
        TL.make_optimizer(params, 1e-3), mesh)
    step(params, sh)
    times = []
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(params, sh)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def measure_steps(tree: str) -> dict:
    """The BSMS fp32 step and the halo-split bf16 step a rank of ``tree``
    (module docstring)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as C
    from aero_gnn_tpu_torch.parallel import distributed as PD
    from aero_gnn_tpu_torch.training import loop as TL

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": tree, "device": C.phase_device(torch)}
    C.phase_build()
    dev = torch.device("cuda")
    (_, g, aux), = C.bsms_requests(torch, [C.par_sample(0)], dev)[0]
    hier = aux["hierarchy"]
    cfg = C.bsms_config()
    params = cfg.init(torch.Generator().manual_seed(0), device=dev)
    fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3), device=dev,
                           needs_hierarchy=True)
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns.train_step(params, g, hier)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["bsms_fp32_step_ms"] = times[1:]
    out["bsms_fp32_step_median_ms"] = statistics.median(times[1:])
    del g, aux, hier, params, fns
    torch.cuda.empty_cache()
    (ranks,) = PD.spawn([(split_rank, 2, {
        "tree": tree, "address": f"tcp://localhost:{C.free_port()}"}, {})],
        timeout_s=600)
    out["split_bf16_step_ms"] = ranks
    out["split_bf16_step_median_ms"] = [statistics.median(r) for r in ranks]
    return out


def grads_against_first(torch, paths) -> dict:
    """K4's weight gradients of each tree against the first tree's, with
    the GRAD_TOL rule of the chip_smoke.py beside this script (|a - b| <=
    a_tol max|b| + r_tol |b|): {dtype: [within, worst max|a - b| /
    max|b|]}."""
    from chip_smoke import GRAD_TOL

    first = torch.load(paths[0])
    out = {}
    for dtype_name, (a_tol, r_tol) in GRAD_TOL.items():
        ok, worst = True, 0.0
        for path in paths[1:]:
            for a, b in zip(torch.load(path)[dtype_name], first[dtype_name]):
                err, scale = (a - b).abs(), float(b.abs().max())
                ok = ok and bool((err <= a_tol * scale
                                  + r_tol * b.abs()).all())
                worst = max(worst, float(err.max()) / scale if scale else 0.0)
        out[dtype_name] = [ok, worst]
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print("AB " + json.dumps(measure(sys.argv[2], sys.argv[3])),
              flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--one-steps":
        print("AB-STEPS " + json.dumps(measure_steps(sys.argv[2])),
              flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "--steps":
        for tree in sys.argv[2:]:
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--one-steps", tree], check=True,
                                 text=True, stdout=subprocess.PIPE)
            sys.stdout.write(run.stdout)
        return 0
    import torch

    # K4's weight gradients of each tree, compared after the last
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_ab")
    os.makedirs(out_dir, exist_ok=True)
    hashes, paths = [], []
    for i, tree in enumerate(sys.argv[1:]):
        paths.append(os.path.join(out_dir, f"k4_grads_{i}.pt"))
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree, paths[-1]], check=True,
                             text=True, stdout=subprocess.PIPE)
        sys.stdout.write(run.stdout)
        line = [ln for ln in run.stdout.splitlines() if ln.startswith("AB ")]
        hashes.append(json.loads(line[-1][3:])["hashes"])
    print("AB-GRADS " + json.dumps(grads_against_first(torch, paths)),
          flush=True)
    same = {k: len({h[k] for h in hashes}) == 1 for k in hashes[0]}
    print("AB-BITS " + json.dumps(same), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
