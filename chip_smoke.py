"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--record PATH] [--tail-only] [--parallel-only]

``--record PATH`` also writes the full record (every kernel's operations
and bytes, launch counts, step times, build and total seconds) as JSON to
PATH. ``--tail-only`` runs the device, build and tail phases and prints the
tail record (it also runs on a tree from before the pad-tail repair).

Phases (each prints its own lines; any failure raises and exits non-zero):

  1. device  — nvidia-smi name and power limit, CUDA and card names;
  2. build   — compile every kernel in aero_gnn_tpu_torch/csrc with nvcc
               (sm_90a), one process per source, and the host graph core
               (csrc/host/graphcore.cpp) with g++, and report the times;
               then build_graph_batch's host ms on the 65,536-node mesh
               with the graph core (graph.native's one-pass edge layout
               and chunk plan) and with the numpy plain versions
               (padded._edge_layout_ref, chunk_plan_ref), in turns, the
               batches bit-equal (phase large does the same at 1,048,576);
  3. tail    — K1, K2 and K5 (the sender backward's, and the unfused
               aggregation's: the receiver stream, the edge mask and the
               pad sink declared) on the Loader-padded 65,536-node graph
               (whose edge stream ends in a tail of pad rows keyed by the
               pad sink) against the tight aligned graph, both dtypes,
               checked against the plain versions and timed (K1's Loader /
               tight time at most 1.3); one bf16 MGN train step through
               each graph;
  4. kernels — each Hopper kernel against its plain PyTorch version on the
               card, at the flagship shapes (the 65,536-node mesh's aligned
               layout, h = 128, 2 hidden layers; K5 on its aligned sender
               stream), fp32 and bf16, timed with CUDA events (median of 20
               after warm-up) beside the bound and, for K5, the library
               calls of the same function: torch.sparse.mm of a 0/1 CSR
               matrix with its ``rows`` (the timed call), torch.segment_reduce
               on the pre-gathered rows beside K5 without them; K1's agg,
               K3's x', K2's / K4's outputs and K5's must be bit-equal
               across two launches; nvcc's register, shared memory and
               spill report for K1, K2, K3, K4 and K5, and K1's, K3's and
               K4's plans (grid, weights resident or in the ring, shared
               memory). K5 also at the widths its
               lane groups take (1, 34, 640) on the sender stream, K3 and
               K4 also at 10 hidden layers (K3's bf16 weights in its ring;
               K4's ReLU masks read back past the ones kept in registers),
               and K5 on the Loader graph's receiver
               stream (pad sink declared) in its other two uses, the
               unfused aggregation's (edge mask) and K6's backward (no
               mask): against the plain version, across launches, timed
               beside the bound and torch.sparse.mm of the CSR matrix of
               the rows each reads. K7 at the
               BSMS path's shapes (fine level, level 1, level 2 of mesh 0's
               Loader batch, WEC weights from its hierarchy), with and
               without ``rows``, bit-equal across launches, timed at the
               fine level beside its bound, its plain version and
               torch.sparse.mm of the CSR matrix that computes the same
               function (on the node table with ``rows``, on the gathered
               rows without), with nvcc's register and spill report;
               K6 at the tight MGN graph's shapes and at the Loader fine
               level's (receivers of each graph, random node rows), both
               dtypes, torch.equal to index_select and across launches,
               timed beside its bound, its plain version and
               torch.index_select, with nvcc's register and spill report;
  4b. shapes — the kernels' other configurations (no hidden layer, weights
               streamed per stage, h = 64) against the plain versions on a
               4,096-node mesh, K1's save variant, K8 and K9 included; K1
               and K2 at 10 hidden layers (K2's ReLU masks read back past
               the ones kept in registers, K1's bf16 weights in its ring)
               against their plain versions and across launches;
  4c. switched — K1's save variant, K8 (AERO_GNN_SAVE_ACTS), K9-fwd and
               K9-bwd (AERO_GNN_MEGA) at the flagship shapes, both dtypes:
               against their plain versions (K8 on the plain version's
               saved activations) and timed beside their bounds, K8's and
               K9-bwd's outputs bit-equal across launches; on the tight
               graph and on the Loader-padded one (whose pad-sink tail K1's
               save variant leaves unwritten): K8 on what the save variant
               saved against K2, K9-fwd against K1 -> K3 and K9-bwd against
               K4 -> K2 on the same inputs (max abs differences recorded),
               and the Loader / tight time of K2, K8, K9-fwd and K9-bwd,
               at most 1.3, K9-fwd timed beside K1 -> K3 and K9-bwd beside
               K4 -> K2 launched in turn; K9-fwd's x', e' (real rows) and
               agg must be bit-equal to K1 -> K3's, K9-bwd's d_e, d_sg,
               d_dproj, d_x and weight matrices and bias gradients to
               K4 -> K2's (its LayerNorm column sums within GRAD_TOL), both
               also with 0 and 10 hidden layers in both chains, and each to
               its own across 5 launches; all ten of K8's outputs to K2's;
               K8's, K9-fwd's and K9-bwd's plans and nvcc's reports;
  4d. weighted2 — K10, the WEC pair probe of benchmarks/micro_wec2.py, at
               its shapes (the tight 65,536-node graph, h = 128, bf16
               messages, fp32 weights zero on pad edges): its timed run of
               30 dual launches (the probe's main path, counted), then K10
               against its plain version and bit-equal to two K7 launches
               (also in fp32), timed beside the two K7 launches, its
               bound and two torch.sparse.mm of CSR matrices, with nvcc's
               register and shared memory report;
  5. serve   — the flagship MeshGraphNet (15 layers, width 128) from a seeded
               init served through AeroInference on the card: 3 requests of
               65,536-node meshes in bf16 and in fp32. Launch counters are set
               to 0 before each dtype's run and read after it; every forward
               must launch K1 and K3 exactly 15 times each. Request 0 in fp32
               is cross-checked against the plain path (use_backend("torch"));
               torch.profiler over one warm forward per dtype: device busy
               time, idle share and the kernels that take the most time;
  6. train   — the flagship MeshGraphNet trained on mesh 0 through
               training.loop.make_step_fns (Adam, lr 1e-3, fp32 masters,
               remat off): 10 steps in bf16, then one fp32 step's gradients
               against the plain path and 3 fp32 steps. Every step must
               launch K1-K5 exactly 15 times each; the loss must be finite
               and fall over the bf16 steps; one warm bf16 step is
               profiled;
  6b. cli    — the port's CLI (aero_gnn_tpu_torch.cli.main) on the card in
               a temporary directory, from a YAML written from the port's
               default.yaml: synthetic_mgn (the flagship MGN, 15 layers,
               width 128, on the synthetic airfoil set of 24 cases x 256
               points, batch 4) cut to 2 epochs with a checkpoint every
               epoch, in fp32 and, on a model entry with compute_dtype
               bfloat16, in bf16: train (the artifact files, the
               checkpoints, the post-train inference's errors.txt), infer
               3 times (the same TEST_MEAN line), resume to 3 epochs
               (resumed at epoch 2, the first 2 losses kept); the counts
               set to 0 before each run and held after it to K1-K5 15 per
               train step, K1 and K3 15 per forward (validation and
               inference), every other kernel 0; every test case served
               from the run directory through the kernels against the
               plain path (fp32 within 1e-3, bf16 within TOL); seconds
               per epoch and ms per infer request printed beside the
               card's name and power limit;
  7. bsms serve — the flagship BSMS (3 bistride scales, WeightedEdgeConv,
               fp32) served through AeroInference(needs_hierarchy=True) for
               the three meshes, each through its own Loader (num_scales=3):
               every forward launches K1 and K3 15 times, K5 6 times (the
               pools) and K7 4 times; request 0 against the plain path, and
               twice bit-equal without deterministic algorithms; one
               forward profiled;
  8. bsms train — the flagship BSMS trained on mesh 0's Loader batch
               through make_step_fns(needs_hierarchy=True): fp32 first-step
               gradients against the plain path and twice bit-equal, 5
               steps each launching K1-K4 15 times, K5 25 (15 + the pools'
               6 + the unpools' backward 4) and K7 8 times, finite losses,
               peak device memory, one step profiled;
  9. zoo     — the registry's unfused model zoo built by
               models.registry.build_model from the model dicts of
               aero_gnn_tpu/config/default.yaml (written out here), served
               through AeroInference.predict_batch over Loader([mesh], 1)
               batches and trained through make_step_fns: FourierMGN (15
               layers, width 128, the unfused layer, remat on) serves the
               three meshes and trains 5 steps in bf16 and in fp32;
               poolMGN, MGNv2 (trial1) and MLPNet serve mesh 0 and train 2
               fp32 steps. K6 and K5 launches are asserted per forward and
               per step (poolMGN's and MGNv2's per-graph pool on K5 in two
               passes, and its broadcast's backward); fp32 predictions and
               one fp32 step's gradients against the plain path, poolMGN's
               and MGNv2's fp32 forward and step gradients twice, bit-equal
               without deterministic algorithms; one FourierMGN fp32
               forward and one step profiled;
  10. save_acts — with AERO_GNN_SAVE_ACTS=1 the flagship MGN trained on
               mesh 0 as in phase 6 (remat off): fp32 first-step gradients
               against the plain path, 5 bf16 and 2 fp32 steps, each
               launching K1's save variant, K8, K3, K4 and K5 15 times and
               K1, K2 0 times; one bf16 step profiled;
  11. mega   — with AERO_GNN_MEGA=1 the flagship MGN served (3 requests
               per dtype, K9-fwd 15 launches per forward, K1 and K3 0; fp32
               request 0 against the plain path; one warm forward per
               dtype profiled) and trained on mesh 0
               (fp32 first-step gradients against the plain path, 3 bf16
               steps and 1 fp32 step, each launching K9-fwd, K9-bwd and K5
               15 times and K1-K4 0); one bf16 step profiled.

  8b. bsms_switches — the flagship BSMS under each of the JAX package's
               transfer switches that the port reads
               (AERO_GNN_SORTED_POOL=0 and =1, AERO_GNN_WEC_FUSED=0): first
               K5 in its pool use (ops.segment_pool_sum over the pool
               stream cut before its pad tail, as the model calls it) at
               the fine level's shapes (node rows x 128, edge rows x 128,
               the edge weight sums x 1, fp32) against its plain version
               over the whole stream, bit-equal across launches, timed
               beside its bound, index_add_ (the torch backend's pool,
               which K5 must not be slower than) and torch.sparse.mm of the
               pool's CSR matrix; then per switch 2 requests served (within
               1e-3 of the plain path with every switch off; K1, K3 15 a
               forward, K5 6 (the pools), K5 4 more in place of K7's 4
               under WEC_FUSED=0), request 0's fp32 forward twice and one
               fp32 step's gradients twice, bit-equal without
               deterministic algorithms, the gradients against the plain
               path, and 2 steps (K1-K4 15, K5 15 + 6 + 4 (the unpools'
               backward), + 8 more under WEC_FUSED=0, K7 8 or 0);
  12. remat  — on the tight 65,536-node graph, bf16 and fp32: one step's
               parameter gradients under grouped remat (remat_group 3
               "save_fused:2", 3 "full", 3 "save_fused:2" with
               remat_offload, 5 "save_fused") against per-layer remat's
               (bit-equal, else within GRAD_TOL and listed), the loss equal,
               K1 and K3 launched remat_forwards() times a step, K2, K4, K5
               15; a forward without grad under remat_group 3 launches K1
               and K3 15 times;
  13. large  — first K1 and K3 (forward) and K2, K4 and K5 (backward)
               against their plain versions on the 1,048,576-node mesh's
               tight aligned layout, bf16 and fp32 (an fp32 [E, 128]
               operand there is past 2^31 bytes), K2, K4, K5 bit-equal
               across launches; then the flagship MGN trained on that
               graph through make_step_fns, one warm step and
               timed steps (CUDA events; edges/s over their median; the
               peak of utils.profiling.device_memory_stats): (a) bf16
               remat_group 3 "save_fused:2" (bench.py's choice at this
               size), (c) (a)'s knobs with remat_offload (its inner
               policy then full in every group, as JAX's), (b) bf16
               remat_group 3
               "full", (d) fp32 as (a), and per-layer bf16 "save_fused" as
               the memory reference; launches gated per step, the bf16
               first losses equal; (c)'s peak below (b)'s (the same inner
               policy without the offload) by at least 2 bf16 group
               boundaries; utils.profiling.trace of one (a) step
               writes a trace file.

  14. parallel — aero_gnn_tpu_torch.parallel over ranks started by
               parallel.distributed.spawn after phase build, each
               loading the built kernels and rebuilding its shard from the
               seed (the 65,536-node mesh, the flagship widths and depth, the
               weights of one seed): (a) halo-split MGN training and serving
               at P = 2, two gloo ranks sharing the card (the fp32 forward
               gathered against the single device's within SERVE_TOL, one
               fp32 step's gradients within TRAIN_GRAD_TOL, 3 bf16 and 1
               fp32 steps timed with CUDA events beside the single-device
               step in turns with AERO_GNN_ASYNC_COLLECTIVES off, on, on,
               off (the exchange issued with async_op and waited for where
               the boundary chain reads it, or synchronous), two
               synchronous fp32 forwards and one fp32 backward's gradients
               each and one asynchronous, all three bit-equal without
               deterministic algorithms, one bf16 step profiled under
               each to measure how many ms of the exchange's device copies
               overlap K1 / K2 on the timeline,
               the replicas bit-equal, K1-K5 launches per rank gated (K5
               also for the boundary chain: its masked sum, its gathers'
               and the send gather's backward),
               the halo's rows, bytes and all_to_all time, K1 and K3
               forward, K2, K4 and K5 backward against their plain versions
               on shard 0's interior in bf16 and fp32, K1 / K2 timed there
               beside the tight graph); (b) the same at P = 1, one rank
               wired by a torchrun-style environment so that initialize()
               chooses NCCL (the exchange async through NCCL); the
               split step at P = 1 without a process group timed and its kernel launches and matrix products
               counted beside the single device's;
               (c) data parallel on meshes 0 and 1 (2 ranks); (d) hybrid
               halo-split on a 2 x 2 grid (4 ranks); (e) the BSMS halo
               scheme (every level sharded, weighted transfer) against the
               single-device BSMS, its K5 launches gated (every transfer's
               sum and gather backward), its fp32 forward and one step's
               gradients twice bit-equal on each rank without
               deterministic algorithms, and K5 in each level's WEC spread
               (ops.segment_pool_sum) against the plain segment sum; (f) (a)'s state saved by save_dcp and
               restored bit-equal by restore_dcp in two fresh ranks.
               ``--parallel-only`` runs the device, build and parallel
               phases.

With both switches unset (phases 3-9, 6b included) every forward and step
launches K8, K9 and K10 0 times.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Nothing of JAX or aero_gnn_tpu is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
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
       # accumulates its products in another order
       "bfloat16": (6.25e-2, 1.5625e-2)}
# fp32 weight gradients (sums over every edge or node row) against the
# plain version: |k - p| <= a * max|p| + r * |p|. In bf16 a ReLU input that
# rounds one ulp to the other side of 0 in one of the two (their products
# accumulate in another order) moves a whole column of a weight gradient by
# that row's share, so the floor is relative to the tensor's scale.
GRAD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1.5625e-2)}
# fused fp32 forward vs the plain path, normalised predictions
SERVE_TOL = (1e-3, 1e-3)
# one fp32 train step's parameter gradients, kernels vs the plain path
TRAIN_GRAD_TOL = (1e-3, 1e-3)
TRAIN_STEPS = {"bfloat16": 10, "float32": 3}
EDGE_GRADS = ("d_e", "d_sg", "d_dproj", "dW_e", "dWs", "dbs", "dW_out",
              "db_out", "dscale", "dbias")
NODE_GRADS = ("d_x", "d_agg", "dW1x", "dW1a", "db1", "dWs", "dbs", "dW_out",
              "db_out", "dscale", "dbias")
N_NODES = 65536
HIDDEN = 128
N_HIDDEN = 2
LAYERS = 15
BSMS_SCALES = 3
# K7 launches: 2 transfers down + 2 up per forward; a step adds their VJPs
K7_PER_FORWARD = 2 * (BSMS_SCALES - 1)
# K5 launches of the BSMS transfers: the sorted pools (nodes, edges, the
# edge weight sums) at each level a forward; the unpool's backward (its
# chunk plan's two passes) at each level a step
K5_BSMS_POOLS = 3 * (BSMS_SCALES - 1)
K5_BSMS_UNPOOL = 2 * (BSMS_SCALES - 1)
# the registry's model sections of aero_gnn_tpu/config/default.yaml
# (model.fouriermgn, model.poolMGN, model.trial1, model.mlpnet), widths and
# depths uncut; remat and compute_dtype at the registry's defaults
_MGN_SECTION = dict(processor_size=LAYERS, activation_fn="relu",
                    hidden_dim=HIDDEN, aggregation="add",
                    num_hidden_layers_decoder=N_HIDDEN,
                    num_hidden_layers_node_encoder=N_HIDDEN,
                    num_hidden_layers_edge_encoder=N_HIDDEN,
                    num_hidden_layers_node_processor=N_HIDDEN,
                    num_hidden_layers_edge_processor=N_HIDDEN, dropout=0.0)
ZOO = {
    "fouriermgn": dict(name="fouriermgn", **_MGN_SECTION,
                       fourier_features_dim=2, fourier_freq_start=-3,
                       fourier_freq_length=7),
    "poolmgn": dict(name="poolMGN", **_MGN_SECTION,
                    global_pool_method="mean",
                    num_hidden_layers_global_encoder=2, global_dim=HIDDEN),
    "mgn_v2": dict(name="trial1", number_of_encoding_layers=3,
                   num_message_passing_layers=LAYERS,
                   number_of_decoding_layers=2, hidden_dim=HIDDEN,
                   dropout=0.0, activation="relu"),
    "mlpnet": dict(name="mlpnet", num_hidden_layers_encoder=3,
                   hidden_dim=HIDDEN, num_hidden_layers_decoder=3,
                   dropout=0.0, activation="relu"),
}
ZOO_DIMS = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4)
# K6 / K5 launches per forward and per train step, from the code: the
# unfused layer gathers its receivers on K6 and aggregates on K5 once per
# layer; a remat step runs each layer's forward twice (the forward and the
# recompute) and adds K6's backward and the sender backward, both on K5.
# MGNv2 aggregates by the mean (K5 for the sum and the degree) and has no
# remat and no node gather; MLPNet passes no message. poolMGN's and MGNv2's
# per-graph pool sums on K5 in two passes (its chunk plan) a forward, and
# the broadcast's backward two more a step.
ZOO_LAUNCHES = {
    "fouriermgn": {"forward": (LAYERS, LAYERS),
                   "step": (2 * LAYERS, 4 * LAYERS)},
    "poolmgn": {"forward": (LAYERS, LAYERS + 2),
                "step": (2 * LAYERS, 4 * LAYERS + 4)},
    "mgn_v2": {"forward": (0, 2 * LAYERS + 2), "step": (0, 2 * LAYERS + 4)},
    "mlpnet": {"forward": (0, 0), "step": (0, 0)},
}
# the kinds whose repeated fp32 forwards and step gradients are held bit
# for bit (their sums' order is the graph's: the per-graph pools)
ZOO_REPEAT = ("poolmgn", "mgn_v2")
ZOO_STEPS = {"fouriermgn": 5, "poolmgn": 2, "mgn_v2": 2, "mlpnet": 2}
# the kernels of the switched paths: K1's save variant and K8
# (AERO_GNN_SAVE_ACTS), K9 (AERO_GNN_MEGA) and the WEC pair probe's K10
SWITCHED = ("fused_edge_fwd_save", "fused_edge_bwd_saved", "fused_mgn_fwd",
            "fused_mgn_bwd", "segment_sum_weighted2")
SAVE_ACTS_STEPS = {"bfloat16": 5, "float32": 2}
MEGA_STEPS = {"bfloat16": 3, "float32": 1}
# micro_wec2.py's K: dual launches in the probe's timed run
WEC2_PAIRS = 30
# phase large: the flagship MGN at 1,048,576 nodes, where bench.py:164-196
# turns on grouped remat (remat_group 3; "save_fused:2" above 786,432
# nodes); (label, compute dtype, remat knobs, timed steps after one warm
# step). "per_layer" (per-layer "save_fused", no groups) is the memory
# reference.
LARGE_NODES = 1048576
GROUPED = dict(remat_group=3, remat_group_policy="save_fused:2")
LARGE_RUNS = (("a", "bfloat16", GROUPED, 2),
              ("c", "bfloat16", dict(GROUPED, remat_offload=True), 2),
              ("b", "bfloat16", dict(remat_group=3, remat_group_policy="full"),
               2),
              ("d", "float32", GROUPED, 1),
              ("per_layer", "bfloat16", {}, 2))
# phase remat: the same schemes on the 65,536-node graph, and 3 groups of 5
REMAT_RUNS = (("a", GROUPED), ("b", dict(remat_group=3,
                                         remat_group_policy="full")),
              ("c", dict(GROUPED, remat_offload=True)),
              ("g5", dict(remat_group=5, remat_group_policy="save_fused")))
# phase bsms_switches: each BSMS transfer switch of the JAX package (both
# settings of AERO_GNN_SORTED_POOL)
BSMS_SWITCHES = (("default_pool", "AERO_GNN_SORTED_POOL", "0"),
                 ("sorted_pool", "AERO_GNN_SORTED_POOL", "1"),
                 ("wec_unfused", "AERO_GNN_WEC_FUSED", "0"))


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
    t0 = time.perf_counter()
    _build.host_library("graphcore")
    log(f"[build] graph core (csrc/host/graphcore.cpp, g++) built and "
        f"loaded in {time.perf_counter() - t0:.2f} s")
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
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    dev = graph.device
    N = graph.num_nodes_pad
    real = graph.edge_mask > 0
    gen = torch.Generator(device=dev).manual_seed(99)
    for h, nh in ((128, 0), (128, 4), (64, 2)):
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)

            def r(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen, device=dev)
                        * scale).to(dt)

            edge_args, edge_bwd, node_args, node_bwd, seg = bwd_cases(
                torch, graph, dt, r, h, nh)
            ek, ak = HF.fused_edge_layer(*edge_args)
            ep, ap = HF.fused_edge_layer_ref(*edge_args)
            xk = HN.fused_node_layer(*node_args)
            xp = HN.fused_node_layer_ref(*node_args)
            # K5 as aggregate_edges calls it: receivers, edge mask, no rows
            mk = HS.segment_sum(seg[0], graph.receivers, N,
                                mask=graph.edge_mask.to(dt))
            mp = HS.segment_sum_ref(seg[0], graph.receivers, N,
                                    mask=graph.edge_mask.to(dt))
            torch.cuda.synchronize()
            tag = f"h={h} n_hidden={nh} {dtype_name}"
            errs = (check_close(torch, f"K1 {tag} e'", ek, ep, dtype_name,
                                rows=real),
                    check_close(torch, f"K1 {tag} agg", ak, ap, dtype_name),
                    check_close(torch, f"K3 {tag} x'", xk, xp, dtype_name),
                    check_close(torch, f"K5 {tag} masked", mk, mp,
                                dtype_name))
            e2, e4, e5 = check_backward_kernels(torch, tag, dtype_name, graph,
                                                edge_bwd, node_bwd, seg)
            log(f"[shapes] {tag}: max abs err K1 e' {errs[0]:.3e}, agg "
                f"{errs[1]:.3e}, K3 {errs[2]:.3e}, K2 {e2[0]:.3e} (weight "
                f"grads {e2[1]:.3e} of max|p|), K4 {e4[0]:.3e} ({e4[1]:.3e}), "
                f"K5 {e5:.3e} / masked {errs[3]:.3e}")
            check_switched_shapes(torch, tag, dtype_name, graph, edge_args,
                                  edge_bwd, node_args, node_bwd[-1])
    for dtype_name in ("bfloat16", "float32"):
        check_deep_edge(torch, graph, dtype_name)


def check_deep_edge(torch, graph, dtype_name, nh=10):
    """K1 and K2 on a stack deeper than the ReLU masks K2's row kernel
    keeps in registers (csrc/rows_bwd.cuh kMaxHidden; K1's bf16 weights no
    longer fit resident either, so they stream through its ring), against
    their plain versions (the K1 rule; K2's activation gradients by it, its
    weight gradients by GRAD_TOL) and across two launches."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF

    dt, h = getattr(torch, dtype_name), HIDDEN
    dev, real = graph.device, graph.edge_mask > 0
    gen = torch.Generator(device=dev).manual_seed(1010)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    edge_args, edge_bwd, _, _, _ = bwd_cases(torch, graph, dt, randn, h, nh)
    k1, p1 = HF.fused_edge_layer(*edge_args), HF.fused_edge_layer_ref(
        *edge_args)
    k2 = HF.fused_edge_layer_bwd(*edge_bwd)
    p2 = HF.fused_edge_layer_bwd_ref(*edge_bwd)
    torch.cuda.synchronize()
    tag = f"{dtype_name} n_hidden={nh}"
    e1 = max(check_close(torch, f"K1 {tag} e'", k1[0], p1[0], dtype_name,
                         rows=real),
             check_close(torch, f"K1 {tag} agg", k1[1], p1[1], dtype_name))
    act, wrel = check_bwd(torch, f"K2 {tag}", k2, p2, dtype_name, 3)
    for name, fn, first in (
            ("K1", lambda: HF.fused_edge_layer(*edge_args), k1),
            ("K2", lambda: HF.fused_edge_layer_bwd(*edge_bwd), k2)):
        if not same_bits(torch, fn(), first):
            raise AssertionError(f"{name} {tag}: outputs differ between two "
                                 "launches on the same inputs")
    log(f"[shapes] {tag}, E={graph.num_edges_pad}: max abs err K1 {e1:.3e}, "
        f"K2 {act:.3e} (weight grads {wrel:.3e} of max|p|); bit-equal across "
        "launches")


def check_switched_shapes(torch, tag, dtype_name, graph, edge_args, edge_bwd,
                          node_args, ct_x):
    """The save variant, K8, K9-fwd and K9-bwd against their plain versions
    in one of phase_shapes' configurations (their shared-memory plans
    differ with the width and the number of hidden layers)."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_mega as HM

    real = graph.edge_mask > 0
    sv = HF.fused_edge_layer_save(*edge_args)
    sp = HF.fused_edge_layer_save_ref(*edge_args)
    a8 = k8_args(edge_args, sp[2:], edge_bwd[12], edge_bwd[13])
    k8 = HF.fused_edge_layer_bwd_saved(*a8)
    ma = mega_args(HM, edge_args, node_args)
    k9, p9 = HM.fused_mgn_layer(*ma), HM.fused_mgn_layer_ref(*ma)
    b9_args = (*ma[:4], k9[2], *ma[4:8], edge_bwd[12], ct_x, ma[8])
    b9 = HM.fused_mgn_layer_bwd(*b9_args)
    torch.cuda.synchronize()
    err_save = max(
        check_close(torch, f"K1 save {tag} zs", sv[2][:, real],
                    sp[2][:, real], dtype_name),
        *(check_close(torch, f"K1 save {tag} {nm}", a, b, dtype_name,
                      rows=real)
          for nm, a, b in zip(("e'", "d", "mu", "inv"),
                              (sv[0], *sv[3:]), (sp[0], *sp[3:]))))
    e8 = check_bwd(torch, f"K8 {tag}", k8,
                   HF.fused_edge_layer_bwd_saved_ref(*a8), dtype_name, 3)
    err9 = max(check_close(torch, f"K9-fwd {tag} x'", k9[0], p9[0],
                           dtype_name),
               check_close(torch, f"K9-fwd {tag} e'", k9[1], p9[1],
                           dtype_name, rows=real),
               check_close(torch, f"K9-fwd {tag} agg", k9[2], p9[2],
                           dtype_name))
    b = check_mgn_bwd(torch, f"K9-bwd {tag}", b9,
                      HM.fused_mgn_layer_bwd_ref(*b9_args), dtype_name)
    log(f"[shapes] {tag}: max abs err K1 save variant {err_save:.3e}, K8 "
        f"{e8[0]:.3e} ({e8[1]:.3e}), K9-fwd {err9:.3e}, K9-bwd {b[0]:.3e} "
        f"({b[1]:.3e})")


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


def host_graph_build(torch, sample, dev, smi: str) -> dict:
    """build_graph_batch's host ms on ``sample`` (flagship_graph's layout)
    with the graph core (padded._edge_layout: native.edge_layout's one
    pass; padded.chunk_plan: native.chunk_plan) and with the numpy plain
    versions (padded._edge_layout_ref, padded.chunk_plan_ref), in turns
    (core, numpy, numpy, core), and the edge layout alone (with its align
    map); the two batches and the two layouts bit-equal. Host clock, the
    build ending in a synchronize."""
    import dataclasses

    import numpy as np

    from aero_gnn_tpu_torch.graph import padded

    paths = {"core": (padded._edge_layout, padded.chunk_plan),
             "numpy": (padded._edge_layout_ref, padded.chunk_plan_ref)}
    n = sample.num_nodes
    np_pad = -(-(n + 1) // 512) * 512
    kw = dict(senders=sample.senders, receivers=sample.receivers,
              x=sample.x, edge_attr=sample.edge_attr, pos=sample.pos,
              y=sample.y, num_nodes_pad=np_pad, align_edges=True, device=dev)
    lay_args = (np.asarray(sample.senders, np.int32),
                np.asarray(sample.receivers, np.int32),
                np.asarray(sample.edge_attr, np.float32), np_pad, None, True,
                True)
    ms = {"core": [], "numpy": []}
    layout_ms = {"core": [], "numpy": []}
    first, first_lay = {}, {}
    try:
        for name in ("core", "numpy", "numpy", "core"):
            layout, plan = paths[name]
            padded._edge_layout, padded.chunk_plan = layout, plan
            t0 = time.perf_counter()
            g = padded.build_graph_batch(**kw)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            lay = layout(*lay_args)
            layout_ms[name].append((time.perf_counter() - t0) * 1e3)
            first.setdefault(name, g)
            first_lay.setdefault(name, lay)
            del g, lay
    finally:
        padded._edge_layout, padded.chunk_plan = paths["core"]
    a, b = first["core"], first["numpy"]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        same = (x.dtype == y.dtype and torch.equal(x, y)
                if isinstance(x, torch.Tensor) else x == y)
        if not same:
            raise AssertionError(f"host graph build at {n} nodes: {f.name} "
                                 "differs between the graph core and numpy")
    for key, x in first_lay["core"].items():
        y = first_lay["numpy"][key]
        same = (x.dtype == y.dtype and np.array_equal(x, y)
                if isinstance(x, np.ndarray) else x == y)
        if not same:
            raise AssertionError(f"edge layout at {n} nodes: {key} differs "
                                 "between the graph core and numpy")
    log(f"[host] build_graph_batch at {n} nodes ({sample.num_edges} edges, "
        f"aligned, to the card), host ms in turns core / numpy / numpy / "
        f"core: {ms['core'][0]:.1f} / {ms['numpy'][0]:.1f} / "
        f"{ms['numpy'][1]:.1f} / {ms['core'][1]:.1f}; the edge layout "
        f"alone with its align map (graph core / numpy): "
        f"{layout_ms['core'][0]:.1f} / {layout_ms['numpy'][0]:.1f} / "
        f"{layout_ms['numpy'][1]:.1f} / {layout_ms['core'][1]:.1f}; batches "
        f"and layouts bit-equal (host clock; {smi})")
    return {"nodes": n, "edges": sample.num_edges, "build_ms": ms,
            "layout_ms": layout_ms}


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


def check_grad(torch, name, got, ref, tol):
    """|got - ref| <= a * max|ref| + r * |ref| elementwise; returns the
    max abs error."""
    a, r = tol
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values from the kernel")
    if ref.numel() == 0:
        return 0.0
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    bad = err > a * scale + r * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {ref.numel()} values outside "
            f"{a} max|p| + {r} |p| (max|p| {scale:.3e}); max abs err "
            f"{float(err.max()):.3e}")
    return float(err.max())


def check_bwd(torch, name, got, ref, dtype, n_act):
    """A backward kernel's outputs: the first ``n_act`` are activation
    gradients in the compute dtype (the K1/K3 rule), the rest fp32 weight
    gradients (GRAD_TOL). Returns (max abs err of the activation gradients,
    max abs err of the weight gradients / max|p|)."""
    names = EDGE_GRADS if len(got) == len(EDGE_GRADS) else NODE_GRADS
    act, wrel = 0.0, 0.0
    for i, (nm, g, r) in enumerate(zip(names, got, ref)):
        if i < n_act:
            act = max(act, check_close(torch, f"{name} {nm}", g, r, dtype))
        else:
            err = check_grad(torch, f"{name} {nm}", g, r, GRAD_TOL[dtype])
            scale = float(r.abs().max()) if r.numel() else 0.0
            wrel = max(wrel, err / scale if scale else 0.0)
    return act, wrel


def bwd_cases(torch, graph, dt, randn, h, nh):
    """Random inputs of K1/K2 and K3/K4 on ``graph`` (weights ~ 1/sqrt(h),
    the edge cotangent zero on pad rows as on the training path) and K5's
    aligned sender stream: (edge_args, edge_bwd_args, node_args,
    node_bwd_args, seg_args)."""
    E, N = graph.num_edges_pad, graph.num_nodes_pad
    real = (graph.edge_mask > 0).to(dt)
    w = 1.0 / h ** 0.5
    edge_args = (randn(E, h), randn(E, h), randn(N, h), graph.edge_mask.to(dt),
                 graph.receivers, randn(h, h, scale=w),
                 randn(nh, h, h, scale=w), randn(nh, h, scale=0.1),
                 randn(h, h, scale=w), randn(h, scale=0.1),
                 1 + randn(h, scale=0.1), randn(h, scale=0.1), N)
    node_args = (randn(N, h), randn(N, h, scale=3.0), randn(h, h, scale=w),
                 randn(h, h, scale=w), randn(h, scale=0.1),
                 randn(nh, h, h, scale=w), randn(nh, h, scale=0.1),
                 randn(h, h, scale=w), randn(h, scale=0.1),
                 1 + randn(h, scale=0.1), randn(h, scale=0.1))
    edge_bwd = edge_args[:-1] + (randn(E, h) * real[:, None], randn(N, h), N)
    node_bwd = node_args + (randn(N, h),)
    seg = (randn(E, h), graph.senders_sorted, N)
    return edge_args, edge_bwd, node_args, node_bwd, seg


def check_backward_kernels(torch, tag, dtype_name, graph, edge_bwd, node_bwd,
                           seg):
    """K2, K4 and K5 against their plain versions; their outputs (K2's and
    K4's weight gradients included) bit-equal across two launches; K5's
    rows of nodes without a row exact zeros. Returns the max abs errors."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_node as HN
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    k2 = HF.fused_edge_layer_bwd(*edge_bwd)
    p2 = HF.fused_edge_layer_bwd_ref(*edge_bwd)
    k4 = HN.fused_node_layer_bwd(*node_bwd)
    p4 = HN.fused_node_layer_bwd_ref(*node_bwd)
    k5 = HS.segment_sum(*seg, rows=graph.sender_perm, pad_sink=True)
    p5 = HS.segment_sum_ref(*seg, rows=graph.sender_perm, pad_sink=True)
    torch.cuda.synchronize()
    e2 = check_bwd(torch, f"K2 {tag}", k2, p2, dtype_name, 3)
    e4 = check_bwd(torch, f"K4 {tag}", k4, p4, dtype_name, 2)
    e5 = check_close(torch, f"K5 {tag}", k5, p5, dtype_name)
    for name, again, first in (
            ("K2", HF.fused_edge_layer_bwd(*edge_bwd), k2),
            ("K4", HN.fused_node_layer_bwd(*node_bwd), k4),
            ("K5", (HS.segment_sum(*seg, rows=graph.sender_perm,
                                   pad_sink=True),), (k5,))):
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{name} {tag}: outputs differ between two "
                                 "launches on the same inputs")
    empty = torch.bincount(seg[1], minlength=seg[2]) == 0
    if not (k5[empty] == 0).all():
        raise AssertionError(f"K5 {tag}: rows of nodes without a row are "
                             "not exactly 0")
    return e2, e4, e5


def sink_kw(HS):
    """K5's ``pad_sink`` keyword as the sender backward passes it (empty on
    a tree from before the pad-tail repair, whose K5 has no such option, so
    the tail phase also times such a tree)."""
    import inspect

    params = inspect.signature(HS.segment_sum).parameters
    return {"pad_sink": True} if "pad_sink" in params else {}


def agg_sink_kw(ops):
    """K5's ``pad_sink`` keyword as the unfused aggregation passes it (empty
    on a tree from before that aggregation declared the pad sink, which
    walked the tail)."""
    import inspect

    params = inspect.signature(ops.aggregate_edges).parameters
    return {"pad_sink": True} if "pad_sink" in params else {}


def phase_tail(torch, sample, tight):
    """K1, K2 and K5 on the Loader-padded graph of ``sample`` against the
    tight aligned graph, both dtypes, checked against the plain versions;
    then one bf16 MGN train step through each graph. The Loader budgets an
    extra tile per node block, so its stream ends in a tail of pad rows
    that all have the pad sink as receiver."""
    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_segment as HS
    from aero_gnn_tpu_torch.training import loop as TL

    dev = tight.device
    agg_kw = agg_sink_kw(ops)
    loader = Loader([sample], 1, align_edges=True, device=dev)
    padded = next(iter(loader))[0]
    sink = padded.num_nodes_pad - 1
    graphs = {"tight": tight, "loader": padded}
    rec = {}
    for name, g in graphs.items():
        live = int((g.receivers != g.num_nodes_pad - 1).sum())
        rec[name] = {"E": g.num_edges_pad, "N": g.num_nodes_pad,
                     "live_rows": live,
                     "sender_rows": g.senders_sorted.shape[0]}
        log(f"[tail] {name} graph: E={g.num_edges_pad}, N={g.num_nodes_pad}, "
            f"{live} rows before the sink tail, sender stream "
            f"{g.senders_sorted.shape[0]} rows")
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for name, g in graphs.items():
            gen = torch.Generator(device=dev).manual_seed(4321)

            def randn(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen, device=dev)
                        * scale).to(dt)

            edge_args, edge_bwd, _, _, seg = bwd_cases(
                torch, g, dt, randn, HIDDEN, N_HIDDEN)
            real = g.edge_mask > 0
            # the sender backward reads d_sg, which is 0 on pad rows
            data = seg[0] * real[:, None].to(dt)
            ids, rows, kw = g.senders_sorted, g.sender_perm, sink_kw(HS)
            ek, ak = HF.fused_edge_layer(*edge_args)
            ep, ap = HF.fused_edge_layer_ref(*edge_args)
            k2 = HF.fused_edge_layer_bwd(*edge_bwd)
            p2 = HF.fused_edge_layer_bwd_ref(*edge_bwd)
            k5 = HS.segment_sum(data, ids, g.num_nodes_pad, rows=rows, **kw)
            p5 = HS.segment_sum_ref(data, ids, g.num_nodes_pad, rows=rows,
                                    **kw)
            # the unfused aggregation: K5 over the receiver stream with the
            # edge mask, as ops.aggregate_edges launches it
            msgs, emask = edge_args[0], edge_args[3]
            agg = dict(mask=emask, **agg_kw)
            with torch.no_grad():
                ka = ops.aggregate_edges(msgs, g.receivers, g.num_nodes_pad,
                                         aggregation="add", edge_mask=emask,
                                         aligned=True, **agg_kw)
            ka2 = HS.segment_sum(msgs, g.receivers, g.num_nodes_pad, **agg)
            pa = HS.segment_sum_ref(msgs, g.receivers, g.num_nodes_pad,
                                    mask=emask)
            torch.cuda.synchronize()
            tag = f"{name} {dtype_name}"
            check_close(torch, f"tail K1 {tag} e'", ek, ep, dtype_name,
                        rows=real)
            check_close(torch, f"tail K1 {tag} agg", ak, ap, dtype_name)
            check_bwd(torch, f"tail K2 {tag}", k2, p2, dtype_name, 3)
            check_close(torch, f"tail K5 {tag}", k5, p5, dtype_name)
            check_close(torch, f"tail K5 aggregation {tag}", ka, pa,
                        dtype_name)
            if not torch.equal(ka, ka2):
                raise AssertionError(f"tail K5 aggregation {tag}: the timed "
                                     "launch differs from aggregate_edges")
            if name == "loader" and not (ak[sink] == 0).all():
                raise AssertionError(f"tail K1 {tag}: the sink's agg is not 0")
            del ep, ap, p2, p5, pa, ka2
            reps = {"reps": 10, "warmup": 2}
            times = {
                "K1": cuda_time_ms(torch, lambda: HF.fused_edge_layer(
                    *edge_args), **reps),
                "K2": cuda_time_ms(torch, lambda: HF.fused_edge_layer_bwd(
                    *edge_bwd), **reps),
                "K5": cuda_time_ms(torch, lambda: HS.segment_sum(
                    data, ids, g.num_nodes_pad, rows=rows, **kw), **reps),
                "K5agg": cuda_time_ms(torch, lambda: HS.segment_sum(
                    msgs, g.receivers, g.num_nodes_pad, **agg), **reps)}
            rec[name][dtype_name] = times
            log(f"[tail] {tag}: K1 {times['K1']:.3f} ms, K2 "
                f"{times['K2']:.3f} ms, K5 {times['K5']:.3f} ms, K5 "
                f"aggregation {times['K5agg']:.3f} ms")
            del edge_args, edge_bwd, seg, data, ek, ak, k2, k5, ka, msgs
            torch.cuda.empty_cache()
    for k in ("K1", "K2", "K5", "K5agg"):
        for dtype_name in ("bfloat16", "float32"):
            ratio = (rec["loader"][dtype_name][k]
                     / rec["tight"][dtype_name][k])
            rec.setdefault("ratio", {})[f"{k}[{dtype_name}]"] = ratio
    log(f"[tail] loader / tight time: " + ", ".join(
        f"{k} {v:.2f}" for k, v in rec["ratio"].items()))
    over = {k: v for k, v in rec["ratio"].items()
            if k.startswith("K1[") and v > 1.3}
    if over:
        raise AssertionError(f"K1 Loader / tight time above 1.3: {over}")
    cfg = flagship_config(compute_dtype="bfloat16")
    for name, g in graphs.items():
        params = cfg.init(torch.Generator().manual_seed(0), device=dev)
        fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3),
                               device=dev)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(fns.train_step(params, g))
            times.append(time.perf_counter() - t0)
        if not math.isfinite(loss):
            raise AssertionError(f"tail train step {name}: loss {loss}")
        rec[name]["bf16_step_ms"] = statistics.median(times[1:]) * 1e3
        log(f"[tail] bf16 MGN train step through the {name} graph: "
            f"{rec[name]['bf16_step_ms']:.2f} ms (median of 2 warm steps; "
            f"loss {loss:.5f})")
        del params, fns
        torch.cuda.empty_cache()
    return rec


def phase_kernels(torch, graph):
    """Every kernel against its plain version at the flagship shapes."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_node as HN
    from aero_gnn_tpu_torch.ops import hopper_segment as HS
    from aero_gnn_tpu_torch.ops.scatter import degree

    dev = graph.device
    E, N, h, nh = graph.num_edges_pad, graph.num_nodes_pad, HIDDEN, N_HIDDEN
    Es = graph.senders_sorted.shape[0]
    real = graph.edge_mask > 0
    empty = degree(graph.receivers, N, mask=graph.edge_mask) == 0
    log(f"[kernels] flagship layout: E={E} (real {int(real.sum())}), N={N}, "
        f"h={h}, n_hidden={nh}; {int(empty.sum())} nodes without a real "
        f"edge; sender stream {Es} rows (aligned: {graph.senders_aligned})")
    lengths = torch.bincount(graph.senders_sorted, minlength=N)
    perm = graph.sender_perm.long()
    results = []
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(1234)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=dev)
                    * scale).to(dt)

        edge_args, edge_bwd, node_args, node_bwd, seg = bwd_cases(
            torch, graph, dt, randn, h, nh)
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
        if not torch.equal(xk, HN.fused_node_layer(*node_args)):
            raise AssertionError(f"K3 {dtype_name}: x' differs between two "
                                 "launches on the same inputs")
        del ek, ak, ak2, ep, ap, xk, xp
        e2, e4, e5 = check_backward_kernels(torch, dtype_name, dtype_name,
                                            graph, edge_bwd, node_bwd, seg)
        log(f"[kernels] {dtype_name}: K2 max abs err {e2[0]:.3e} (weight "
            f"grads {e2[1]:.3e} of max|p|), K4 {e4[0]:.3e} ({e4[1]:.3e}), K5 "
            f"{e5:.3e}; K2 / K4 bit-equal across launches")

        isz = torch.finfo(dt).bits // 8
        w_edge = sum(t.numel() for t in edge_args[5:12])
        w_node = sum(t.numel() for t in node_args[2:])
        dw_edge = (nh + 2) * h * h + (nh + 3) * h
        dw_node = (nh + 3) * h * h + (nh + 4) * h
        gathered = seg[0][perm]
        kernels = (
            ("fused_edge_fwd", "aero_gnn_tpu/ops/pallas_fused.py:488",
             lambda: HF.fused_edge_layer(*edge_args),
             lambda: HF.fused_edge_layer_ref(*edge_args), None,
             2 * E * h * h * (2 + nh),
             (3 * E * h + 2 * N * h + E + w_edge) * isz + 4 * E,
             max(err_e, err_a)),
            ("fused_node_fwd", "aero_gnn_tpu/ops/pallas_node.py:143",
             lambda: HN.fused_node_layer(*node_args),
             lambda: HN.fused_node_layer_ref(*node_args), None,
             2 * N * h * h * (3 + nh), (3 * N * h + w_node) * isz, err_x),
            ("fused_edge_bwd", "aero_gnn_tpu/ops/pallas_fused.py:789",
             lambda: HF.fused_edge_layer_bwd(*edge_bwd),
             lambda: HF.fused_edge_layer_bwd_ref(*edge_bwd), None,
             3 * 2 * E * h * h * (2 + nh),
             (5 * E * h + 3 * N * h + E + w_edge) * isz + 4 * E
             + 4 * dw_edge, e2[0]),
            ("fused_node_bwd", "aero_gnn_tpu/ops/pallas_node.py:284",
             lambda: HN.fused_node_layer_bwd(*node_bwd),
             lambda: HN.fused_node_layer_bwd_ref(*node_bwd), None,
             3 * 2 * N * h * h * (3 + nh),
             (5 * N * h + w_node) * isz + 4 * dw_node, e4[0]),
            ("segment_sum", "aero_gnn_tpu/ops/pallas_segment.py:428",
             lambda: HS.segment_sum(*seg, rows=graph.sender_perm,
                                    pad_sink=True),
             lambda: HS.segment_sum_ref(*seg, rows=graph.sender_perm,
                                        pad_sink=True), None,
             Es * h, (E * h + N * h) * isz + 8 * Es, e5),
        )
        # K5's library calls. With ``rows`` (its timed call): one SpMM of
        # the [N, E] CSR matrix with a 1 at (ids[i], sender_perm[i]) for
        # the rows before the sink tail, on the [E, h] cotangent; without
        # (ms_without_rows): segment_reduce of the pre-gathered rows.
        s_live = int((graph.senders_sorted != N - 1).sum())
        crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(
            graph.senders_sorted[:s_live], minlength=N), 0)
        k5_csr = torch.sparse_csr_tensor(
            crow, graph.sender_perm[:s_live].long(),
            torch.ones(s_live, dtype=dt, device=dev), size=(N, E))
        for name, replaces, fn, ref, lib, flops, nbytes, err in kernels:
            peak = PEAK_FLOPS["float32" if name == "segment_sum"
                              else dtype_name]
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            ms = cuda_time_ms(torch, fn)
            plain_ms = cuda_time_ms(torch, ref)
            library_ms = cuda_time_ms(torch, lib) if lib else None
            results.append({
                "name": f"{name}[{dtype_name}]", "route": "cuda",
                "source": f"aero_gnn_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms, "flops": flops, "bytes": nbytes})
            if name == "segment_sum":
                # what folding ct[sender_perm] into K5 saves: K5 on the
                # pre-gathered rows, and the [E, h] permutation gather alone
                rec5 = results[-1]
                rec5["ms_without_rows"] = cuda_time_ms(
                    torch, lambda: HS.segment_sum(gathered, *seg[1:],
                                                  pad_sink=True))
                rec5["perm_gather_ms"] = cuda_time_ms(
                    torch, lambda: seg[0].index_select(0, graph.sender_perm))
                library_ms = rec5["library_ms"] = sparse_mm_ms(
                    torch, k5_csr, seg[0], f"K5 {dtype_name}")
                rec5["library_ms_without_rows"] = cuda_time_ms(
                    torch, lambda: torch.segment_reduce(gathered, "sum",
                                                        lengths=lengths))
                log(f"[kernels] segment_sum {dtype_name} on the pre-gathered "
                    f"rows: {rec5['ms_without_rows']:.3f} ms (segment_reduce "
                    f"on them {rec5['library_ms_without_rows']:.3f} ms); the "
                    f"permutation gather alone {rec5['perm_gather_ms']:.3f} "
                    f"ms; with rows, sparse.mm {fmt_ms(library_ms)}")
            if name == "fused_node_bwd":
                plan = HN.node_bwd_plan(
                    N, h, nh, dt, torch.cuda.get_device_properties(
                        dev).multi_processor_count,
                    torch.cuda.get_device_properties(
                        dev).shared_memory_per_block_optin)
                results[-1]["plan"] = plan
                log(f"[kernels] fused_node_bwd {dtype_name} plan: grid "
                    f"{plan['grid']}, weights "
                    f"{'resident' if plan['resident'] else 'in the ring'}, "
                    f"dynamic shared memory {plan['smem_bytes']} B (row "
                    f"kernel) / {plan['dw_smem_bytes']} B (weight "
                    f"gradients), workspace {plan['ws_bytes'] / 1e6:.1f} MB")
            if name == "fused_edge_fwd":
                props = torch.cuda.get_device_properties(dev)
                plan = HF.edge_fwd_plan(
                    E, N, h, nh, dt, props.multi_processor_count,
                    props.shared_memory_per_block_optin)
                results[-1]["plan"] = plan
                log(f"[kernels] fused_edge_fwd {dtype_name} plan: grid "
                    f"{plan['grid']}, weights "
                    f"{'resident' if plan['resident'] else 'in the ring'}, "
                    f"dynamic shared memory {plan['smem_bytes']} B")
            if name == "fused_node_fwd":
                props = torch.cuda.get_device_properties(dev)
                plan = HN.node_fwd_plan(
                    N, h, nh, dt, props.multi_processor_count,
                    props.shared_memory_per_block_optin)
                results[-1]["plan"] = plan
                log(f"[kernels] fused_node_fwd {dtype_name} plan: grid "
                    f"{plan['grid']} over {plan['n_chunks']} chunks, weights "
                    f"{'resident' if plan['resident'] else 'in the ring'}, "
                    f"dynamic shared memory {plan['smem_bytes']} B")
            if name in ("fused_edge_fwd", "fused_node_fwd", "fused_edge_bwd",
                        "fused_node_bwd", "segment_sum"):
                for line in ptxas_lines(name):
                    log(f"[kernels] {name} ptxas: {line}")
            lib_txt = ("" if library_ms is None
                       else f", library {library_ms:.3f} ms")
            log(f"[kernels] {name} {dtype_name}: {ms:.3f} ms (plain "
                f"{plain_ms:.3f} ms{lib_txt}), bound "
                f"{max(t_bytes, t_ops):.4f} ms by {results[-1]['bound_by']}, "
                f"max abs err {err:.3e}")
        del edge_args, edge_bwd, node_args, node_bwd, seg, gathered, kernels
        del k5_csr
        torch.cuda.empty_cache()
        check_k5_widths(torch, graph, dtype_name)
        check_deep_node_fwd(torch, dev, dtype_name)
        check_deep_node_bwd(torch, dev, dtype_name)
    return results


def check_k5_widths(torch, graph, dtype_name):
    """K5 (the counted wrapper) against its plain version on the sender
    stream with ``rows`` and the pad sink at the widths that do not take
    its bulk-copy ring: 1 and 34 (no whole number of 16-byte pieces) and
    640 (wider than the ring takes; lane groups in two column blocks)."""
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    dev, N = graph.device, graph.num_nodes_pad
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(34)
    real = (graph.edge_mask > 0).to(dt)[:, None]
    kw = dict(rows=graph.sender_perm, pad_sink=True)
    errs = []
    for w in (1, 34, 640):
        data = torch.randn(graph.num_edges_pad, w, generator=gen,
                           device=dev).to(dt) * real
        k = HS.segment_sum(data, graph.senders_sorted, N, **kw)
        p = HS.segment_sum_ref(data, graph.senders_sorted, N, **kw)
        torch.cuda.synchronize()
        errs.append(check_close(torch, f"K5 {dtype_name} h={w}", k, p,
                                dtype_name))
        if not torch.equal(k, HS.segment_sum(data, graph.senders_sorted, N,
                                             **kw)):
            raise AssertionError(f"K5 {dtype_name} h={w}: outputs differ "
                                 "between two launches on the same inputs")
        del data, k, p
    log(f"[kernels] segment_sum {dtype_name} at h = 1, 34, 640 (lane "
        f"groups): max abs err " + ", ".join(f"{e:.3e}" for e in errs)
        + "; bit-equal across launches")


def check_deep_node_fwd(torch, dev, dtype_name, n_rows=2048, nh=10):
    """K3 on a stack deeper than its bf16 weights fit resident (they stream
    through its ring), against its plain version (TOL) and across two
    launches."""
    from aero_gnn_tpu_torch.ops import hopper_node as HN

    dt, h = getattr(torch, dtype_name), HIDDEN
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    w = 1.0 / h ** 0.5
    args = (randn(n_rows, h), randn(n_rows, h, scale=3.0),
            randn(h, h, scale=w), randn(h, h, scale=w), randn(h, scale=0.1),
            randn(nh, h, h, scale=w), randn(nh, h, scale=0.1),
            randn(h, h, scale=w), randn(h, scale=0.1),
            1 + randn(h, scale=0.1), randn(h, scale=0.1))
    k3 = HN.fused_node_layer(*args)
    p3 = HN.fused_node_layer_ref(*args)
    torch.cuda.synchronize()
    err = check_close(torch, f"K3 {dtype_name} n_hidden={nh}", k3, p3,
                      dtype_name)
    if not torch.equal(k3, HN.fused_node_layer(*args)):
        raise AssertionError(f"K3 {dtype_name} n_hidden={nh}: x' differs "
                             "between two launches on the same inputs")
    log(f"[kernels] fused_node_fwd {dtype_name} at n_hidden={nh}, {n_rows} "
        f"rows: max abs err {err:.3e}; bit-equal across launches")


def check_deep_node_bwd(torch, dev, dtype_name, n_rows=2048, nh=10):
    """K4 on a stack deeper than the ReLU masks its row kernel keeps in
    registers (csrc/rows_bwd.cuh kMaxHidden), against its plain version
    (the K3 rule and GRAD_TOL) and across two launches."""
    from aero_gnn_tpu_torch.ops import hopper_node as HN

    dt, h = getattr(torch, dtype_name), HIDDEN
    gen = torch.Generator(device=dev).manual_seed(10)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    w = 1.0 / h ** 0.5
    args = (randn(n_rows, h), randn(n_rows, h, scale=3.0),
            randn(h, h, scale=w), randn(h, h, scale=w), randn(h, scale=0.1),
            randn(nh, h, h, scale=w), randn(nh, h, scale=0.1),
            randn(h, h, scale=w), randn(h, scale=0.1),
            1 + randn(h, scale=0.1), randn(h, scale=0.1), randn(n_rows, h))
    k4 = HN.fused_node_layer_bwd(*args)
    p4 = HN.fused_node_layer_bwd_ref(*args)
    torch.cuda.synchronize()
    act, wrel = check_bwd(torch, f"K4 {dtype_name} n_hidden={nh}", k4, p4,
                          dtype_name, 2)
    if not all(torch.equal(a, b)
               for a, b in zip(k4, HN.fused_node_layer_bwd(*args))):
        raise AssertionError(f"K4 {dtype_name} n_hidden={nh}: outputs differ "
                             "between two launches on the same inputs")
    log(f"[kernels] fused_node_bwd {dtype_name} at n_hidden={nh}, {n_rows} "
        f"rows: max abs err {act:.3e} (weight grads {wrel:.3e} of max|p|); "
        "bit-equal across launches")


def phase_k5_receiver(torch, g):
    """K5 on the receiver stream of the Loader graph ``g`` (FourierMGN's
    main path), pad sink declared, in its two uses: the unfused
    aggregation's (``masked``: the edge mask) and K6's backward
    (``unmasked``: no mask, the data zero on pad rows as the cotangent is
    there, so every row before the sink is read). Both dtypes against the
    plain version and across two launches, timed beside its bound (the
    rows it must read once, ids and mask of the rows before the sink read
    once, the output written once) and torch.sparse.mm of the [N, E] CSR
    matrix holding each row's mask (masked: the rows of mask 1) or a 1
    (unmasked: every row before the sink) at (receiver, row). Returns
    {dtype: {use: record}}."""
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    dev, N = g.device, g.num_nodes_pad
    walked = g.receivers != N - 1
    n_walked = int(walked.sum())
    uses = {"masked": (g.edge_mask != 0) & walked, "unmasked": walked}
    out = {}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        isz = torch.finfo(dt).bits // 8
        gen = torch.Generator(device=dev).manual_seed(707)
        msgs = torch.randn(g.num_edges_pad, HIDDEN, generator=gen,
                           device=dev).to(dt)
        out[dtype_name] = {}
        for use, live in uses.items():
            if use == "masked":
                data, kw = msgs, dict(mask=g.edge_mask.to(dt), pad_sink=True)
                vals = kw["mask"]
            else:
                data = msgs * (g.edge_mask > 0).to(dt)[:, None]
                kw, vals = dict(pad_sink=True), torch.ones_like(msgs[:, 0])
            label = f"K5 receiver stream {use} {dtype_name}"
            k = HS.segment_sum(data, g.receivers, N, **kw)
            p = HS.segment_sum_ref(data, g.receivers, N, **kw)
            torch.cuda.synchronize()
            err = check_close(torch, label, k, p, dtype_name)
            if not torch.equal(k, HS.segment_sum(data, g.receivers, N, **kw)):
                raise AssertionError(f"{label}: outputs differ between two "
                                     "launches on the same inputs")
            rows = torch.nonzero(live).flatten()
            n_live = rows.numel()
            crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
            crow[1:] = torch.cumsum(torch.bincount(g.receivers[rows],
                                                   minlength=N), 0)
            csr = torch.sparse_csr_tensor(crow, rows, vals[rows],
                                          size=(N, g.num_edges_pad))
            nbytes = ((n_live * HIDDEN + N * HIDDEN) * isz
                      + n_walked * (4 + (isz if "mask" in kw else 0)))
            rec = {"E": g.num_edges_pad, "N": N, "walked_rows": n_walked,
                   "live_rows": n_live, "bytes": nbytes,
                   "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                   "max_abs_err": err,
                   "ms": cuda_time_ms(torch, lambda: HS.segment_sum(
                       data, g.receivers, N, **kw)),
                   "plain_ms": cuda_time_ms(torch, lambda: HS.segment_sum_ref(
                       data, g.receivers, N, **kw)),
                   "library_ms": sparse_mm_ms(torch, csr, data, label)}
            log(f"[kernels] segment_sum receiver stream {use} {dtype_name} "
                f"(Loader graph: {n_walked} rows before the sink, {n_live} "
                f"read): {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, "
                f"sparse.mm {fmt_ms(rec['library_ms'])}), bound "
                f"{rec['bound_ms']:.4f} ms by bytes, max abs err {err:.3e}; "
                "bit-equal across launches")
            out[dtype_name][use] = rec
            del data, k, p, csr
        del msgs
    torch.cuda.empty_cache()
    return out


def ptxas_lines(name: str) -> list:
    """nvcc's register / shared memory / spill lines for csrc/<name>.cu,
    each after the line naming its kernel."""
    from aero_gnn_tpu_torch.ops import _build

    out = []
    for line in _build.ptxas_report.get(name, "").splitlines():
        if "entry function" in line:
            out.append("kernel " + line.split(chr(39))[1])
        elif "registers" in line or "spill" in line or "smem" in line:
            out.append(line.replace("ptxas info    :", "").strip())
    return out


def phase_gather(torch, graphs):
    """K6 against its plain version (index_select) on each (label, graph)
    of ``graphs``: random node rows gathered by the graph's receivers, both
    dtypes; torch.equal to the plain version and across two launches; timed
    beside its bound, the plain version and torch.index_select. Returns
    the kernels' JSON entries (the last graph's, the Loader fine level of
    the main path) and the record."""
    from aero_gnn_tpu_torch.ops import hopper_gather as HG

    results, record = [], {"ptxas": ptxas_lines("gather_rows")}
    for line in record["ptxas"]:
        log(f"[kernels] gather_rows ptxas: {line}")
    for label, g in graphs:
        dev = g.device
        E, N, idx = g.num_edges_pad, g.num_nodes_pad, g.receivers
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            gen = torch.Generator(device=dev).manual_seed(606)
            nodes = torch.randn(N, HIDDEN, generator=gen, device=dev).to(dt)
            k = HG.gather_rows(nodes, idx)
            k2 = HG.gather_rows(nodes, idx)
            p = HG.gather_rows_ref(nodes, idx)
            torch.cuda.synchronize()
            tag = f"K6 {label} {dtype_name}"
            if not torch.equal(k, p):
                bad = int((k != p).any(1).sum())
                raise AssertionError(f"{tag}: {bad} rows differ from "
                                     "index_select")
            if not torch.equal(k, k2):
                raise AssertionError(f"{tag}: differs between two launches")
            isz = torch.finfo(dt).bits // 8
            # the node table and the ids read once, the rows written once
            nbytes = (N + E) * HIDDEN * isz + 4 * E
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            rec = {"E": E, "N": N, "bytes": nbytes, "bound_ms": bound,
                   "ms": cuda_time_ms(torch,
                                      lambda: HG.gather_rows(nodes, idx)),
                   "plain_ms": cuda_time_ms(
                       torch, lambda: HG.gather_rows_ref(nodes, idx)),
                   "library_ms": cuda_time_ms(
                       torch, lambda: torch.index_select(nodes, 0, idx))}
            record[f"{label}[{dtype_name}]"] = rec
            log(f"[kernels] gather_rows {label} {dtype_name}: E={E}, N={N}, "
                f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, "
                f"index_select {rec['library_ms']:.4f} ms), bound "
                f"{bound:.4f} ms by bytes ({nbytes / 1e6:.1f} MB); "
                f"torch.equal to index_select and across launches")
            if label == graphs[-1][0]:
                results.append({
                    "name": f"gather_rows[{dtype_name}]", "route": "cuda",
                    "source": "aero_gnn_tpu_torch/csrc/gather_rows.cu",
                    "replaces": "aero_gnn_tpu/ops/pallas_segment.py:494",
                    "launches": None, "max_abs_err": 0.0, "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": bound,
                    "bound_by": "bytes", "library_ms": rec["library_ms"],
                    "flops": 0, "bytes": nbytes})
            del nodes, k, k2, p
        torch.cuda.empty_cache()
    # a row width that is not a multiple of 16 bytes (the 2-byte copy path)
    g = graphs[0][1]
    for dtype_name in ("bfloat16", "float32"):
        nodes = torch.randn(g.num_nodes_pad, 34, device=g.device).to(
            getattr(torch, dtype_name))
        if not torch.equal(HG.gather_rows(nodes, g.receivers),
                           HG.gather_rows_ref(nodes, g.receivers)):
            raise AssertionError(f"K6 h=34 {dtype_name}: differs from "
                                 "index_select")
    log("[kernels] gather_rows h=34 (2-byte words), both dtypes: torch.equal "
        "to index_select")
    return results, record


def phase_serve(torch, graphs):
    """Serve the flagship model; returns {dtype: (K1 launches, K3 launches,
    forwards)} counted over that dtype's run of the main path, and
    {dtype: ms per forward of each request}."""
    import dataclasses

    import numpy as np

    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.inference.metrics import compute_rrmse_percent

    cfg = flagship_config()
    dev = graphs[0][1].device
    params = cfg.init(torch.Generator().manual_seed(0), device=dev)
    stats = {"target_mean": np.zeros(4, np.float32),
             "target_std": np.ones(4, np.float32)}
    launches, preds, serve_ms = {}, {}, {}
    for dtype in ("bfloat16", "float32"):
        eng = AeroInference(dataclasses.replace(cfg, compute_dtype=dtype),
                            params, stats, device=dev)
        zero_counters()
        n_fwd = 0
        for i, (sample, g) in enumerate(graphs):
            times = []
            for rep in range(4):
                before = read_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if rep == 0:
                    pred_phys, tgt_phys, pred, _ = eng.predict_single(g)
                else:
                    eng.predict(g)
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                n_fwd += 1
                delta = {k: v - before[k] for k, v in read_counters().items()}
                want = expect(fused_edge_fwd=LAYERS, fused_node_fwd=LAYERS)
                if delta != want:
                    raise AssertionError(
                        f"request {i} {dtype}: launches {delta} in one "
                        f"forward, expected {want}")
            if pred.shape != (sample.num_nodes, 4) or \
                    not np.isfinite(pred).all():
                raise AssertionError(f"request {i} {dtype}: bad predictions "
                                     f"{pred.shape}")
            preds[(dtype, i)] = pred
            ms = statistics.median(times[1:]) * 1e3
            serve_ms.setdefault(dtype, []).append(ms)
            log(f"[serve] {dtype} request {i}: {sample.num_nodes} nodes, "
                f"{sample.num_edges} edges, first call {times[0] * 1e3:.1f} "
                f"ms, then {ms:.2f} ms per forward (median of 3), "
                f"{sample.num_edges / ms * 1e3:.4g} edges/s, "
                f"RRMSE vs synthetic target (random weights) "
                f"{compute_rrmse_percent(pred_phys, tgt_phys):.1f}%")
        got = read_counters()
        launches[dtype] = (got["fused_edge_fwd"], got["fused_node_fwd"],
                           n_fwd)
        log(f"[serve] {dtype}: K1 launched {launches[dtype][0]}x, K3 "
            f"{launches[dtype][1]}x over {n_fwd} forwards")
    # cross-check request 0 in fp32 against the plain path on the card
    eng = AeroInference(dataclasses.replace(cfg, compute_dtype="float32"),
                        params, stats, device=dev)
    with ops.use_backend("torch"):
        k1 = read_counters()["fused_edge_fwd"]
        ref = eng.predict_single(graphs[0][1])[2]
        if read_counters()["fused_edge_fwd"] != k1:
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
        eng = AeroInference(dataclasses.replace(cfg, compute_dtype=dtype),
                            params, stats, device=dev)
        phase_profile(torch, f"{dtype} forward",
                      lambda: eng.predict(graphs[0][1]))
    return launches, serve_ms


def phase_profile(torch, label: str, fn, top: int = 8) -> dict:
    """Where one warm call of ``fn`` spends device time (torch.profiler);
    returns {"busy_ms", "wall_ms", "kernels": [(ms, count, name), ...]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernel events only: ops, and annotated regions such as
    # Optimizer.step, would count their kernels twice
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if (ev.device_type == DeviceType.CUDA and us > 0
                and not getattr(ev, "is_user_annotation", False)):
            rows.append((us / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        log(f"[profile] {label}: the profiler saw no device time "
            "(not measured)")
        return {"busy_ms": None, "wall_ms": wall_ms, "kernels": []}
    log(f"[profile] {label}: device busy {busy:.2f} ms of "
        f"{wall_ms:.2f} ms wall (idle share {1 - busy / wall_ms:.1%})")
    rows.sort(reverse=True)
    for ms, count, key in rows[:top]:
        log(f"[profile]   {ms:8.3f} ms {ms / busy:6.1%} x{count:<4d} "
            f"{key[:90]}")
    return {"busy_ms": busy, "wall_ms": wall_ms, "kernels": rows[:top]}


FLAGSHIP = dict(
    input_node_dim=6, input_edge_dim=3, output_node_dim=4,
    processor_size=LAYERS, hidden_dim_processor=HIDDEN,
    hidden_dim_node_encoder=HIDDEN, hidden_dim_edge_encoder=HIDDEN,
    hidden_dim_decoder=HIDDEN,
    num_hidden_layers_node_processor=N_HIDDEN,
    num_hidden_layers_edge_processor=N_HIDDEN,
    num_hidden_layers_node_encoder=N_HIDDEN,
    num_hidden_layers_edge_encoder=N_HIDDEN,
    num_hidden_layers_decoder=N_HIDDEN,
    aggregation="add", do_concat_trick=True, remat=False)


def flagship_config(**kw):
    """The flagship MeshGraphNet (bench.py:206-219): 15 layers, width 128,
    2 hidden layers per MLP, concat trick, add aggregation; remat off, as
    bench.py chooses at 65,536 nodes."""
    from aero_gnn_tpu_torch.models.mgn import MGNConfig

    return MGNConfig(**FLAGSHIP, **kw)


def bsms_config():
    """The flagship BSMS (benchmarks/bench_bsms.py:74-89,
    trained_parity_bsms.py:96-110,158-159): the flagship MGN's widths, 3
    scales of 2 layers per stage (2 + 2 down, 7 bottleneck, 2 + 2 up),
    bistride hierarchy, WeightedEdgeConv transfer, remat off; fp32, as the
    JAX package's BSMS computes whatever compute_dtype says."""
    from aero_gnn_tpu_torch.models.bsms import BSMSConfig

    return BSMSConfig(**FLAGSHIP, num_scales=BSMS_SCALES, layers_per_scale=2,
                      stride=2, hierarchy_mode="bistride",
                      transfer="weighted")


def train_counters():
    """chip_smoke's name of each kernel -> its launch counter in the
    port's registry (utils.profiling)."""
    return {"fused_edge_fwd": "launch.K1",
            "fused_edge_bwd": "launch.K2",
            "fused_node_fwd": "launch.K3",
            "fused_node_bwd": "launch.K4",
            "segment_sum": "launch.K5",
            "gather_rows": "launch.K6",
            "segment_sum_weighted": "launch.K7",
            "fused_edge_fwd_save": "launch.K1-save",
            "fused_edge_bwd_saved": "launch.K8",
            "fused_mgn_fwd": "launch.K9-fwd",
            "fused_mgn_bwd": "launch.K9-bwd",
            "segment_sum_weighted2": "launch.K10"}


def zero_counters():
    from aero_gnn_tpu_torch.utils import profiling as PR

    PR.reset_counters()


def read_counters():
    from aero_gnn_tpu_torch.utils import profiling as PR

    got = PR.counters()
    return {k: got.get(name, 0) for k, name in train_counters().items()}


def expect(**counts):
    """Launches expected of every kernel in one forward or step: 0 unless
    given (so K8, K9 and K10 launch 0 times where their switch is off)."""
    want = {k: 0 for k in train_counters()}
    want.update(counts)
    return want


# K1-K5 once per layer: a fused MGN train step with both switches off
FUSED_STEP = {k: LAYERS for k in ("fused_edge_fwd", "fused_edge_bwd",
                                  "fused_node_fwd", "fused_node_bwd",
                                  "segment_sum")}


def train_steps(torch, step, n_steps: int, want: dict, label: str):
    """``n_steps`` calls of ``step()`` (a train step, returning the loss),
    each timed on the host clock to a synchronize and its launches checked
    against ``want``, the counts set to 0 first; raises on a non-finite
    loss. Returns (losses, step seconds, launches over the steps)."""
    zero_counters()
    losses, times = [], []
    for i in range(n_steps):
        before = read_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        delta = {k: v - before[k] for k, v in read_counters().items()}
        if delta != want:
            raise AssertionError(f"{label} step {i}: launches {delta}, "
                                 f"expected {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    return losses, times, read_counters()


def repeat_bits(torch, label, fn):
    """``fn()`` (a tensor, or a dict / tuple of them) twice on the same
    inputs, without deterministic algorithms: raises unless the two are
    the same bits. Comparison launches: not counted on the main path."""
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError(f"{label}: deterministic algorithms are on")
    a = fn()
    b = fn()
    torch.cuda.synchronize()
    if not same_bits(torch, a, b):
        raise AssertionError(f"{label}: two runs on the same inputs differ "
                             "in their bits")
    log(f"[repeat] {label}: two runs bit-equal (deterministic algorithms "
        "off)")
    return True


def check_train_grads(torch, cfg, params, graph, label="train",
                      repeat=False, **apply_kw):
    """One fp32 step's parameter gradients on the kernels against the plain
    path (use_backend("torch")) on the card, TRAIN_GRAD_TOL per parameter;
    with ``repeat`` the kernels' gradients twice, bit-equal
    (``repeat_bits``). Comparison launches: not counted on the main
    path."""
    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.training.loop import masked_mse

    def kernel_grads():
        params.zero_grad(set_to_none=True)
        masked_mse(cfg.apply(params, graph, **apply_kw), graph.y,
                   graph.node_mask).backward()
        return {n: p.grad.clone() for n, p in params.named_parameters()}

    if repeat:
        repeat_bits(torch, f"{label} fp32 step gradients", kernel_grads)
    grads = {}
    for backend in ("cuda", "torch"):
        before = read_counters()
        params.zero_grad(set_to_none=True)
        with ops.use_backend(backend):
            loss = masked_mse(cfg.apply(params, graph, **apply_kw), graph.y,
                              graph.node_mask)
            loss.backward()
        torch.cuda.synchronize()
        grads[backend] = {n: p.grad.clone()
                          for n, p in params.named_parameters()}
        if backend == "torch" and read_counters() != before:
            raise AssertionError("the plain path launched a kernel")
    params.zero_grad(set_to_none=True)
    worst = 0.0
    for n, p in grads["torch"].items():
        err = check_grad(torch, f"{label} fp32 grad {n}", grads["cuda"][n], p,
                         TRAIN_GRAD_TOL)
        worst = max(worst, err / max(float(p.abs().max()), 1e-30))
    log(f"[{label}] fp32 step gradients vs plain path: "
        f"{len(grads['torch'])} parameters within {TRAIN_GRAD_TOL[0]} "
        f"max|p| + {TRAIN_GRAD_TOL[1]} |p|; worst max abs err {worst:.3e} "
        f"of max|p|")
    return worst


def phase_train(torch, sample, graph):
    """Train the flagship model on one mesh through make_step_fns; returns
    {dtype: {kernel: launches}} and the step record."""
    from aero_gnn_tpu_torch.training import loop as TL

    launches, record = {}, {}
    for dtype, n_steps in TRAIN_STEPS.items():
        cfg = flagship_config(compute_dtype=dtype)
        params = cfg.init(torch.Generator().manual_seed(0),
                          device=graph.device)
        fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3),
                               device=graph.device)
        worst = (check_train_grads(torch, cfg, params, graph)
                 if dtype == "float32" else None)
        losses, times, launches[dtype] = train_steps(
            torch, lambda: fns.train_step(params, graph), n_steps,
            expect(**FUSED_STEP), f"train {dtype}")
        if dtype == "bfloat16" and not losses[-1] < losses[0]:
            raise AssertionError(f"train bf16: the loss did not fall over "
                                 f"{n_steps} steps: {losses}")
        ms = statistics.median(times[1:]) * 1e3
        record[dtype] = {"losses": losses, "step_ms": [t * 1e3 for t in times],
                         "median_ms": ms,
                         "edges_per_s": sample.num_edges / ms * 1e3,
                         "grad_worst_rel_err": worst}
        log(f"[train] {dtype}: {n_steps} steps, first {times[0] * 1e3:.1f} "
            f"ms, then {ms:.2f} ms per step (median of {n_steps - 1}), "
            f"{sample.num_edges / ms * 1e3:.4g} edges/s; loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}; launches per step "
            f"{LAYERS} of each of K1-K5, 0 of K8, K9 ({launches[dtype]})")
        if dtype == "bfloat16":
            record["profile_bf16"] = phase_profile(
                torch, "bf16 train step", lambda: fns.train_step(params, graph),
                top=12)
        del params, fns
        torch.cuda.empty_cache()
    return launches, record


# phase cli: the CLI's flagship experiment (default.yaml synthetic_mgn: the
# synthetic airfoil set of 24 cases x 256 points, batch 4, test_split 0.2)
# cut to 2 epochs, checkpointed every epoch, then resumed to 3
CLI_EPOCHS = 2
CLI_FILES = ("model_weights.pkl", "normalization_stats.npz",
             "experiment_params.json", "training_losses.json",
             "training_summary.txt", "metrics.jsonl")
# predictions of a served run directory against the plain path
CLI_TOL = {"float32": SERVE_TOL, "bfloat16": TOL["bfloat16"]}
CLI_INFERS = 3


def cli_config(path: str) -> dict:
    """Write the port's default.yaml with the phase's experiments to
    ``path``: synthetic_mgn uncut (15 x 128, 24 cases x 256 points) with
    2 epochs, a checkpoint every epoch and no early stop, in fp32 and, on a
    model entry named by MGN's other alias ``mgn`` with ``compute_dtype:
    bfloat16`` (experiment keys only override keys of a base section), in
    bf16; each with a resume variant to 3 epochs. Returns {dtype: (train
    experiment, resume experiment)}."""
    import yaml

    from aero_gnn_tpu_torch import cli

    with open(cli.DEFAULT_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["mgn"] = dict(cfg["model"]["meshgraphnet"],
                               compute_dtype="bfloat16")
    base = dict(cfg["experiments"]["synthetic_mgn"], epochs=CLI_EPOCHS,
                checkpoint_every=1, early_stopping=False)
    names = {}
    for dtype, model in (("float32", "meshgraphnet"), ("bfloat16", "mgn")):
        exp = dict(base, model=model)
        cfg["experiments"][f"cli_{dtype}"] = exp
        cfg["experiments"][f"cli_{dtype}_resume"] = dict(
            exp, epochs=CLI_EPOCHS + 1, resume=True)
        names[dtype] = (f"cli_{dtype}", f"cli_{dtype}_resume")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return names


def cli_run(torch, argv, want: dict, label: str):
    """``aero_gnn_tpu_torch.cli.main(argv)`` with the counts set to 0 first
    and held to ``want`` after; its output is captured. Returns (seconds,
    output)."""
    import io

    from aero_gnn_tpu_torch import cli

    zero_counters()
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = read_counters()
    if got != want:
        raise AssertionError(f"cli {label}: launches {got}, expected {want}")
    return secs, out.getvalue()


def cli_launches(steps: int, forwards: int) -> dict:
    """K1 and K3 once per layer per train step or forward, K2, K4, K5 once
    per layer per train step, every other kernel 0."""
    return expect(fused_edge_fwd=LAYERS * (steps + forwards),
                  fused_node_fwd=LAYERS * (steps + forwards),
                  fused_edge_bwd=LAYERS * steps,
                  fused_node_bwd=LAYERS * steps, segment_sum=LAYERS * steps)


def cli_report(out: str) -> str:
    """errors.txt of the inference a CLI run reports in its output."""
    tag = "Inference complete! Results saved to: "
    dirs = [ln[len(tag):] for ln in out.splitlines() if ln.startswith(tag)]
    if len(dirs) != 1:
        raise AssertionError(f"cli: {len(dirs)} inference reports in the "
                             f"output, expected one:\n{out[-2000:]}")
    with open(os.path.join(dirs[0], "errors.txt")) as f:
        return f.read()


def cli_against_plain(torch, run_dir: str, dtype: str, dev):
    """Serve ``run_dir`` as infer does (its experiment, statistics and
    model_weights.pkl) through the kernels and through the plain path
    (use_backend("torch")) on the card; every test case's normalised
    predictions within CLI_TOL. Comparison launches: not counted on the
    main path. Then one warm forward and one train step (a copy of the
    weights, Adam, the first training batch) under the profiler. Returns
    (max abs err, ms per forward, {"forward": profile, "step": profile}).
    """
    import json

    import numpy as np

    from aero_gnn_tpu_torch import cli, ops
    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.data.dataset import create_datasets
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.models.registry import build_model
    from aero_gnn_tpu_torch.training import checkpoint as C
    from aero_gnn_tpu_torch.training import loop as TL

    with open(os.path.join(run_dir, "experiment_params.json")) as f:
        exp = json.load(f)
    train, _, test, _ = create_datasets(cli.load_samples(exp),
                                        dataset_type=exp["dataset"]["name"],
                                        params=exp)
    cfg = build_model(exp["model"], cli.infer_dims(test))
    if cfg.compute_dtype != dtype:
        raise AssertionError(f"cli: {run_dir} computes in "
                             f"{cfg.compute_dtype}, expected {dtype}")
    eng = AeroInference(
        cfg, C.load_params(os.path.join(run_dir, "model_weights.pkl"), cfg,
                           device=dev),
        C.load_norm_stats(os.path.join(run_dir, "normalization_stats.npz")),
        exp, device=dev)
    atol, rtol = CLI_TOL[dtype]
    worst, times = 0.0, []
    for i, (g, aux) in enumerate(Loader(test, 1, device=dev)):
        got = eng.predict_batch(g, aux)[0][2]
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.predict(g)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        before = read_counters()
        with ops.use_backend("torch"):
            ref = eng.predict_batch(g, aux)[0][2]
        if read_counters() != before:
            raise AssertionError("the plain path launched a kernel")
        err = np.abs(got - ref)
        if not np.isfinite(got).all() or \
                (err > atol + rtol * np.abs(ref)).any():
            raise AssertionError(
                f"cli {dtype} test case {i} vs plain path: max abs err "
                f"{err.max():.3e} beyond atol={atol} rtol={rtol}")
        worst = max(worst, float(err.max()))
    profiles = {"forward": phase_profile(torch, f"cli {dtype} forward",
                                         lambda: eng.predict(g), top=4)}
    params = C.load_params(os.path.join(run_dir, "model_weights.pkl"), cfg,
                           device=dev)
    fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3), device=dev)
    batch = next(iter(Loader(train, int(exp["training"]["batch_size"]),
                             device=dev)))[0]
    profiles["step"] = phase_profile(
        torch, f"cli {dtype} train step",
        lambda: fns.train_step(params, batch), top=4)
    return worst, statistics.median(times) * 1e3, profiles


def phase_cli(torch, smi: str):
    """The port's CLI on the card (module docstring, phase 6b): train ->
    infer -> resume of synthetic_mgn per dtype through
    aero_gnn_tpu_torch.cli.main, the artifact contract, the launch gates of
    every run, the served predictions against the plain path. Returns
    ({dtype: {run: launches}}, the record)."""
    import json
    import tempfile

    from aero_gnn_tpu_torch import cli
    from aero_gnn_tpu_torch.config.config import resolve_experiment
    from aero_gnn_tpu_torch.data.dataset import create_datasets
    from aero_gnn_tpu_torch.device import resolve_device

    dev = resolve_device(None)  # the card, as the CLI's default
    launches, record = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        config = os.path.join(tmp, "cli.yaml")
        for dtype, (exp, exp_resume) in cli_config(config).items():
            params = resolve_experiment(config, exp)
            train, val, test, _ = create_datasets(
                cli.load_samples(params),
                dataset_type=params["dataset"]["name"], params=params)
            bs = int(params["training"]["batch_size"])
            steps = -(-len(train) // bs)
            val_fwd = -(-len(val) // max(1, min(bs, len(val))))
            run = os.path.join(tmp, f"run_{dtype}")
            args = ["--config", config, "--output_dir", run]
            # train: CLI_EPOCHS epochs and the post-train inference; infer:
            # the test forwards; resume: one epoch and the inference
            want = launches[dtype] = {
                "train": cli_launches(CLI_EPOCHS * steps,
                                      CLI_EPOCHS * val_fwd + len(test)),
                "infer": cli_launches(0, len(test)),
                "resume": cli_launches(steps, val_fwd + len(test))}
            train_s, out = cli_run(torch, ["train", "--exp", exp] + args,
                                   want["train"], f"{dtype} train")
            missing = [f for f in CLI_FILES
                       if not os.path.exists(os.path.join(run, f))]
            if missing or "Error during inference" in out:
                raise AssertionError(f"cli {dtype} train: missing {missing}"
                                     f"\n{out[-2000:]}")
            ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
            if ckpts != [f"ckpt_{e:08d}.pt"
                         for e in range(1, CLI_EPOCHS + 1)]:
                raise AssertionError(f"cli {dtype}: checkpoints {ckpts}")
            with open(os.path.join(run, "training_losses.json")) as f:
                first = json.load(f)
            with open(os.path.join(run, "metrics.jsonl")) as f:
                epoch_t = [json.loads(line)["time"] for line in f]
            post = cli_report(out)
            # infer from the run directory, CLI_INFERS times
            infer_s = []
            for _ in range(CLI_INFERS):
                secs, out = cli_run(torch,
                                    ["infer", "--training_dir", run],
                                    want["infer"], f"{dtype} infer")
                infer_s.append(secs)
                report = cli_report(out)
                if report.splitlines()[0] != post.splitlines()[0]:
                    raise AssertionError(
                        f"cli {dtype}: infer's TEST_MEAN line differs from "
                        f"the post-train inference's:\n{report}\n{post}")
            worst, fwd_ms, profiles = cli_against_plain(torch, run, dtype,
                                                        dev)
            # resume: one more epoch from the last checkpoint
            resume_s, out = cli_run(
                torch, ["train", "--exp", exp_resume] + args,
                want["resume"], f"{dtype} resume")
            with open(os.path.join(run, "training_losses.json")) as f:
                resumed = json.load(f)
            if f"resumed from checkpoint at epoch {CLI_EPOCHS}" not in out \
                    or resumed["total_epochs"] != CLI_EPOCHS + 1 \
                    or resumed["train_losses"][:CLI_EPOCHS] != \
                    first["train_losses"]:
                raise AssertionError(f"cli {dtype} resume: {resumed}\n"
                                     f"{out[-2000:]}")
            losses = resumed["train_losses"]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"cli {dtype}: losses {losses}")
            epoch_s = [b - a for a, b in zip([0.0] + epoch_t, epoch_t)]
            infer_ms = statistics.median(infer_s) * 1e3
            rec = record[dtype] = {
                "split": [len(train), len(val), len(test)],
                "steps_per_epoch": steps, "epoch_s": epoch_s,
                "train_s": train_s, "infer_ms": [s * 1e3 for s in infer_s],
                "infer_ms_median": infer_ms, "forward_ms": fwd_ms,
                "resume_s": resume_s, "losses": losses,
                "test_mean": post.splitlines()[0],
                "max_abs_err_vs_plain": worst, "profiles": profiles}
            log(f"[cli] {dtype}: split {rec['split']}, {steps} steps of "
                f"{bs} x 256-node graphs an epoch; train {train_s:.2f} s "
                f"({CLI_EPOCHS} epochs: {epoch_s[0]:.3f} s, then "
                f"{epoch_s[-1]:.3f} s with the previous epoch's checkpoint "
                f"write, + post-train inference); "
                f"infer {infer_ms:.1f} ms per request (median of "
                f"{CLI_INFERS}; {fwd_ms:.2f} ms per forward); resume "
                f"{resume_s:.2f} s; losses "
                f"{', '.join(f'{v:.5f}' for v in losses)}; {smi}")
            log(f"[cli] {dtype}: launches per run (K1-K5 {LAYERS} per step, "
                f"K1 and K3 {LAYERS} per forward, others 0): "
                + ", ".join(f"{name} {({k: v for k, v in w.items() if v})}"
                            for name, w in want.items()))
            log(f"[cli] {dtype}: {len(test)} test cases served from the run "
                f"directory vs the plain path: max abs err {worst:.3e} "
                f"(atol={CLI_TOL[dtype][0]}, rtol={CLI_TOL[dtype][1]}); "
                f"{rec['test_mean']}")
    return launches, record


def bsms_requests(torch, samples, dev):
    """Each sample through its own BSMS Loader (3 scales, bistride): the
    (sample, GraphBatch, aux) of the request and the host seconds that the
    hierarchies and batches took."""
    from aero_gnn_tpu_torch.data.batching import Loader

    out = []
    t0 = time.perf_counter()
    for s in samples:
        loader = Loader([s], 1, num_scales=BSMS_SCALES,
                        hierarchy_mode="bistride", align_edges=True,
                        device=dev)
        g, aux = next(iter(loader))
        out.append((s, g, aux))
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    g, aux = out[0][1:]
    def before_tail(st, n_pad):
        return int((st.receivers != n_pad - 1).sum())

    shapes = [(g.num_nodes_pad, g.num_edges_pad,
               before_tail(g, g.num_nodes_pad), g.n_node, g.n_edge)]
    shapes += [(lv.num_coarse_nodes_pad, lv.num_coarse_edges_pad,
                before_tail(lv, lv.num_coarse_nodes_pad), lv.n_node,
                lv.n_edge)
               for lv in aux["hierarchy"]]
    for i, (n, e, live, rn, re) in enumerate(shapes):
        log(f"[bsms] level {i}: {n} padded nodes / {e} edge rows ({live} "
            f"before the sink tail); {rn} real nodes / {re} real edges")
    log(f"[bsms] {len(samples)} requests: hierarchies and batches built in "
        f"{host_s:.2f} s on the host")
    return out, {"levels": shapes, "host_s": host_s}


def weighted_streams(torch, g, hierarchy):
    """K7's streams on the BSMS path of one request, as wec_down / wec_up
    call it: (label, rows of data, ids, rows, weights) for the fine level,
    level 1 (both with the hierarchy's conv weights) and level 2 (the
    coarsest stream, no transfer runs there: random weights)."""
    lv0, lv1 = hierarchy
    gen = torch.Generator(device=g.device).manual_seed(77)
    out = []
    for label, st, w in (("fine", g, lv0.conv_edge), ("level1", lv0,
                                                      lv1.conv_edge),
                         ("level2", lv1, None)):
        n_data = (st.num_nodes_pad if label == "fine"
                  else st.num_coarse_nodes_pad)
        if w is None:
            w = torch.rand(st.receivers.shape[0], generator=gen,
                           device=g.device) * st.edge_mask
        out.append((label, n_data, st.receivers, st.senders, w))
    return out


def fmt_ms(ms) -> str:
    return "none" if ms is None else f"{ms:.4f} ms"


def sparse_mm_ms(torch, mat, dense, label):
    """The time of torch.sparse.mm(mat, dense), or None where this build
    of PyTorch has no such product (logged)."""
    try:
        torch.sparse.mm(mat, dense)
    except (RuntimeError, NotImplementedError) as exc:
        log(f"[kernels] {label}: no sparse.mm "
            f"({str(exc).splitlines()[0][:80]})")
        return None
    return cuda_time_ms(torch, lambda: torch.sparse.mm(mat, dense))


def phase_weighted(torch, g, hierarchy):
    """K7 against its plain version at the BSMS path's shapes (fine, level
    1, level 2), bf16 and fp32, with and without ``rows``; bit-equal across
    two launches; timed at the fine level with ``rows`` (the main path's
    call) beside its bound, the plain version and torch.sparse.mm
    (cuSPARSE SpMM) of the CSR matrix that computes the same function on
    the node table, and without ``rows`` beside sparse.mm of the matrix on
    the pre-gathered rows (both built outside the timing); nvcc's register
    and spill report. Returns the fp32 entry of the kernels' JSON and the
    full record."""
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    dev = g.device
    streams = weighted_streams(torch, g, hierarchy)
    results, record = [], {"ptxas": ptxas_lines("segment_sum_weighted")}
    for line in record["ptxas"]:
        log(f"[kernels] segment_sum_weighted ptxas: {line}")
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(2024)
        for label, n, ids, rows, w in streams:
            data = torch.randn(n, HIDDEN, generator=gen, device=dev).to(dt)
            gathered = data.index_select(0, rows)
            errs = []
            for variant, args, kw in (
                    ("rows", (data, ids, w, n),
                     {"rows": rows, "pad_sink": True}),
                    ("gathered", (gathered, ids, w, n), {"pad_sink": True})):
                k = HS.segment_sum_weighted(*args, **kw)
                k2 = HS.segment_sum_weighted(*args, **kw)
                p = HS.segment_sum_weighted_ref(*args, **kw)
                torch.cuda.synchronize()
                tag = f"K7 {label} {variant} {dtype_name}"
                errs.append(check_close(torch, tag, k, p, dtype_name))
                if not torch.equal(k, k2):
                    raise AssertionError(f"{tag}: differs between two "
                                         "launches on the same inputs")
                empty = torch.bincount(ids, minlength=n) == 0
                if not (k[empty] == 0).all():
                    raise AssertionError(f"{tag}: rows of nodes without a "
                                         "row are not exactly 0")
            # rows before the pad-sink tail, which the kernel skips
            e_live = int((ids != n - 1).sum())
            rec = {"rows": int(ids.shape[0]), "live_rows": e_live,
                   "nodes": n, "max_abs_err": max(errs),
                   "ms": cuda_time_ms(torch, lambda: HS.segment_sum_weighted(
                       data, ids, w, n, rows=rows, pad_sink=True)),
                   "ms_without_rows": cuda_time_ms(
                       torch, lambda: HS.segment_sum_weighted(
                           gathered, ids, w, n, pad_sink=True))}
            if label == "fine":
                isz = torch.finfo(dt).bits // 8
                # inputs read once (the node table, ids, rows, weights),
                # the output written once
                nbytes = 2 * n * HIDDEN * isz + 12 * e_live
                flops = 2 * e_live * HIDDEN
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS["float32"] * 1e3
                rec["plain_ms"] = cuda_time_ms(
                    torch, lambda: HS.segment_sum_weighted_ref(
                        data, ids, w, n, rows=rows, pad_sink=True))
                # the library on the rows before the tail (the tail's rows
                # are skipped: the same function). Like for like with
                # ``ms``: one SpMM of the [n, n] CSR matrix whose row n
                # holds the weights of n's rows at their senders' columns,
                # applied to the node table (the gather inside the call);
                # beside ``ms_without_rows``: the [n, e_live] matrix on the
                # pre-gathered rows.
                crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
                crow[1:] = torch.cumsum(
                    torch.bincount(ids[:e_live], minlength=n), 0)
                vals = w[:e_live].to(dt)
                live_rows = gathered[:e_live]
                csr = torch.sparse_csr_tensor(crow, rows[:e_live].long(),
                                              vals, size=(n, n))
                csr_g = torch.sparse_csr_tensor(
                    crow, torch.arange(e_live, device=dev), vals,
                    size=(n, e_live))
                for key, mat, dense in (("library_ms", csr, data),
                                        ("library_ms_without_rows", csr_g,
                                         live_rows)):
                    rec[key] = sparse_mm_ms(torch, mat, dense,
                                            f"K7 {dtype_name} {key}")
                rec.update(bound_ms=max(t_bytes, t_ops), flops=flops,
                           bytes=nbytes,
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations")
                if dtype_name == "float32":
                    results.append({
                        "name": f"segment_sum_weighted[{dtype_name}]",
                        "route": "cuda",
                        "source": "aero_gnn_tpu_torch/csrc/"
                                  "segment_sum_weighted.cu",
                        "replaces": "aero_gnn_tpu/ops/pallas_segment.py:316",
                        "launches": None, "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"],
                        "ms_without_rows": rec["ms_without_rows"],
                        "library_ms_without_rows":
                            rec["library_ms_without_rows"],
                        "flops": flops, "bytes": nbytes})
            record[f"{label}[{dtype_name}]"] = rec
            extra = "" if label != "fine" else (
                f", plain {rec['plain_ms']:.3f} ms, sparse.mm on the node "
                f"table {fmt_ms(rec['library_ms'])} (on the gathered rows "
                f"{fmt_ms(rec['library_ms_without_rows'])}), bound "
                f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}")
            log(f"[kernels] segment_sum_weighted {label} {dtype_name}: "
                f"{rec['rows']} rows ({e_live} before the sink tail) -> {n} "
                f"nodes, {rec['ms']:.3f} ms with "
                f"rows ({rec['ms_without_rows']:.3f} ms on gathered rows)"
                f"{extra}, max abs err {rec['max_abs_err']:.3e}, bit-equal "
                f"across launches")
            del data, gathered
        torch.cuda.empty_cache()
    return results, record


def phase_bsms_serve(torch, requests):
    """Serve the flagship BSMS through AeroInference(needs_hierarchy=True)
    for each request's Loader batch: 3 warm forwards per request after the
    first, K1 and K3 15 launches, K5 6 (the sorted pools) and K7 4 per
    forward; request 0 against the plain path, and its fp32 forward twice,
    bit-equal. Returns the main path's launch counts and the record."""
    import numpy as np

    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.inference.engine import AeroInference

    cfg = bsms_config()
    dev = requests[0][1].device
    params = cfg.init(torch.Generator().manual_seed(0), device=dev)
    stats = {"target_mean": np.zeros(4, np.float32),
             "target_std": np.ones(4, np.float32)}
    eng = AeroInference(cfg, params, stats, device=dev, needs_hierarchy=True)
    want = {"fused_edge_fwd": LAYERS, "fused_node_fwd": LAYERS,
            "segment_sum": K5_BSMS_POOLS,
            "segment_sum_weighted": K7_PER_FORWARD}
    want.update({k: 0 for k in SWITCHED})
    record, preds, n_fwd = {"ms": []}, [], 0
    zero_counters()
    for i, (sample, g, aux) in enumerate(requests):
        times = []
        for rep in range(4):
            before = read_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rep == 0:
                pred = eng.predict_single(g, aux)[2]
            else:
                eng.predict(g, aux["hierarchy"])
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            n_fwd += 1
            delta = {k: v - before[k] for k, v in read_counters().items()}
            if any(delta[k] != v for k, v in want.items()):
                raise AssertionError(f"bsms request {i}: launches {delta} in "
                                     f"one forward, expected {want}")
        if pred.shape != (sample.num_nodes, 4) or not np.isfinite(pred).all():
            raise AssertionError(f"bsms request {i}: bad predictions "
                                 f"{pred.shape}")
        preds.append(pred)
        ms = statistics.median(times[1:]) * 1e3
        record["ms"].append(ms)
        log(f"[bsms serve] request {i}: {sample.num_nodes} nodes, "
            f"{sample.num_edges} edges, first call {times[0] * 1e3:.1f} ms, "
            f"then {ms:.2f} ms per forward (median of 3), "
            f"{sample.num_edges / ms * 1e3:.4g} edges/s")
    launches = read_counters()
    log(f"[bsms serve] launches over {n_fwd} forwards: {launches}")
    with ops.use_backend("torch"):
        before = read_counters()
        ref = eng.predict_single(requests[0][1], requests[0][2])[2]
        if read_counters() != before:
            raise AssertionError("the plain path launched a kernel")
    atol, rtol = SERVE_TOL
    err = np.abs(preds[0] - ref)
    if (err > atol + rtol * np.abs(ref)).any():
        raise AssertionError(f"bsms serve vs plain path: max abs err "
                             f"{err.max():.3e} beyond atol={atol} rtol={rtol}")
    log(f"[bsms serve] fp32 request 0 vs plain path: max abs err "
        f"{err.max():.3e} (atol={atol}, rtol={rtol})")
    record.update(n_forwards=n_fwd, max_abs_err_vs_plain=float(err.max()))
    g, aux = requests[0][1:]
    record["forward_bit_equal"] = repeat_bits(
        torch, "bsms serve fp32 forward",
        lambda: eng.predict(g, aux["hierarchy"]))
    record["profile"] = phase_profile(
        torch, "bsms fp32 forward",
        lambda: eng.predict(g, aux["hierarchy"]), top=10)
    return launches, record


def phase_bsms_train(torch, sample, g, aux, n_steps: int = 5):
    """Train the flagship BSMS on one request's Loader batch through
    make_step_fns(needs_hierarchy=True): first-step fp32 gradients against
    the plain path and twice on the kernels, bit-equal, then ``n_steps``
    steps, each launching K1-K4 15 times, K5 25 (the layers' 15, the
    pools' 6, the unpools' backward 4) and K7 8 times; one warm step
    profiled."""
    from aero_gnn_tpu_torch.training import loop as TL

    cfg = bsms_config()
    dev = g.device
    hier = aux["hierarchy"]
    params = cfg.init(torch.Generator().manual_seed(0), device=dev)
    fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3), device=dev,
                           needs_hierarchy=True)
    worst = check_train_grads(torch, cfg, params, g, label="bsms train",
                              repeat=True, hierarchy=hier)
    want = expect(**dict(FUSED_STEP, segment_sum=LAYERS + K5_BSMS_POOLS
                         + K5_BSMS_UNPOOL),
                  segment_sum_weighted=2 * K7_PER_FORWARD)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times, launches = train_steps(
        torch, lambda: fns.train_step(params, g, hier), n_steps, want,
        "bsms train")
    peak = torch.cuda.max_memory_allocated(dev)
    ms = statistics.median(times[1:]) * 1e3
    log(f"[bsms train] fp32: {n_steps} steps, first {times[0] * 1e3:.1f} ms, "
        f"then {ms:.2f} ms per step (median of {n_steps - 1}), "
        f"{sample.num_edges / ms * 1e3:.4g} edges/s; losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    record = {"losses": losses, "step_ms": [t * 1e3 for t in times],
              "n_steps": n_steps, "median_ms": ms, "peak_bytes": peak,
              "grad_worst_rel_err": worst,
              "profile": phase_profile(torch, "bsms fp32 train step",
                                       lambda: fns.train_step(params, g,
                                                              hier), top=12)}
    return launches, record


def zoo_requests(torch, samples, dev):
    """Each sample through its own Loader (batch 1, the aligned layout of
    the cuda backend): (sample, GraphBatch, aux) per request."""
    from aero_gnn_tpu_torch.data.batching import Loader

    t0 = time.perf_counter()
    out = [(s, *next(iter(Loader([s], 1, device=dev)))) for s in samples]
    torch.cuda.synchronize()
    g = out[0][1]
    log(f"[zoo] {len(out)} Loader batches in {time.perf_counter() - t0:.2f} "
        f"s: {g.num_nodes_pad} padded nodes, {g.num_edges_pad} edge rows "
        f"({int((g.receivers != g.num_nodes_pad - 1).sum())} before the "
        f"sink tail), {g.num_graphs_pad} graph slots")
    return out


def _zoo_delta(before, kind, what, label):
    """Launches since ``before``; raises unless K6 / K5 launched as
    ZOO_LAUNCHES says and no other kernel did."""
    k6, k5 = ZOO_LAUNCHES[kind][what]
    delta = {k: v - before[k] for k, v in read_counters().items()}
    want = {k: 0 for k in delta}
    want.update(gather_rows=k6, segment_sum=k5)
    if delta != want:
        raise AssertionError(f"zoo {kind} {label}: launches {delta}, "
                             f"expected {want}")
    return delta


def zoo_serve(torch, kind, cfg, params, requests, stats, dtype):
    """Serve ``requests`` (4 forwards each, the first through
    predict_batch) and check every forward's launches; fp32 request 0
    against the plain path. Returns the record."""
    import numpy as np

    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.inference.engine import AeroInference

    dev = requests[0][1].device
    eng = AeroInference(cfg, params, stats, device=dev)
    rec, preds = {"ms": [], "first_ms": []}, []
    zero_counters()
    n_fwd = 0
    for i, (sample, g, aux) in enumerate(requests):
        times = []
        for rep in range(4):
            before = read_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rep == 0:
                pred = eng.predict_batch(g, aux)[0][2]
            else:
                eng.predict(g)
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            n_fwd += 1
            _zoo_delta(before, kind, "forward", f"{dtype} request {i}")
        if pred.shape != (sample.num_nodes, 4) or not np.isfinite(pred).all():
            raise AssertionError(f"zoo {kind} {dtype} request {i}: bad "
                                 f"predictions {pred.shape}")
        preds.append(pred)
        ms = statistics.median(times[1:]) * 1e3
        rec["ms"].append(ms)
        rec["first_ms"].append(times[0] * 1e3)
        log(f"[zoo] {kind} {dtype} request {i}: {sample.num_nodes} nodes, "
            f"first call {times[0] * 1e3:.1f} ms, then {ms:.2f} ms per "
            f"forward (median of 3), {sample.num_edges / ms * 1e3:.4g} "
            f"edges/s")
    rec["launches"] = read_counters()
    rec["n_forwards"] = n_fwd
    if kind in ZOO_REPEAT:
        g0 = requests[0][1]
        rec["forward_bit_equal"] = repeat_bits(
            torch, f"zoo {kind} {dtype} forward", lambda: eng.predict(g0))
    log(f"[zoo] {kind} {dtype} serve: K6 {rec['launches']['gather_rows']}x, "
        f"K5 {rec['launches']['segment_sum']}x over {n_fwd} forwards "
        f"({ZOO_LAUNCHES[kind]['forward']} per forward)")
    if dtype == "float32":
        with ops.use_backend("torch"):
            before = read_counters()
            ref = eng.predict_batch(requests[0][1], requests[0][2])[0][2]
            if read_counters() != before:
                raise AssertionError("the plain path launched a kernel")
        atol, rtol = SERVE_TOL
        err = np.abs(preds[0] - ref)
        if (err > atol + rtol * np.abs(ref)).any():
            raise AssertionError(f"zoo {kind} serve vs plain path: max abs "
                                 f"err {err.max():.3e} beyond atol={atol} "
                                 f"rtol={rtol}")
        rec["max_abs_err_vs_plain"] = float(err.max())
        log(f"[zoo] {kind} fp32 request 0 vs plain path: max abs err "
            f"{err.max():.3e} (atol={atol}, rtol={rtol})")
    return rec, eng


def zoo_train(torch, kind, cfg, params, request, dtype):
    """Train ``ZOO_STEPS[kind]`` steps on one request through
    make_step_fns, checking each step's launches (fp32: first-step
    gradients against the plain path first). Returns the record and the
    step functions."""
    import numpy as np

    from aero_gnn_tpu_torch.training import loop as TL

    sample, g, _ = request
    fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3),
                           device=g.device)
    worst = (check_train_grads(torch, cfg, params, g, label=f"zoo {kind}",
                               repeat=kind in ZOO_REPEAT)
             if dtype == "float32" else None)
    n_steps = ZOO_STEPS[kind]
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats(g.device)
    zero_counters()
    for step in range(n_steps):
        before = read_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fns.train_step(params, g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        _zoo_delta(before, kind, "step", f"{dtype} step {step}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"zoo {kind} {dtype}: non-finite loss {losses}")
    launches = read_counters()
    ms = statistics.median(times[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated(g.device)
    log(f"[zoo] {kind} {dtype} train: {n_steps} steps, first "
        f"{times[0] * 1e3:.1f} ms, then {ms:.2f} ms per step (median of "
        f"{n_steps - 1}), {sample.num_edges / ms * 1e3:.4g} edges/s; losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}; peak device memory "
        f"{peak / 2**30:.2f} GiB; K6 {launches['gather_rows']}x, K5 "
        f"{launches['segment_sum']}x ({ZOO_LAUNCHES[kind]['step']} per "
        f"step)")
    return {"losses": losses, "step_ms": [t * 1e3 for t in times],
            "median_ms": ms, "n_steps": n_steps, "peak_bytes": peak,
            "launches": launches, "grad_worst_rel_err": worst}, fns


def phase_zoo(torch, requests):
    """Serve and train the registry's unfused model zoo (module docstring,
    phase 9). Returns the record; ``record["fouriermgn"][dtype]["serve"]
    ["launches"]`` are the K6 / K5 launches of FourierMGN serving, the
    slice's main path."""
    import numpy as np

    from aero_gnn_tpu_torch.models.registry import build_model

    stats = {"target_mean": np.zeros(4, np.float32),
             "target_std": np.ones(4, np.float32)}
    record = {}
    for kind, mc in ZOO.items():
        dtypes = ("bfloat16", "float32") if kind == "fouriermgn" \
            else ("float32",)
        reqs = requests if kind == "fouriermgn" else requests[:1]
        for dtype in dtypes:
            cfg = build_model(dict(mc, compute_dtype=dtype), ZOO_DIMS)
            params = cfg.init(torch.Generator().manual_seed(0),
                              device=reqs[0][1].device)
            serve, eng = zoo_serve(torch, kind, cfg, params, reqs, stats,
                                   dtype)
            train, fns = zoo_train(torch, kind, cfg, params, requests[0],
                                   dtype)
            rec = record.setdefault(kind, {})[dtype] = {"serve": serve,
                                                        "train": train}
            if kind == "fouriermgn" and dtype == "float32":
                g = requests[0][1]
                rec["profile_forward"] = phase_profile(
                    torch, "zoo fouriermgn fp32 forward",
                    lambda: eng.predict(g), top=10)
                rec["profile_step"] = phase_profile(
                    torch, "zoo fouriermgn fp32 train step",
                    lambda: fns.train_step(params, g), top=12)
            del params, eng, fns
            torch.cuda.empty_cache()
    return record


@contextlib.contextmanager
def knob(name: str, value: str = "1"):
    """The JAX package's switch ``name`` (an environment variable the port
    reads at call time) set to ``value`` inside the block, restored
    after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def mega_args(HM, edge_args, node_args):
    """K9-fwd's arguments (e, sg, d_proj, x, mask, receivers, ep, npar, N)
    from bwd_cases' edge and node arguments."""
    ep = dict(zip(HM.EDGE_KEYS, edge_args[5:12]))
    npar = dict(zip(HM.NODE_KEYS, node_args[2:]))
    return (*edge_args[:3], node_args[0], *edge_args[3:5], ep, npar,
            edge_args[12])


def k8_args(edge_args, saved, ct_e, ct_agg):
    """K8's arguments from bwd_cases' edge arguments, the save variant's
    (zs, d, mu, inv) and the cotangents."""
    e, _, _, mask, recv, w_e, ws, _, w_out, _, scale, _, n = edge_args
    return (e, mask, recv, w_e, ws, w_out, scale, *saved, ct_e, ct_agg, n)


def check_mgn_bwd(torch, name, got, ref, dtype):
    """K9-bwd's outputs (d_e, d_sg, d_dproj, d_x, edge dict, node dict)
    against ``ref`` of the same structure: activation gradients by TOL,
    weight gradients by GRAD_TOL. Returns (max abs err of the activation
    gradients, max abs err of the weight gradients / max|p|)."""
    act, wrel = 0.0, 0.0
    for nm, g, r in zip(("d_e", "d_sg", "d_dproj", "d_x"), got, ref):
        act = max(act, check_close(torch, f"{name} {nm}", g, r, dtype))
    for part, gd, rd in (("edge", got[4], ref[4]), ("node", got[5], ref[5])):
        for k, r in rd.items():
            err = check_grad(torch, f"{name} {part} {k}", gd[k], r,
                             GRAD_TOL[dtype])
            scale = float(r.abs().max()) if r.numel() else 0.0
            wrel = max(wrel, err / scale if scale else 0.0)
    return act, wrel


def same_bits(torch, a, b) -> bool:
    """Whether two outputs (tensors, or tuples / dicts of them) are
    bit-equal."""
    if isinstance(a, dict):
        return all(same_bits(torch, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return all(same_bits(torch, x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def phase_switched_kernels(torch, sample, tight):
    """K1's save variant, K8, K9-fwd and K9-bwd (module docstring, phase
    4c). Returns the kernels' JSON entries (tight graph) and the record."""
    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_mega as HM
    from aero_gnn_tpu_torch.ops import hopper_node as HN

    dev = tight.device
    loader = next(iter(Loader([sample], 1, align_edges=True, device=dev)))[0]
    graphs = {"tight": tight, "loader": loader}
    h, nh = HIDDEN, N_HIDDEN
    results, rec = [], {"tight": {}, "loader": {}}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for name, g in graphs.items():
            gen = torch.Generator(device=dev).manual_seed(4321)

            def randn(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen, device=dev)
                        * scale).to(dt)

            edge_args, edge_bwd, node_args, _, _ = bwd_cases(
                torch, g, dt, randn, h, nh)
            ct_e, ct_agg, ct_x = edge_bwd[12], edge_bwd[13], randn(
                g.num_nodes_pad, h)
            real = g.edge_mask > 0
            ma = mega_args(HM, edge_args, node_args)
            x, n_pad = ma[3], ma[8]
            tag = f"{name} {dtype_name}"
            # the save variant and K8 on what it saved, against K1 and K2
            sv = HF.fused_edge_layer_save(*edge_args)
            k1 = HF.fused_edge_layer(*edge_args)
            a8 = k8_args(edge_args, sv[2:], ct_e, ct_agg)
            k8 = HF.fused_edge_layer_bwd_saved(*a8)
            k2 = HF.fused_edge_layer_bwd(*edge_bwd)
            # K9 against K1 -> K3 and K4 -> K2 on the same inputs
            x9, e9, a9 = HM.fused_mgn_layer(*ma)
            x3 = HN.fused_node_layer(x, k1[1], *node_args[2:])
            b9_args = (*ma[:4], a9, *ma[4:8], ct_e, ct_x, n_pad)
            b9 = HM.fused_mgn_layer_bwd(*b9_args)
            k4 = HN.fused_node_layer_bwd(x, a9, *node_args[2:], ct_x)
            k2m = HF.fused_edge_layer_bwd(*edge_args[:12], ct_e, k4[1], n_pad)
            k42 = (*k2m[:3], k4[0], dict(zip(HM.EDGE_KEYS, k2m[3:])),
                   dict(zip(HM.NODE_KEYS, k4[2:])))
            torch.cuda.synchronize()
            if not same_bits(torch, sv[:2], k1):
                raise AssertionError(f"K1 save variant {tag}: e' / agg "
                                     "differ from K1's")
            # K9-fwd = K1 -> K3 and K8 = K2, bit for bit (the same products
            # and rounding points, csrc/edge_fwd_rows.cuh)
            if not same_bits(torch, (x9, e9[real], a9),
                             (x3, k1[0][real], k1[1])):
                raise AssertionError(f"K9-fwd {tag}: x' / e' / agg differ "
                                     "from K1 -> K3's")
            # K8 runs K2's kernels on K2's grid from the activations K2
            # recomputes (csrc/edge_bwd_rows.cuh): all ten outputs
            for nm, a, b in zip(EDGE_GRADS, k8, k2):
                if not same_bits(torch, a, b):
                    raise AssertionError(f"K8 {tag}: {nm} differs from K2's")
            check_mgn_bwd_bits(torch, f"K9-bwd {tag}", b9, k42, dtype_name)
            if name == "loader" and not (a9[n_pad - 1] == 0).all():
                raise AssertionError(f"K9-fwd {tag}: the sink's agg is not 0")
            # a missed ordering of e' before the block's sums (of d_agg
            # before the edge chunks, of d_sg before d_dproj) would show as
            # bits that change from launch to launch
            for _ in range(5):
                if not same_bits(torch, HM.fused_mgn_layer(*ma),
                                 (x9, e9, a9)):
                    raise AssertionError(f"K9-fwd {tag}: outputs differ "
                                         "between launches on the same "
                                         "inputs")
                if not same_bits(torch, HM.fused_mgn_layer_bwd(*b9_args),
                                 b9):
                    raise AssertionError(f"K9-bwd {tag}: outputs differ "
                                         "between launches on the same "
                                         "inputs")
            r = {"K8_vs_K2": check_bwd(torch, f"K8 vs K2 {tag}", k8, k2,
                                       dtype_name, 3),
                 "K9fwd_vs_K1K3": max(
                     check_close(torch, f"K9-fwd vs K1 -> K3 {tag} x'", x9,
                                 x3, dtype_name),
                     check_close(torch, f"K9-fwd vs K1 {tag} e'", e9, k1[0],
                                 dtype_name, rows=real),
                     check_close(torch, f"K9-fwd vs K1 {tag} agg", a9, k1[1],
                                 dtype_name)),
                 "K9bwd_vs_K4K2": check_mgn_bwd(
                     torch, f"K9-bwd vs K4 -> K2 {tag}", b9, k42,
                     dtype_name),
                 "K9bwd_ln_bits": same_bits(
                     torch, [b9[p][k] for p in (4, 5)
                             for k in ("ln_scale", "ln_bias")],
                     [k42[p][k] for p in (4, 5)
                      for k in ("ln_scale", "ln_bias")])}
            del k1, k8, k2, x3, k4, k2m, k42
            if name == "tight":
                r.update(switched_against_plain(torch, tag, dtype_name, g,
                                                edge_args, node_args, ma, sv,
                                                a9, b9, ct_e, ct_agg, ct_x,
                                                results))
            r["ms"] = {
                "K2": cuda_time_ms(torch,
                                   lambda: HF.fused_edge_layer_bwd(*edge_bwd)),
                "K8": cuda_time_ms(torch,
                                   lambda: HF.fused_edge_layer_bwd_saved(*a8)),
                "K9fwd": cuda_time_ms(torch, lambda: HM.fused_mgn_layer(*ma)),
                "K1K3": cuda_time_ms(torch, lambda: HN.fused_node_layer(
                    x, HF.fused_edge_layer(*edge_args)[1], *node_args[2:])),
                "K9bwd": cuda_time_ms(
                    torch, lambda: HM.fused_mgn_layer_bwd(*b9_args)),
                "K4K2": cuda_time_ms(torch, lambda: HF.fused_edge_layer_bwd(
                    *edge_args[:12], ct_e, HN.fused_node_layer_bwd(
                        x, a9, *node_args[2:], ct_x)[1], n_pad))}
            r["K9_vs_K1K3_K4K2_depths"] = {
                nd: check_mega_depth(torch, g, tag, dtype_name, nd)
                for nd in (0, 10)}
            if name == "tight":
                props = torch.cuda.get_device_properties(dev)
                lim = (props.multi_processor_count,
                       props.shared_memory_per_block_optin)
                plans = {
                    "fused_mgn_fwd": HM.mega_fwd_plan(
                        g.num_edges_pad, n_pad, h, nh, nh, dt, *lim),
                    "fused_mgn_bwd": HM.mega_bwd_plan(
                        g.num_edges_pad, n_pad, h, nh, nh, dt, *lim),
                    "fused_edge_bwd_saved": HF.edge_bwd_saved_plan(
                        g.num_edges_pad, n_pad, h, nh, dt, *lim)}
                r["plans"] = plans
                for src, plan in plans.items():
                    log(f"[switched] {src} {dtype_name} plan: grid "
                        f"{plan['grid']}"
                        + (f" ({plan['waves']} waves)" if "waves" in plan
                           else "")
                        + (f", weight gradients on {plan['edge_grid']} / "
                           f"{plan['node_grid']} splits" if "edge_grid" in
                           plan else "")
                        + f", weights "
                        f"{'resident' if plan['resident'] else 'in the ring'}"
                        f", dynamic shared memory {plan['smem_bytes']} B"
                        + (f", workspace {plan['ws_bytes']} B"
                           if "ws_bytes" in plan else ""))
            rec[name][dtype_name] = r
            log(f"[switched] {tag}: E={g.num_edges_pad}, N={n_pad}; K2 "
                f"{r['ms']['K2']:.3f} ms, K8 "
                f"{r['ms']['K8']:.3f} ms, K9-fwd {r['ms']['K9fwd']:.3f} ms "
                f"(K1 -> K3 in turn {r['ms']['K1K3']:.3f} ms), "
                f"K9-bwd {r['ms']['K9bwd']:.3f} ms (K4 -> K2 in turn "
                f"{r['ms']['K4K2']:.3f} ms); max abs diff K8 vs K2 "
                f"{r['K8_vs_K2'][0]:.3e} (weight grads "
                f"{r['K8_vs_K2'][1]:.3e} of max|p|), K9-fwd vs K1 -> K3 "
                f"{r['K9fwd_vs_K1K3']:.3e}, K9-bwd vs K4 -> K2 "
                f"{r['K9bwd_vs_K4K2'][0]:.3e} ({r['K9bwd_vs_K4K2'][1]:.3e}); "
                f"the save variant's e', agg bit-equal to K1's, K9-fwd's to "
                f"K1 -> K3's and K9-bwd's to K4 -> K2's (also at 0 and 10 "
                f"hidden layers; its LayerNorm sums "
                f"{'bit-equal' if r['K9bwd_ln_bits'] else 'within GRAD_TOL'}"
                f") and across 5 launches, K8's ten outputs to K2's")
            del edge_args, edge_bwd, node_args, ma, sv, a8, x9, e9, a9, b9
            del b9_args
            torch.cuda.empty_cache()
    ratios = {f"{k}[{d}]": rec["loader"][d]["ms"][k] / rec["tight"][d]["ms"][k]
              for k in ("K2", "K8", "K9fwd", "K9bwd")
              for d in ("bfloat16", "float32")}
    rec["ratio"] = ratios
    log("[switched] loader / tight time: " + ", ".join(
        f"{k} {v:.2f}" for k, v in ratios.items()))
    over = {k: v for k, v in ratios.items() if v > 1.3}
    if over:
        raise AssertionError(f"Loader / tight time above 1.3: {over}")
    for src in ("fused_edge_bwd_saved", "fused_mgn_fwd", "fused_mgn_bwd"):
        for line in ptxas_lines(src):
            log(f"[switched] {src} ptxas: {line}")
    return results, rec


def check_mgn_bwd_bits(torch, name, got, ref, dtype_name):
    """K9-bwd's outputs (d_e, d_sg, d_dproj, d_x, edge dict, node dict)
    bit-equal to K4 -> K2's in ``ref``: the activation gradients, the
    weight matrices and the bias gradients; the LayerNorm column sums
    (ln_scale, ln_bias of both chains) within GRAD_TOL."""
    for nm, a, b in zip(("d_e", "d_sg", "d_dproj", "d_x"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {nm} differs from K4 -> K2's")
    for part, gd, rd in (("edge", got[4], ref[4]), ("node", got[5], ref[5])):
        for k, r in rd.items():
            if k in ("ln_scale", "ln_bias"):
                check_grad(torch, f"{name} {part} {k}", gd[k], r,
                           GRAD_TOL[dtype_name])
            elif not torch.equal(gd[k], r):
                raise AssertionError(f"{name}: {part} {k} differs from "
                                     "K4 -> K2's")


def check_mega_depth(torch, g, tag, dtype_name, nh):
    """K9 with ``nh`` hidden layers in both chains on graph ``g``: K9-fwd's
    x', e' (real rows) and agg bit-equal to K1 -> K3's, and K9-bwd's
    outputs to K4 -> K2's (check_mgn_bwd_bits), on the same inputs (K1-K4
    are held to their plain versions at 10 hidden layers in phases 4 and
    4b). Returns True."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_mega as HM
    from aero_gnn_tpu_torch.ops import hopper_node as HN

    dt, dev = getattr(torch, dtype_name), g.device
    gen = torch.Generator(device=dev).manual_seed(4000 + nh)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    edge_args, _, node_args, _, _ = bwd_cases(torch, g, dt, randn, HIDDEN,
                                              nh)
    ma = mega_args(HM, edge_args, node_args)
    real = g.edge_mask > 0
    x9, e9, a9 = HM.fused_mgn_layer(*ma)
    e1, a1 = HF.fused_edge_layer(*edge_args)
    x3 = HN.fused_node_layer(ma[3], a1, *node_args[2:])
    torch.cuda.synchronize()
    if not torch.isfinite(x9).all():
        raise AssertionError(f"K9-fwd {tag} n_hidden={nh}: non-finite x'")
    if not same_bits(torch, (x9, e9[real], a9), (x3, e1[real], a1)):
        raise AssertionError(f"K9-fwd {tag} n_hidden={nh}: x' / e' / agg "
                             "differ from K1 -> K3's")
    ct_e, ct_x = randn(*e9.shape), randn(*x9.shape)
    b9 = HM.fused_mgn_layer_bwd(*ma[:4], a9, *ma[4:8], ct_e, ct_x, ma[8])
    k4 = HN.fused_node_layer_bwd(ma[3], a9, *node_args[2:], ct_x)
    k2 = HF.fused_edge_layer_bwd(*edge_args[:12], ct_e, k4[1], ma[8])
    torch.cuda.synchronize()
    if not torch.isfinite(b9[3]).all():
        raise AssertionError(f"K9-bwd {tag} n_hidden={nh}: non-finite d_x")
    check_mgn_bwd_bits(torch, f"K9-bwd {tag} n_hidden={nh}", b9,
                       (*k2[:3], k4[0], dict(zip(HM.EDGE_KEYS, k2[3:])),
                        dict(zip(HM.NODE_KEYS, k4[2:]))), dtype_name)
    return True


def switched_against_plain(torch, tag, dtype_name, g, edge_args, node_args,
                           ma, sv, a9, b9, ct_e, ct_agg, ct_x, results):
    """On the tight graph: the save variant, K8, K9-fwd and K9-bwd against
    their plain versions (K8 on the plain version's saved activations, so
    every row is defined), K8's and K9-bwd's outputs bit-equal across two
    launches, and each timed beside its bound and its plain version; the
    kernels' JSON entries are appended to ``results``. Returns the max
    abs errors."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_mega as HM

    E, N, h, nh = g.num_edges_pad, g.num_nodes_pad, HIDDEN, N_HIDDEN
    real = g.edge_mask > 0
    sp = HF.fused_edge_layer_save_ref(*edge_args)
    errs = {"save": max(
        check_close(torch, f"K1 save {tag} e'", sv[0], sp[0], dtype_name,
                    rows=real),
        check_close(torch, f"K1 save {tag} agg", sv[1], sp[1], dtype_name),
        check_close(torch, f"K1 save {tag} zs", sv[2][:, real],
                    sp[2][:, real], dtype_name),
        *(check_close(torch, f"K1 save {tag} {nm}", a, b, dtype_name,
                      rows=real)
          for nm, a, b in zip(("d", "mu", "inv"), sv[3:], sp[3:])))}
    p8_args = k8_args(edge_args, sp[2:], ct_e, ct_agg)
    k8 = HF.fused_edge_layer_bwd_saved(*p8_args)
    errs["K8"] = check_bwd(torch, f"K8 {tag}", k8,
                           HF.fused_edge_layer_bwd_saved_ref(*p8_args),
                           dtype_name, 3)
    p9 = HM.fused_mgn_layer_ref(*ma)
    errs["K9fwd"] = max(
        check_close(torch, f"K9-fwd {tag} x'", HM.fused_mgn_layer(*ma)[0],
                    p9[0], dtype_name),
        check_close(torch, f"K9-fwd {tag} e'", HM.fused_mgn_layer(*ma)[1],
                    p9[1], dtype_name, rows=real),
        check_close(torch, f"K9-fwd {tag} agg", a9, p9[2], dtype_name))
    b9_args = (*ma[:4], a9, *ma[4:8], ct_e, ct_x, ma[8])
    errs["K9bwd"] = check_mgn_bwd(torch, f"K9-bwd {tag}", b9,
                                  HM.fused_mgn_layer_bwd_ref(*b9_args),
                                  dtype_name)
    for label, fn, first in (
            ("K8", lambda: HF.fused_edge_layer_bwd_saved(*p8_args), k8),
            ("K9-bwd", lambda: HM.fused_mgn_layer_bwd(*b9_args), b9)):
        if not same_bits(torch, fn(), first):
            raise AssertionError(f"{label} {tag}: outputs differ between two "
                                 "launches on the same inputs")
    log(f"[switched] {tag}: max abs err against the plain versions: save "
        f"variant {errs['save']:.3e}, K8 {errs['K8'][0]:.3e} (weight grads "
        f"{errs['K8'][1]:.3e} of max|p|), K9-fwd {errs['K9fwd']:.3e}, "
        f"K9-bwd {errs['K9bwd'][0]:.3e} ({errs['K9bwd'][1]:.3e}); K8 and "
        f"K9-bwd bit-equal across launches")
    del sp, k8, p9
    isz = torch.finfo(getattr(torch, dtype_name)).bits // 8
    w_edge = sum(t.numel() for t in edge_args[5:12])
    w_node = sum(t.numel() for t in node_args[2:])
    dw_edge = (nh + 2) * h * h + (nh + 3) * h
    dw_node = (nh + 3) * h * h + (nh + 4) * h
    edge_mm, node_mm = 2 * E * h * h * (2 + nh), 2 * N * h * h * (3 + nh)
    kernels = (
        ("fused_edge_fwd_save", "fused_edge_fwd",
         "aero_gnn_tpu/ops/pallas_fused.py:488",
         lambda: HF.fused_edge_layer_save(*edge_args),
         lambda: HF.fused_edge_layer_save_ref(*edge_args), edge_mm,
         ((nh + 5) * E * h + 2 * N * h + E + w_edge) * isz + 12 * E,
         errs["save"]),
        ("fused_edge_bwd_saved", "fused_edge_bwd_saved",
         "aero_gnn_tpu/ops/pallas_fused.py:1165",
         lambda: HF.fused_edge_layer_bwd_saved(*p8_args),
         lambda: HF.fused_edge_layer_bwd_saved_ref(*p8_args), 2 * edge_mm,
         ((nh + 6) * E * h + 2 * N * h + E + w_edge) * isz + 12 * E
         + 4 * dw_edge, errs["K8"][0]),
        ("fused_mgn_fwd", "fused_mgn_fwd",
         "aero_gnn_tpu/ops/pallas_mega.py:221",
         lambda: HM.fused_mgn_layer(*ma),
         lambda: HM.fused_mgn_layer_ref(*ma), edge_mm + node_mm,
         (3 * E * h + 4 * N * h + E + w_edge + w_node) * isz + 4 * E,
         errs["K9fwd"]),
        ("fused_mgn_bwd", "fused_mgn_bwd",
         "aero_gnn_tpu/ops/pallas_mega.py:380",
         lambda: HM.fused_mgn_layer_bwd(*b9_args),
         lambda: HM.fused_mgn_layer_bwd_ref(*b9_args),
         3 * (edge_mm + node_mm),
         (5 * E * h + 6 * N * h + E + w_edge + w_node) * isz + 4 * E
         + 4 * (dw_edge + dw_node), errs["K9bwd"][0]))
    for name, src, replaces, fn, ref, flops, nbytes, err in kernels:
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        ms, plain_ms = cuda_time_ms(torch, fn), cuda_time_ms(torch, ref)
        results.append({
            "name": f"{name}[{dtype_name}]", "route": "cuda",
            "source": f"aero_gnn_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "flops": flops, "bytes": nbytes})
        log(f"[switched] {name} {dtype_name}: {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms), bound {max(t_bytes, t_ops):.4f} ms by "
            f"{results[-1]['bound_by']}, max abs err {err:.3e}")
    return {"vs_plain": errs}


def phase_save_acts(torch, sample, graph):
    """AERO_GNN_SAVE_ACTS=1 (module docstring, phase 10): train the
    flagship MGN on one mesh. Returns {dtype: launches} and the record."""
    from aero_gnn_tpu_torch.training import loop as TL

    want = expect(fused_edge_fwd_save=LAYERS, fused_edge_bwd_saved=LAYERS,
                  fused_node_fwd=LAYERS, fused_node_bwd=LAYERS,
                  segment_sum=LAYERS)
    launches, record = {}, {}
    with knob("AERO_GNN_SAVE_ACTS"):
        for dtype, n_steps in SAVE_ACTS_STEPS.items():
            cfg = flagship_config(compute_dtype=dtype)
            params = cfg.init(torch.Generator().manual_seed(0),
                              device=graph.device)
            fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3),
                                   device=graph.device)
            worst = (check_train_grads(torch, cfg, params, graph,
                                       label="save_acts")
                     if dtype == "float32" else None)
            torch.cuda.reset_peak_memory_stats(graph.device)
            losses, times, launches[dtype] = train_steps(
                torch, lambda: fns.train_step(params, graph), n_steps, want,
                f"save_acts {dtype}")
            ms = statistics.median(times[1:]) * 1e3
            record[dtype] = {
                "losses": losses, "step_ms": [t * 1e3 for t in times],
                "median_ms": ms, "n_steps": n_steps,
                "peak_bytes": torch.cuda.max_memory_allocated(graph.device),
                "grad_worst_rel_err": worst}
            log(f"[save_acts] {dtype}: {n_steps} steps, first "
                f"{times[0] * 1e3:.1f} ms, then {ms:.2f} ms per step "
                f"(median of {n_steps - 1}), "
                f"{sample.num_edges / ms * 1e3:.4g} edges/s; losses "
                f"{', '.join(f'{v:.5f}' for v in losses)}; peak device "
                f"memory {record[dtype]['peak_bytes'] / 2**30:.2f} GiB; "
                f"launches per step: K1 save variant, K8, K3, K4, K5 "
                f"{LAYERS}, K1 and K2 0")
            if dtype == "bfloat16":
                record["profile_bf16"] = phase_profile(
                    torch, "save_acts bf16 train step",
                    lambda: fns.train_step(params, graph), top=10)
            del params, fns
            torch.cuda.empty_cache()
    return launches, record


def phase_mega(torch, graphs):
    """AERO_GNN_MEGA=1 (module docstring, phase 11): serve and train the
    flagship MGN. Returns {"serve": {dtype: launches}, "train": {dtype:
    launches}} and the record."""
    import dataclasses

    import numpy as np

    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.training import loop as TL

    cfg = flagship_config()
    dev = graphs[0][1].device
    stats = {"target_mean": np.zeros(4, np.float32),
             "target_std": np.ones(4, np.float32)}
    launches = {"serve": {}, "train": {}}
    record = {"serve": {}, "train": {}}
    with knob("AERO_GNN_MEGA"):
        params = cfg.init(torch.Generator().manual_seed(0), device=dev)
        preds = {}
        for dtype in ("bfloat16", "float32"):
            eng = AeroInference(dataclasses.replace(cfg, compute_dtype=dtype),
                                params, stats, device=dev)
            zero_counters()
            ms_list, n_fwd = [], 0
            for i, (sample, g) in enumerate(graphs):
                times = []
                for rep in range(3):
                    before = read_counters()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if rep == 0:
                        preds[(dtype, i)] = eng.predict_single(g)[2]
                    else:
                        eng.predict(g)
                        torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    n_fwd += 1
                    delta = {k: v - before[k]
                             for k, v in read_counters().items()}
                    if delta != expect(fused_mgn_fwd=LAYERS):
                        raise AssertionError(
                            f"mega request {i} {dtype}: launches {delta} in "
                            f"one forward, expected K9-fwd {LAYERS} only")
                pred = preds[(dtype, i)]
                if pred.shape != (sample.num_nodes, 4) or \
                        not np.isfinite(pred).all():
                    raise AssertionError(f"mega request {i} {dtype}: bad "
                                         f"predictions {pred.shape}")
                ms_list.append(statistics.median(times[1:]) * 1e3)
                log(f"[mega] serve {dtype} request {i}: first call "
                    f"{times[0] * 1e3:.1f} ms, then {ms_list[-1]:.2f} ms per "
                    f"forward (median of 2)")
            launches["serve"][dtype] = read_counters()
            record["serve"][dtype] = {"ms": ms_list, "n_forwards": n_fwd}
            record["serve"][f"profile_{dtype}"] = phase_profile(
                torch, f"mega {dtype} forward",
                lambda: eng.predict(graphs[0][1]))
            if dtype == "float32":
                with ops.use_backend("torch"):
                    before = read_counters()
                    ref = eng.predict_single(graphs[0][1])[2]
                    if read_counters() != before:
                        raise AssertionError("the plain path launched a "
                                             "kernel")
                atol, rtol = SERVE_TOL
                err = np.abs(preds[(dtype, 0)] - ref)
                if (err > atol + rtol * np.abs(ref)).any():
                    raise AssertionError(
                        f"mega fp32 serve vs plain path: max abs err "
                        f"{err.max():.3e} beyond atol={atol} rtol={rtol}")
                record["serve"]["max_abs_err_vs_plain"] = float(err.max())
                log(f"[mega] fp32 request 0 vs plain path: max abs err "
                    f"{err.max():.3e} (atol={atol}, rtol={rtol})")
            del eng
        del params
        sample, graph = graphs[0]
        want = expect(fused_mgn_fwd=LAYERS, fused_mgn_bwd=LAYERS,
                      segment_sum=LAYERS)
        for dtype, n_steps in MEGA_STEPS.items():
            dcfg = flagship_config(compute_dtype=dtype)
            params = dcfg.init(torch.Generator().manual_seed(0), device=dev)
            fns = TL.make_step_fns(dcfg, TL.make_optimizer(params, 1e-3),
                                   device=dev)
            worst = (check_train_grads(torch, dcfg, params, graph,
                                       label="mega")
                     if dtype == "float32" else None)
            losses, times, launches["train"][dtype] = train_steps(
                torch, lambda: fns.train_step(params, graph), n_steps, want,
                f"mega {dtype}")
            record["train"][dtype] = {
                "losses": losses, "step_ms": [t * 1e3 for t in times],
                "n_steps": n_steps, "grad_worst_rel_err": worst}
            log(f"[mega] train {dtype}: {n_steps} steps, "
                f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; losses "
                f"{', '.join(f'{v:.5f}' for v in losses)}; launches per "
                f"step: K9-fwd, K9-bwd, K5 {LAYERS}, K1-K4 0")
            if dtype == "bfloat16":
                record["train"]["profile_bf16"] = phase_profile(
                    torch, "mega bf16 train step",
                    lambda: fns.train_step(params, graph), top=10)
            del params, fns
            torch.cuda.empty_cache()
    return launches, record


def phase_weighted2(torch, graph):
    """K10 at benchmarks/micro_wec2.py's shapes (module docstring, phase
    12). Returns the kernel's JSON entry and the record."""
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    dev, E, N = graph.device, graph.num_edges_pad, graph.num_nodes_pad
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = torch.bfloat16
    m1, m2 = (torch.randn(E, HIDDEN, generator=gen, device=dev).to(dt)
              for _ in range(2))
    w1, w2 = (torch.randn(E, generator=gen, device=dev) * graph.edge_mask
              for _ in range(2))
    recv = graph.receivers
    args = (m1, w1, m2, w2, recv, N)
    # the probe's main path: its timed run of WEC2_PAIRS dual launches
    zero_counters()
    for _ in range(WEC2_PAIRS):
        HS.segment_sum_weighted2(*args)
    torch.cuda.synchronize()
    launches = read_counters()
    if launches != expect(segment_sum_weighted2=WEC2_PAIRS):
        raise AssertionError(f"weighted2 probe: launches {launches}")
    k, k2 = HS.segment_sum_weighted2(*args), HS.segment_sum_weighted2(*args)
    p = HS.segment_sum_weighted2_ref(*args)
    singles = (HS.segment_sum_weighted(m1, recv, w1, N),
               HS.segment_sum_weighted(m2, recv, w2, N))
    torch.cuda.synchronize()
    err = max(check_close(torch, f"K10 out{i + 1}", a, b, "bfloat16")
              for i, (a, b) in enumerate(zip(k, p)))
    if not same_bits(torch, k, k2):
        raise AssertionError("K10: outputs differ between two launches")
    if not same_bits(torch, k, singles):
        raise AssertionError("K10: outputs differ from two K7 launches")
    # fp32: the pair against two K7 launches on the same streams
    f32 = (m1.float(), w1, m2.float(), w2, recv, N)
    if not same_bits(torch, HS.segment_sum_weighted2(*f32), (
            HS.segment_sum_weighted(f32[0], recv, w1, N),
            HS.segment_sum_weighted(f32[2], recv, w2, N))):
        raise AssertionError("K10 float32: outputs differ from two K7 "
                             "launches")
    live = int((w1 != 0).sum())
    # inputs read once (the messages of the rows with a weight, ids and
    # both weights of every row), the outputs written once
    nbytes = 2 * live * HIDDEN * 2 + 12 * E + 2 * N * HIDDEN * 2
    flops = 2 * 2 * live * HIDDEN
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    rec = {"E": E, "N": N, "live_rows": live, "launches": launches,
           "max_abs_err": err,
           "ms": cuda_time_ms(torch, lambda: HS.segment_sum_weighted2(*args)),
           "two_single_ms": cuda_time_ms(torch, lambda: (
               HS.segment_sum_weighted(m1, recv, w1, N),
               HS.segment_sum_weighted(m2, recv, w2, N))),
           "k7_ms": cuda_time_ms(
               torch, lambda: HS.segment_sum_weighted(m1, recv, w1, N)),
           "plain_ms": cuda_time_ms(
               torch, lambda: HS.segment_sum_weighted2_ref(*args)),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flops": flops, "bytes": nbytes}
    # the library: two cuSPARSE SpMM of CSR matrices of the rows with a
    # weight, built outside the timing
    rows = torch.nonzero(w1 != 0).flatten()
    crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(recv[rows], minlength=N), 0)
    cols = torch.arange(rows.numel(), device=dev)
    csr = [torch.sparse_csr_tensor(crow, cols, w[rows].to(dt),
                                   size=(N, rows.numel())) for w in (w1, w2)]
    dense = [m[rows] for m in (m1, m2)]
    try:
        torch.sparse.mm(csr[0], dense[0])
        rec["library_ms"] = cuda_time_ms(torch, lambda: (
            torch.sparse.mm(csr[0], dense[0]),
            torch.sparse.mm(csr[1], dense[1])))
    except (RuntimeError, NotImplementedError) as exc:
        rec["library_ms"] = None
        log(f"[weighted2] no bf16 sparse.mm "
            f"({str(exc).splitlines()[0][:80]})")
    log(f"[weighted2] E={E} ({live} rows with a weight), N={N}, bf16: dual "
        f"{rec['ms']:.4f} ms; two K7 "
        f"{rec['two_single_ms']:.4f} ms (one K7 {rec['k7_ms']:.4f} ms), "
        f"plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']}, bound "
        f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}; max abs err "
        f"{err:.3e}; bit-equal to two K7 launches (also in fp32), across "
        f"launches; {WEC2_PAIRS} launches in the probe")
    for line in ptxas_lines("segment_sum_weighted2"):
        log(f"[weighted2] ptxas: {line}")
    entry = {"name": "segment_sum_weighted2[bfloat16]", "route": "cuda",
             "source": "aero_gnn_tpu_torch/csrc/segment_sum_weighted2.cu",
             "replaces": "aero_gnn_tpu/ops/pallas_segment.py:282",
             "launches": launches["segment_sum_weighted2"],
             "max_abs_err": err, "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
             "flops": flops, "bytes": nbytes}
    return entry, rec


def remat_forwards(kw: dict) -> int:
    """K1 (and K3) launches in one training step of the flagship MGN on the
    fused path under the remat knobs ``kw`` (remat on): each layer's
    forward once; under per-layer "full" each layer once more; a
    save_fused group replays its layers once; a full group replays all but
    its last layer (the replay stops at the last layer's inner checkpoint,
    whose saved inputs are the last tensors the group saved), then each
    inner checkpoint replays its layer; the offload runs "save_fused:N" as
    full, as the JAX package's does (tests/test_torch_remat.py counts the
    same on the CPU)."""
    g = kw.get("remat_group", 0)
    if g <= 1:
        full = kw.get("remat_policy", "save_fused") != "save_fused"
        return 2 * LAYERS if full else LAYERS
    policy = kw.get("remat_group_policy", "full")
    groups = LAYERS // g
    n_sf = (groups if policy == "save_fused" else
            int(policy.split(":")[1]) if policy.startswith("save_fused:")
            and not kw.get("remat_offload") else 0)
    return n_sf * 2 * g + (groups - n_sf) * (3 * g - 1)


def remat_step_want(kw: dict) -> dict:
    n = remat_forwards(kw)
    return expect(fused_edge_fwd=n, fused_node_fwd=n, fused_edge_bwd=LAYERS,
                  fused_node_bwd=LAYERS, segment_sum=LAYERS)


def large_config(dtype: str, **kw):
    """The flagship MGN with remat on (``kw``: the grouped knobs)."""
    from aero_gnn_tpu_torch.models.mgn import MGNConfig

    return MGNConfig(**dict(FLAGSHIP, remat=True, compute_dtype=dtype, **kw))


def step_grads(torch, cfg, params, graph):
    """(loss, {name: gradient}, launches) of one step's forward and
    backward (no optimizer), the counts set to 0 first."""
    from aero_gnn_tpu_torch.training.loop import masked_mse

    params.zero_grad(set_to_none=True)
    zero_counters()
    loss = masked_mse(cfg.apply(params, graph), graph.y, graph.node_mask)
    loss.backward()
    torch.cuda.synchronize()
    launches = read_counters()
    grads = {n: p.grad.clone() for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, launches


def phase_remat(torch, graph):
    """Grouped and offloaded remat against per-layer remat on the 65,536-node
    tight graph (module docstring, phase 12). Returns the record."""
    record = {}
    for dtype in ("bfloat16", "float32"):
        ref_cfg = large_config(dtype)
        params = ref_cfg.init(torch.Generator().manual_seed(0),
                              device=graph.device)
        loss0, ref, launches = step_grads(torch, ref_cfg, params, graph)
        if launches != remat_step_want({}):
            raise AssertionError(f"remat per-layer {dtype}: launches "
                                 f"{launches}")
        rec = {"per_layer": {"loss": loss0}}
        for label, kw in REMAT_RUNS:
            cfg = large_config(dtype, **kw)
            loss, grads, launches = step_grads(torch, cfg, params, graph)
            want = remat_step_want(kw)
            if launches != want:
                raise AssertionError(f"remat {label} {dtype}: launches "
                                     f"{launches}, expected {want}")
            if loss != loss0:
                raise AssertionError(f"remat {label} {dtype}: loss {loss} "
                                     f"!= per-layer remat's {loss0}")
            differ = [n for n, g in grads.items()
                      if not torch.equal(g, ref[n])]
            for n in differ:
                check_grad(torch, f"remat {label} {dtype} grad {n}",
                           grads[n], ref[n], GRAD_TOL[dtype])
            rec[label] = {"knobs": kw, "launches_k1": want["fused_edge_fwd"],
                          "grads_not_bit_equal": differ}
            log(f"[remat] {dtype} {label} {kw}: K1 and K3 "
                f"{want['fused_edge_fwd']}, K2, K4, K5 {LAYERS} launches a "
                f"step; loss equal; {len(grads) - len(differ)} of "
                f"{len(grads)} parameter gradients bit-equal to per-layer "
                f"remat's" + (f", the others within GRAD_TOL: {differ}"
                              if differ else ""))
        cfg = large_config(dtype, **GROUPED)
        zero_counters()
        with torch.no_grad():
            out = cfg.apply(params, graph)
            plain = ref_cfg.apply(params, graph)
        torch.cuda.synchronize()
        fwd = expect(fused_edge_fwd=2 * LAYERS, fused_node_fwd=2 * LAYERS)
        if read_counters() != fwd or not torch.equal(out, plain):
            raise AssertionError(f"remat {dtype}: a forward without grad "
                                 f"under remat_group=3 launched "
                                 f"{read_counters()} in two forwards or "
                                 "differs from per-layer remat's")
        log(f"[remat] {dtype}: a forward without grad under remat_group=3 "
            f"launches K1 and K3 {LAYERS} times (no checkpoint), "
            "bit-equal to per-layer remat's")
        record[dtype] = rec
        del params
        torch.cuda.empty_cache()
    return record


def check_large_kernels(torch, g):
    """K1 and K3 forward, K2, K4 and K5 backward against their plain
    versions on the 1,048,576-node graph ``g``, both dtypes, on bwd_cases'
    random inputs: an fp32 [E, 128] operand there is 2.15 GB, past 2^31
    bytes, where a 32-bit byte offset would wrap. Returns {dtype: max abs
    errors}."""
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_node as HN
    from aero_gnn_tpu_torch.ops.scatter import degree

    dev, N = g.device, g.num_nodes_pad
    real = g.edge_mask > 0
    empty = degree(g.receivers, N, mask=g.edge_mask) == 0
    out = {}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(4321)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=dev)
                    * scale).to(dt)

        edge_args, edge_bwd, node_args, node_bwd, seg = bwd_cases(
            torch, g, dt, randn, HIDDEN, N_HIDDEN)
        ek, ak = HF.fused_edge_layer(*edge_args)
        ep, ap = HF.fused_edge_layer_ref(*edge_args)
        torch.cuda.synchronize()
        err_e = check_close(torch, f"K1 large {dtype_name} e'", ek, ep,
                            dtype_name, rows=real)
        err_a = check_close(torch, f"K1 large {dtype_name} agg", ak, ap,
                            dtype_name)
        if not (ak[empty] == 0).all():
            raise AssertionError(f"K1 large {dtype_name}: agg rows of nodes "
                                 "without a real edge are not exactly 0")
        del ek, ak, ep, ap
        xk = HN.fused_node_layer(*node_args)
        xp = HN.fused_node_layer_ref(*node_args)
        torch.cuda.synchronize()
        err_x = check_close(torch, f"K3 large {dtype_name} x'", xk, xp,
                            dtype_name)
        del xk, xp, edge_args, node_args
        e2, e4, e5 = check_backward_kernels(
            torch, f"large {dtype_name}", dtype_name, g, edge_bwd, node_bwd,
            seg)
        out[dtype_name] = {"K1": max(err_e, err_a), "K3": err_x,
                           "K2": e2, "K4": e4, "K5": e5}
        log(f"[large] kernels {dtype_name} on {g.num_edges_pad} edge rows / "
            f"{N} nodes against their plain versions: K1 max abs err "
            f"{max(err_e, err_a):.3e}, K3 {err_x:.3e}, K2 {e2[0]:.3e} "
            f"(weight grads {e2[1]:.3e} of max|p|), K4 {e4[0]:.3e} "
            f"({e4[1]:.3e}), K5 {e5:.3e}; K2, K4, K5 bit-equal across "
            "launches")
        del edge_bwd, node_bwd, seg
        torch.cuda.empty_cache()
    return out


def phase_large(torch, dev, smi):
    """The flagship MGN trained at 1,048,576 nodes (module docstring, phase
    13). Returns {label: launches} and the record."""
    import tempfile

    from aero_gnn_tpu_torch.training import loop as TL
    from aero_gnn_tpu_torch.utils import profiling as PR

    t0 = time.perf_counter()
    sample, g = flagship_graph(0, dev, n_nodes=LARGE_NODES)
    host_s = time.perf_counter() - t0
    live = int(g.edge_mask.sum())
    # one group boundary (x, e) in bf16
    boundary = (g.num_nodes_pad + g.num_edges_pad) * HIDDEN * 2
    log(f"[large] {smi}: a mesh of {sample.num_nodes} nodes, "
        f"{sample.num_edges} edges: {g.num_nodes_pad} padded nodes, "
        f"{g.num_edges_pad} edge rows ({live} live), built in {host_s:.1f} "
        f"s on the host; a bf16 group boundary (x, e) is "
        f"{boundary / 1e9:.3f} GB")
    record = {"nodes_pad": g.num_nodes_pad, "edge_rows": g.num_edges_pad,
              "live_edges": live, "host_s": host_s,
              "host_graph": host_graph_build(torch, sample, dev, smi),
              "boundary_bytes": boundary,
              "kernels": check_large_kernels(torch, g)}
    launches, first_loss = {}, None
    for label, dtype, kw, n_timed in LARGE_RUNS:
        cfg = large_config(dtype, **kw)
        params = cfg.init(torch.Generator().manual_seed(0), device=dev)
        fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3),
                               device=dev)
        want = remat_step_want(kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counters()
        losses, ms = [], []
        for i in range(1 + n_timed):
            before = read_counters()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            loss = fns.train_step(params, g)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            losses.append(float(loss))
            delta = {k: v - before[k] for k, v in read_counters().items()}
            if delta != want:
                raise AssertionError(f"large {label} step {i}: launches "
                                     f"{delta}, expected {want}")
        launches[label] = read_counters()
        mem = PR.device_memory_stats(dev)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"large {label}: non-finite loss {losses}")
        if dtype == "bfloat16":
            # the same weights and forward kernels: the same first loss
            first_loss = losses[0] if first_loss is None else first_loss
            if losses[0] != first_loss:
                raise AssertionError(f"large {label}: first loss "
                                     f"{losses[0]} != {first_loss}")
        # the timed steps' median (the first is warm-up)
        rate = sample.num_edges / (statistics.median(ms[1:]) * 1e-3)
        rec = {"dtype": dtype, "knobs": kw, "losses": losses, "step_ms": ms,
               "median_ms": statistics.median(ms[1:]), "edges_per_s": rate,
               "peak_bytes": mem["peak_bytes_in_use"],
               "peak_bytes_reserved": mem["peak_bytes_reserved"],
               "bytes_limit": mem["bytes_limit"],
               "launches_per_step": want}
        log(f"[large] {label} {dtype} {kw or 'per-layer save_fused'}: "
            f"{1 + n_timed} steps, {', '.join(f'{v:.1f}' for v in ms)} ms "
            f"(CUDA events; the first warm), {rate:.4g} edges/s; peak "
            f"device memory {rec['peak_bytes'] / 1e9:.2f} GB allocated, "
            f"{rec['peak_bytes_reserved'] / 1e9:.2f} GB reserved of "
            f"{rec['bytes_limit'] / 1e9:.1f}; losses "
            f"{', '.join(f'{v:.5f}' for v in losses)}; launches a step: K1 "
            f"and K3 {want['fused_edge_fwd']}, K2, K4, K5 {LAYERS}")
        # where the peak falls: one more forward, then its backward
        torch.cuda.reset_peak_memory_stats(dev)
        loss = TL.masked_mse(cfg.apply(params, g), g.y, g.node_mask)
        torch.cuda.synchronize()
        rec["peak_bytes_forward"] = torch.cuda.max_memory_allocated(dev)
        loss.backward()
        del loss
        params.zero_grad(set_to_none=True)
        log(f"[large] {label}: the peak of a forward alone "
            f"{rec['peak_bytes_forward'] / 1e9:.2f} GB")
        if label == "a":
            rec["profile"] = phase_profile(
                torch, "large (a) bf16 train step",
                lambda: fns.train_step(params, g), top=12)
            with tempfile.TemporaryDirectory() as logdir:
                with PR.trace(logdir):
                    fns.train_step(params, g)
                    torch.cuda.synchronize()
                files = [os.path.join(logdir, f) for f in os.listdir(logdir)]
                sizes = [os.path.getsize(f) for f in files]
            if len(files) != 1 or not sizes[0]:
                raise AssertionError(f"large: utils.profiling.trace wrote "
                                     f"{files} ({sizes} bytes)")
            rec["trace_bytes"] = sizes[0]
            log(f"[large] utils.profiling.trace of one {label} step: "
                f"{os.path.basename(files[0])}, {sizes[0]} bytes")
        record[label] = rec
        del params, fns
        torch.cuda.empty_cache()
    # the offload keeps the boundaries on the host: at group 4's backward
    # four more of them than without it are off the card. (c) runs full
    # remat in every group, so (b) is its control; (a) is logged beside it
    saved = record["b"]["peak_bytes"] - record["c"]["peak_bytes"]
    if saved < 0.5 * 4 * boundary:
        raise AssertionError(f"large: the offload saved {saved / 1e9:.2f} GB"
                             f" of peak memory against (b), less than half "
                             f"of 4 boundaries ({2 * boundary / 1e9:.2f} GB)")
    record["offload_saved_bytes"] = saved
    log(f"[large] the offload lowered the peak by {saved / 1e9:.2f} GB "
        f"against (b) ({saved / boundary:.2f} bf16 boundaries; against (a) "
        f"{(record['a']['peak_bytes'] - record['c']['peak_bytes']) / 1e9:.2f}"
        f" GB)")
    return launches, record


def phase_pool(torch, g, hierarchy):
    """K5 in its pool use (ops.segment_pool_sum, AERO_GNN_SORTED_POOL=1) at
    the BSMS fine level's shapes, fp32: node rows x 128, edge rows x 128
    and the edge weight sums x 1, each read through the level's pool
    permutation cut before its pad tail (``*_pool_live``), as the model
    calls it. The rows are random and, as every pool operand of the model
    is (masked or zero-weighted), zero on the fine level's pad rows, so
    the cut call must equal the plain version over the whole stream;
    bit-equal across two launches; timed beside its bound, index_add_
    over the unsorted ids (the default pool's call, which it must not be
    slower than) and torch.sparse.mm of the cut stream's CSR matrix."""
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    lv = hierarchy[0]
    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(31)
    out = {}
    for label, ids, perm, srt, live, n, width, mask in (
            ("node", lv.fine_to_coarse, lv.node_pool_perm,
             lv.node_pool_sorted, lv.node_pool_live,
             lv.num_coarse_nodes_pad, HIDDEN, g.node_mask),
            ("edge", lv.edge_to_coarse, lv.edge_pool_perm,
             lv.edge_pool_sorted, lv.edge_pool_live,
             lv.num_coarse_edges_pad, HIDDEN, g.edge_mask),
            ("wsum", lv.edge_to_coarse, lv.edge_pool_perm,
             lv.edge_pool_sorted, lv.edge_pool_live,
             lv.num_coarse_edges_pad, 1, g.edge_mask)):
        rows = ids.shape[0]
        data = torch.randn(rows, width, generator=gen,
                           device=dev) * mask[:, None]
        cperm, csrt = perm[:live], srt[:live]
        # the longest run of rows one coarse id keys in the cut stream
        longest = int(torch.bincount(csrt, minlength=n).max())
        k = HS.segment_sum(data, csrt, n, rows=cperm)
        k2 = HS.segment_sum(data, csrt, n, rows=cperm)
        p = HS.segment_sum_ref(data, srt, n, rows=perm)
        torch.cuda.synchronize()
        err = check_close(torch, f"K5 pool {label}", k, p, "float32")
        if not torch.equal(k, k2):
            raise AssertionError(f"K5 pool {label}: differs between two "
                                 "launches on the same inputs")
        acc = torch.zeros(n, width, device=dev)
        crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(csrt, minlength=n), 0)
        csr = torch.sparse_csr_tensor(crow, cperm.long(),
                                      torch.ones(live, device=dev),
                                      size=(n, rows))
        # the live rows read once through the permutation, their ids and
        # permutation read, the output written
        nbytes = 4 * (live * width + 2 * live + n * width)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = live * width / PEAK_FLOPS["float32"] * 1e3
        rec = {"rows": rows, "live_rows": live, "segments": n,
               "width": width, "longest_run": longest, "max_abs_err": err,
               "ms": cuda_time_ms(torch, lambda: HS.segment_sum(
                   data, csrt, n, rows=cperm)),
               "plain_ms": cuda_time_ms(torch, lambda: HS.segment_sum_ref(
                   data, csrt, n, rows=cperm)),
               "index_add_ms": cuda_time_ms(
                   torch, lambda: acc.index_add_(0, ids, data)),
               "library_ms": sparse_mm_ms(torch, csr, data,
                                          f"K5 pool {label}"),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes}
        out[label] = rec
        log(f"[bsms_switches] K5 pool {label}: {live} of {rows} rows (the "
            f"pad tail cut) x {width} -> {n} segments (the longest "
            f"{longest} rows), {rec['ms']:.4f} ms (plain "
            f"{rec['plain_ms']:.4f} ms, index_add_ over all rows "
            f"{rec['index_add_ms']:.4f} ms, sparse.mm "
            f"{fmt_ms(rec['library_ms'])}), bound {rec['bound_ms']:.4f} ms "
            f"by {rec['bound_by']}, max abs err {err:.3e} against the plain "
            "version over the whole stream; bit-equal across launches")
        if rec["ms"] > rec["index_add_ms"]:
            raise AssertionError(
                f"K5 pool {label}: {rec['ms']:.4f} ms, slower than the "
                f"default pool's index_add_ ({rec['index_add_ms']:.4f} ms)")
        del data, acc, csr
    torch.cuda.empty_cache()
    return out


def phase_bsms_switches(torch, requests):
    """The flagship BSMS under each transfer switch (module docstring,
    phase 8b). Returns {switch: launches} and the record."""
    import numpy as np

    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.training import loop as TL

    cfg = bsms_config()
    served = requests[:2]
    g0, aux0 = served[0][1:]
    hier0, dev = aux0["hierarchy"], g0.device
    stats = {"target_mean": np.zeros(4, np.float32),
             "target_std": np.ones(4, np.float32)}
    record = {"pool": phase_pool(torch, g0, hier0)}

    def engine():
        params = cfg.init(torch.Generator().manual_seed(0), device=dev)
        return params, AeroInference(cfg, params, stats, device=dev,
                                     needs_hierarchy=True)

    # every switch computes the same function: the plain path with every
    # switch off is each one's reference
    before = read_counters()
    with ops.use_backend("torch"):
        plain = engine()[1]
        refs = [plain.predict_single(g, aux)[2] for _, g, aux in served]
    del plain
    if read_counters() != before:
        raise AssertionError("the plain path launched a kernel")
    launches = {}
    for label, name, value in BSMS_SWITCHES:
        # K5 a forward: the sorted pools (nodes, edges, weight sums at each
        # level; the cuda backend's pools under either setting of
        # AERO_GNN_SORTED_POOL), and the WEC's aggregations in place of
        # K7's; a step adds the WEC adjoints and the unpools' backward
        wec_k5 = label == "wec_unfused"
        k5_fwd = K5_BSMS_POOLS + (K7_PER_FORWARD if wec_k5 else 0)
        k7_fwd = 0 if wec_k5 else K7_PER_FORWARD
        k5_adj = K7_PER_FORWARD if wec_k5 else 0
        fwd_want = expect(fused_edge_fwd=LAYERS, fused_node_fwd=LAYERS,
                          segment_sum=k5_fwd, segment_sum_weighted=k7_fwd)
        step_want = expect(**dict(FUSED_STEP, segment_sum=(
            LAYERS + k5_fwd + k5_adj + K5_BSMS_UNPOOL)),
                           segment_sum_weighted=2 * k7_fwd)
        with knob(name, value):
            params, eng = engine()
            zero_counters()
            errs, ms = [], []
            for i, (sample, g, aux) in enumerate(served):
                before = read_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred = eng.predict_single(g, aux)[2]
                ms.append((time.perf_counter() - t0) * 1e3)
                delta = {k: v - before[k] for k, v in read_counters().items()}
                if delta != fwd_want:
                    raise AssertionError(f"bsms {label} request {i}: "
                                         f"launches {delta}, expected "
                                         f"{fwd_want}")
                err = np.abs(pred - refs[i])
                atol, rtol = SERVE_TOL
                if (err > atol + rtol * np.abs(refs[i])).any():
                    raise AssertionError(
                        f"bsms {label} request {i} vs plain path: max abs "
                        f"err {err.max():.3e} beyond atol={atol} "
                        f"rtol={rtol}")
                errs.append(float(err.max()))
            serve = read_counters()
            repeat_bits(torch, f"bsms {label} fp32 forward",
                        lambda: eng.predict(g0, hier0))
            worst = check_train_grads(torch, cfg, params, g0,
                                      label=f"bsms {label}", repeat=True,
                                      hierarchy=hier0)
            fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3),
                                   device=dev, needs_hierarchy=True)
            losses, times, train = train_steps(
                torch, lambda: fns.train_step(params, g0, hier0), 2,
                step_want, f"bsms {label}")
        launches[label] = {"serve": serve, "train": train}
        record[label] = {"serve_ms": ms, "max_abs_err_vs_plain": errs,
                         "grad_worst_rel_err": worst, "losses": losses,
                         "step_ms": [t * 1e3 for t in times],
                         "launches_per_forward": fwd_want,
                         "launches_per_step": step_want}
        log(f"[bsms_switches] {name}={value}: 2 requests "
            f"({', '.join(f'{v:.1f}' for v in ms)} ms) within "
            f"{max(errs):.3e} of the plain path, launches a forward K1, K3 "
            f"{LAYERS}, K5 {k5_fwd}, K7 {k7_fwd}; 2 steps "
            f"({', '.join(f'{t * 1e3:.1f}' for t in times)} ms), losses "
            f"{', '.join(f'{v:.5f}' for v in losses)}, launches a step K1-K4 "
            f"{LAYERS}, K5 {step_want['segment_sum']}, K7 {2 * k7_fwd}")
        del params, eng, fns
        torch.cuda.empty_cache()
    return launches, record


# phase parallel: the port's parallel/ over ranks that share the one card
# (gloo), and one rank on its own (nccl). Each rank rebuilds its shard from
# the seed on the host; the kernels were built by phase build, so a rank
# only loads them.
PAR_PARTS = 2
# (dtype, timed steps) after one warm step each, following the fp32 step
# whose gradients are checked
PAR_TIMED = (("bfloat16", 3), ("float32", 1))
# AERO_GNN_ASYNC_COLLECTIVES in turns: PAR_TIMED's steps under each
PAR_TURNS = ("0", "1", "1", "0")
PAR_SETTING = {"0": "sync", "1": "async"}
PAR_STEPS = 1 + len(PAR_TIMED) + len(PAR_TURNS) * sum(n for _, n in PAR_TIMED)
PAR_TIMEOUT_S = 600
# K5 launches a layer of the halo-split layer: the boundary chain's masked
# sum a forward; a step adds the backward of the interior sender gather, of
# the exchange's send gather, of the halo-table gather and of the boundary
# receiver gather
PAR_SPLIT_K5 = {"forward": 1, "step": 5}
# K5 launches of the BSMS halo scheme's transfers beyond its layers': 7 a
# down transfer in the forward (the WEC conv's two sums, the node
# reduction's two, the edge reduction's three), 3 an up transfer (the WEC
# spread's three); a step adds 3 a down transfer (the conv's three gathers'
# backward) and 4 an up transfer (the fetch's two gathers', the spread's
# two)
PAR_BSMS_K5 = {"forward": 10 * (BSMS_SCALES - 1),
               "step": 17 * (BSMS_SCALES - 1)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(*jobs):
    """Each job ``(target, world, spec, env)`` runs ``target(rank, world,
    spec)`` in ``world`` processes of the port's launcher
    (parallel.distributed.spawn), the jobs at the same time; returns each
    job's results in rank order and raises if any rank fails."""
    from aero_gnn_tpu_torch.parallel import distributed as PD

    return PD.spawn(jobs, timeout_s=PAR_TIMEOUT_S)


@functools.lru_cache(maxsize=2)
def par_sample(seed: int):
    from aero_gnn_tpu_torch.data import dataset as D
    from aero_gnn_tpu_torch.data.synthetic import make_random_mesh_sample

    s = make_random_mesh_sample(n_nodes=N_NODES, avg_degree=6, seed=seed)
    D.compute_features([s], ["mach", "alpha"])
    return s


def par_split(s, parts: int):
    from aero_gnn_tpu_torch.parallel import halo as HL

    return HL.partition_graph_halo_split(
        senders=s.senders, receivers=s.receivers, x=s.x,
        edge_attr=s.edge_attr, pos=s.pos, y=s.y, num_parts=parts,
        align_interior=True)


def par_init(spec, rank, world):
    """TF32 off as in main, then this rank's device after the bring-up of
    spec["address"] (a torchrun-style environment when None)."""
    import torch

    from aero_gnn_tpu_torch.parallel import distributed as PD

    torch.backends.cuda.matmul.allow_tf32 = False  # as in main
    torch.backends.cudnn.allow_tf32 = False
    if spec.get("address"):
        PD.initialize(spec["address"], world, rank,
                      initialization_timeout=PAR_TIMEOUT_S)
    else:
        PD.initialize(initialization_timeout=PAR_TIMEOUT_S)
    dev = PD.rank_device()
    torch.cuda.set_device(dev)
    return dev


def par_state(params, opt):
    """Parameters and Adam state as numpy (the checkpoint's contents)."""
    state = opt.state_dict()["state"]
    return ([p.detach().cpu().numpy() for p in params.parameters()],
            [(float(v["step"]), v["exp_avg"].cpu().numpy(),
              v["exp_avg_sq"].cpu().numpy())
             for _, v in sorted(state.items())])


def par_grads(params):
    return {n: p.grad.detach().cpu().numpy()
            for n, p in params.named_parameters()}


def par_gather_rows(torch, pred, group, s, parts):
    """The shards' [Nl, Dy] predictions in the mesh's node order."""
    from aero_gnn_tpu_torch.parallel import collectives as C
    from aero_gnn_tpu_torch.parallel.spatial import unshard_rows

    full = C.gather_raw(pred.contiguous(), group).reshape(parts, -1,
                                                          pred.shape[-1])
    return unshard_rows(full.cpu().numpy(), s.pos, s.num_nodes, parts)


def par_halo_split(torch, mesh, dev, rank, tag, save_dir=None):
    """The main path: the flagship MGN on the split halo streams over the
    mesh's graph axis. The fp32 forward (counted), one fp32 step (its
    gradients), then a warm step per dtype and PAR_TIMED's steps under
    each setting of PAR_TURNS in turn (counted, timed with CUDA events);
    outside the count the async / sync comparison (par_async_check) and a
    profiled bf16 step; the replicas' parameters; with ``save_dir`` the
    state saved by save_dcp; last, the interior's kernels against their
    plain versions (par_check_interior)."""
    from aero_gnn_tpu_torch.parallel import collectives as C
    from aero_gnn_tpu_torch.parallel import halo as HL
    from aero_gnn_tpu_torch.training import checkpoint as CK
    from aero_gnn_tpu_torch.training import loop as TL

    parts = mesh.shape[1]
    group = mesh.group("graph")
    s = par_sample(mesh.coords()[0])
    hg = par_split(s, parts)
    g = mesh.coords()[1]
    sh = hg.shard(g, dev)
    cfgs = {dt: flagship_config(compute_dtype=dt)
            for dt in ("float32", "bfloat16")}
    params = cfgs["float32"].init(torch.Generator().manual_seed(0),
                                  device=dev)
    rec = {"device": str(dev), "backend": group.backend,
           "async_default": C.async_collectives(),
           "halo_rows": hg.halo_size,
           "nodes_per_part": hg.nodes_per_part,
           "interior_rows": hg.edge_attr_int.shape[1],
           "interior_real": int(hg.edge_mask_int[g].sum()),
           "boundary_rows": hg.edge_attr_bnd.shape[1],
           "boundary_real": int(hg.edge_mask_bnd[g].sum()),
           "fused": HL.fused_interior(cfgs["float32"].layer_cfg,
                                      torch.zeros(sh.x.shape[0], HIDDEN,
                                                  device=dev), sh)}
    zero_counters()
    pred = HL.make_halo_split_forward(cfgs["float32"], mesh)(params, sh)
    torch.cuda.synchronize()
    rec["forward_launches"] = read_counters()
    rec["forward"] = par_gather_rows(torch, pred, group, s, parts)
    opt = TL.make_optimizer(params, 1e-3)
    steps = {dt: HL.make_halo_split_train_step(c, opt, mesh)
             for dt, c in cfgs.items()}
    zero_counters()
    rec["loss"] = float(steps["float32"](params, sh))
    rec["grads"] = par_grads(params)
    for dt, _ in PAR_TIMED:
        steps[dt](params, sh)
    times = {st: {dt: [] for dt, _ in PAR_TIMED} for st in PAR_SETTING}
    for setting in PAR_TURNS:
        with knob("AERO_GNN_ASYNC_COLLECTIVES", setting):
            for dt, n in PAR_TIMED:
                for _ in range(n):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    steps[dt](params, sh)
                    b.record()
                    b.synchronize()
                    times[setting][dt].append(a.elapsed_time(b))
    rec["step_ms"] = {PAR_SETTING[st]: {dt: statistics.median(t)
                                        for dt, t in per.items()}
                      for st, per in times.items()}
    rec["step_ms_all"] = {PAR_SETTING[st]: per for st, per in times.items()}
    torch.cuda.synchronize()
    rec["step_launches"] = read_counters()
    # after the counted run: the settings compared, then more bf16 steps,
    # two profiled (one under each setting, for the overlap)
    rec["async_check"] = par_async_check(torch, cfgs["float32"], params, sh,
                                         mesh)
    rec["profile_bf16"] = phase_profile(
        torch, f"parallel ({tag}) rank {rank} bf16 step",
        lambda: steps["bfloat16"](params, sh), top=6)
    rec["overlap_bf16"] = {}
    for setting, label in PAR_SETTING.items():
        with knob("AERO_GNN_ASYNC_COLLECTIVES", setting):
            rec["overlap_bf16"][label] = exchange_overlap(
                torch, lambda: steps["bfloat16"](params, sh),
                parts * hg.halo_size * HIDDEN * 2)  # the bf16 halo blocks
    flat = torch.cat([p.detach().reshape(-1) for p in params.parameters()])
    every = C.gather_raw(flat[None], group)
    rec["replicas_bit_equal"] = all(torch.equal(every[0], row)
                                    for row in every)
    if tag == "a":
        rec["exchange_ms"] = {}
        for dt in ("bfloat16", "float32"):
            buf = torch.randn(parts, hg.halo_size, HIDDEN, device=dev).to(
                getattr(torch, dt))
            rec["exchange_ms"][dt] = cuda_time_ms(
                torch, lambda: C.all_to_all_raw(buf, group))
    if save_dir is not None:
        manager = CK.make_dcp_manager(save_dir, max_to_keep=2)
        CK.save_dcp(manager, params, opt, 1, {"loss": [rec["loss"]]})
        manager.wait_until_finished()
        rec["saved"] = par_state(params, opt)
    par_check_interior(torch, mesh, sh, rec)
    return rec


def par_fwd_grads(torch, forward, params, sh, g0, group):
    """(the fp32 forward without grad, {name: gradient}) of one forward and
    backward of the shard loss on ``g0``'s targets, the gradients summed
    over the group (no optimizer step)."""
    from aero_gnn_tpu_torch.parallel import collectives as C
    from aero_gnn_tpu_torch.parallel import spatial as SP

    with torch.no_grad():
        pred = forward(params, sh)
    params.zero_grad(set_to_none=True)
    SP.shard_loss(forward(params, sh), g0.y, g0.node_mask,
                  group).backward()
    C.sum_gradients(params, group)
    grads = {n: p.grad.clone() for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return pred, grads


def par_async_check(torch, cfg, params, sh, mesh) -> dict:
    """The fp32 forward, and one fp32 forward and backward with the
    gradients summed over the group (no optimizer step), twice under
    AERO_GNN_ASYNC_COLLECTIVES=0 and once under =1, without deterministic
    algorithms: the three forwards and the three sets of gradients must be
    the same bits (else it raises)."""
    from aero_gnn_tpu_torch.parallel import halo as HL

    group = mesh.group("graph")
    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("parallel: deterministic algorithms are on")

    def forward(p, shard):
        return HL.halo_split_mgn_forward(p, cfg, shard, group)

    runs = []
    for setting in ("0", "0", "1"):
        with knob("AERO_GNN_ASYNC_COLLECTIVES", setting):
            runs.append(par_fwd_grads(torch, forward, params, sh, sh, group))
    torch.cuda.synchronize()
    (p0, g0), (p1, g1), (p2, g2) = runs
    sync = torch.equal(p0, p1) and same_bits(torch, g0, g1)
    differ = [n for n in g0 if not torch.equal(g0[n], g2[n])]
    if not (sync and torch.equal(p0, p2) and not differ):
        raise AssertionError(
            "parallel: without deterministic algorithms, two synchronous "
            f"fp32 forwards and steps bit-equal: {sync}; the asynchronous "
            f"forward bit-equal to them: {torch.equal(p0, p2)}; its "
            f"gradients not bit-equal: {differ}")
    return {"forward_bit_equal": True, "sync_repeat_bit_equal": True,
            "grads_not_bit_equal": differ}


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_us(intervals, merged) -> float:
    return sum(max(0.0, min(b, d) - max(a, c))
               for a, b in intervals for c, d in merged)


# the device kernels of K1 and K2 (csrc/edge_fwd_rows.cuh,
# csrc/edge_bwd_rows.cuh)
K12_KERNELS = ("edge_fwd_rows_kernel", "edge_rows_kernel", "edge_dw_kernel")


def exchange_overlap(torch, fn, nbytes: int) -> dict:
    """One warm call of ``fn`` traced by torch.profiler (its Chrome trace):
    the exchange's device copies (gloo's copies of CUDA tensors through
    pinned host memory: memcpy events of the exchange buffer's ``nbytes``)
    and NCCL's send / receive kernels, and how many ms of them overlap K1 /
    K2 kernels (K12_KERNELS) and any kernel on the timeline; the count of
    every memcpy by size. None where the trace holds no device event."""
    import json as _json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = _json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    kernels, k12, copies, nccl, sizes = [], [], [], [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat == "kernel":
            kernels.append(span)
            if any(k in name for k in K12_KERNELS):
                k12.append(span)
            low = name.lower()
            if "nccl" in low and ("sendrecv" in low or "alltoall" in low):
                nccl.append(span)
        elif cat == "gpu_memcpy":
            size = (ev.get("args") or {}).get("bytes")
            sizes[size] = sizes.get(size, 0) + 1
            if size == nbytes:
                copies.append(span)
    if not kernels:
        return None
    every, k12m = _merged(kernels), _merged(k12)
    exch = copies + nccl
    return {"copies": len(copies), "nccl_kernels": len(nccl),
            "exchange_ms": sum(b - a for a, b in exch) / 1e3,
            "overlap_k12_ms": _overlap_us(exch, k12m) / 1e3,
            "overlap_any_kernel_ms": _overlap_us(exch, every) / 1e3,
            "k12_ms": sum(b - a for a, b in k12m) / 1e3,
            "memcpy_sizes": sizes}


def par_check_interior(torch, mesh, sh, rec):
    """On the graph axis' rank 0, outside the counted runs: every kernel of
    the split layer's interior against its plain version at the shard's
    shapes, on bwd_cases' random inputs in bf16 and fp32 (as
    check_large_kernels does at 1M nodes): K1 and K3 forward (TOL), K2 and
    K4 through check_bwd, K5 on the interior's sender sort as the sender
    gather's backward runs it; K2, K4, K5 bit-equal across launches. Then
    K1's and K2's bf16 times there. The other ranks wait."""
    import types

    import torch.distributed as dist

    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.ops import hopper_node as HN
    from aero_gnn_tpu_torch.ops.scatter import degree

    dist.barrier()
    if mesh.coords()[1] == 0:
        N = sh.x.shape[0]
        stream = types.SimpleNamespace(
            num_edges_pad=sh.receivers_int.shape[0], num_nodes_pad=N,
            edge_mask=sh.edge_mask_int, receivers=sh.receivers_int,
            senders_sorted=sh.senders_int_sorted,
            sender_perm=sh.sender_perm_int)
        real = sh.edge_mask_int > 0
        empty = degree(sh.receivers_int, N, mask=sh.edge_mask_int) == 0
        rec["interior_check"] = {}
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            gen = torch.Generator(device=sh.x.device).manual_seed(1234)

            def randn(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen,
                                    device=sh.x.device) * scale).to(dt)

            edge_args, edge_bwd, node_args, node_bwd, seg = bwd_cases(
                torch, stream, dt, randn, HIDDEN, N_HIDDEN)
            tag = f"shard {dt_name}"
            ek, ak = HF.fused_edge_layer(*edge_args)
            ep, ap = HF.fused_edge_layer_ref(*edge_args)
            err1 = max(check_close(torch, f"K1 {tag} e'", ek, ep, dt_name,
                                   rows=real),
                       check_close(torch, f"K1 {tag} agg", ak, ap, dt_name))
            if not (ak[empty] == 0).all():
                raise AssertionError(f"K1 {tag}: agg rows of nodes without "
                                     "a real edge are not exactly 0")
            err3 = check_close(torch, f"K3 {tag} x'",
                               HN.fused_node_layer(*node_args),
                               HN.fused_node_layer_ref(*node_args), dt_name)
            e2, e4, e5 = check_backward_kernels(torch, tag, dt_name, stream,
                                                edge_bwd, node_bwd, seg)
            rec["interior_check"][dt_name] = {"K1": err1, "K3": err3,
                                              "K2": e2, "K4": e4, "K5": e5}
            if dt_name == "bfloat16":
                rec["interior_ms"] = {
                    "k1": cuda_time_ms(
                        torch, lambda: HF.fused_edge_layer(*edge_args)),
                    "k2": cuda_time_ms(
                        torch, lambda: HF.fused_edge_layer_bwd(*edge_bwd))}
            del edge_args, edge_bwd, node_args, node_bwd, seg, ek, ak, ep, ap
    dist.barrier()


def par_check_spread_pools(torch, bsh):
    """K5 in the BSMS halo scheme's WEC spread (ops.segment_pool_sum over
    the level's interior sender sort) against the plain segment sum over
    the unsorted senders, on each spread level's stream with random fp32
    rows as wide as the model's (TOL); [(level, rows, max abs err)]."""
    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.ops import hopper_segment as HS

    out = []
    gen = torch.Generator(device=bsh.levels[0].conv_edge_int.device)
    gen.manual_seed(99)
    for k, lvl in enumerate(bsh.levels[:-1]):
        g = lvl.graph
        n = g.node_mask.shape[0]
        z = torch.randn(n, HIDDEN, generator=gen, device=g.node_mask.device)
        data = lvl.conv_edge_int[:, None] * z[g.receivers_int]
        got = ops.segment_pool_sum(data, g.senders_int, n,
                                   perm=g.sender_perm_int,
                                   seg_sorted=g.senders_int_sorted,
                                   pad_sink=g.aligned)
        ref = HS.segment_sum_ref(data, g.senders_int, n)
        torch.cuda.synchronize()
        out.append((k, int(data.shape[0]),
                    check_close(torch, f"K5 spread pool level {k}", got, ref,
                                "float32")))
    return out


def par_pair_rank(rank, world, spec):
    """Runs (a), (c) and (e) on one gloo world of two ranks that share the
    card, and (f)'s save."""
    import torch

    from aero_gnn_tpu_torch.parallel import bsms_spatial as BS
    from aero_gnn_tpu_torch.parallel import collectives as C
    from aero_gnn_tpu_torch.parallel import data_parallel as DP
    from aero_gnn_tpu_torch.parallel import mesh as PM
    from aero_gnn_tpu_torch.training import loop as TL

    dev = par_init(spec, rank, world)
    graph = PM.make_mesh(data=1, graph=world)
    out = {"a": par_halo_split(torch, graph, dev, rank, "a",
                               save_dir=spec["ckpt_dir"])}
    # (c) data parallel: rank r trains on mesh seed r
    data = PM.make_mesh(data=world, graph=1)
    _, g = flagship_graph(rank, dev)
    cfg = flagship_config()
    params = cfg.init(torch.Generator().manual_seed(0), device=dev)
    step = DP.make_dp_train_step(cfg, TL.make_optimizer(params, 1e-3), data)
    zero_counters()
    loss = float(step(params, g))
    torch.cuda.synchronize()
    out["c"] = {"loss": loss, "grads": par_grads(params),
                "step_launches": read_counters()}
    del g, params, step
    # (e) the BSMS halo scheme, every level sharded, weighted transfer
    s = par_sample(0)
    bg = BS.partition_bsms_halo(
        senders=s.senders.astype("int64"),
        receivers=s.receivers.astype("int64"), x=s.x,
        edge_attr=s.edge_attr, pos=s.pos, y=s.y, num_parts=world,
        num_scales=BSMS_SCALES, mode="bistride", stride=2,
        align_interior=True)
    sh = bg.shard(rank, dev)
    cfg = bsms_config()
    params = cfg.init(torch.Generator().manual_seed(0), device=dev)
    zero_counters()
    pred = BS.make_bsms_halo_forward(cfg, graph)(params, sh)
    torch.cuda.synchronize()
    full = C.gather_raw(pred.contiguous(), graph.group("graph"))
    e = {"forward_launches": read_counters(),
         "levels": [(lv.graph.nodes_per_part, lv.graph.halo_size)
                    for lv in bg.levels],
         "forward": BS.unshard_fine(bg, full.reshape(world, -1, 4).cpu()
                                    .numpy())}
    step = BS.make_bsms_halo_train_step(cfg, TL.make_optimizer(params, 1e-3),
                                        graph)
    zero_counters()
    e["loss"] = float(step(params, sh))
    torch.cuda.synchronize()
    e["step_launches"] = read_counters()
    e["grads"] = par_grads(params)
    # outside the counted runs: a forward and one step's gradients twice
    group = graph.group("graph")
    e["repeat_bit_equal"] = repeat_bits(
        torch, f"parallel (e) rank {rank} fp32 forward and step gradients",
        lambda: par_fwd_grads(
            torch, lambda p, shard: BS.bsms_halo_forward(p, cfg, shard, group),
            params, sh, sh.fine, group))
    if rank == 0:  # outside the counted runs
        e["pool_check"] = par_check_spread_pools(torch, sh)
    out["e"] = e
    if rank:
        for rec in out.values():
            for k in ("forward", "grads", "saved"):
                rec.pop(k, None)
    return out


def par_nccl_rank(rank, world, spec):
    """(b): one rank wired by a torchrun-style environment, so initialize()
    chooses NCCL; the halo-split path with P = 1."""
    import torch

    from aero_gnn_tpu_torch.parallel import mesh as PM

    dev = par_init(spec, rank, world)
    return par_halo_split(torch, PM.make_mesh(data=1, graph=1), dev, rank,
                          "b")


def par_hybrid_rank(rank, world, spec):
    """(d): a 2 x 2 grid, mesh seed d split in two along the graph axis;
    one fp32 step of make_hybrid_halo_split_train_step."""
    import torch

    from aero_gnn_tpu_torch.parallel import collectives as C
    from aero_gnn_tpu_torch.parallel import hybrid as HY
    from aero_gnn_tpu_torch.parallel import mesh as PM
    from aero_gnn_tpu_torch.training import loop as TL

    dev = par_init(spec, rank, world)
    mesh = PM.make_mesh(data=2, graph=world // 2)
    d, g = mesh.coords()
    sh = par_split(par_sample(d), world // 2).shard(g, dev)
    cfg = flagship_config()
    params = cfg.init(torch.Generator().manual_seed(0), device=dev)
    step = HY.make_hybrid_halo_split_train_step(
        cfg, TL.make_optimizer(params, 1e-3), mesh)
    zero_counters()
    loss = float(step(params, sh))
    torch.cuda.synchronize()
    rec = {"loss": loss, "step_launches": read_counters(),
           "async_default": C.async_collectives()}
    if rank == 0:
        rec["grads"] = par_grads(params)
    return rec


def par_restore_rank(rank, world, spec):
    """(f): fresh ranks, parameters from another seed, restore_dcp."""
    import torch

    from aero_gnn_tpu_torch.training import checkpoint as CK
    from aero_gnn_tpu_torch.training import loop as TL

    dev = par_init(spec, rank, world)
    params = flagship_config().init(torch.Generator().manual_seed(1),
                                    device=dev)
    opt = TL.make_optimizer(params, 1e-3)
    got = CK.restore_dcp(CK.make_dcp_manager(spec["ckpt_dir"]), params, opt)
    return {"restored": got, "state": par_state(params, opt)}


def par_want(forward: int = 0, step: int = 0, k5_extra: int = 0,
             split: bool = True) -> dict:
    """Per-rank launches of ``forward`` forwards and ``step`` steps on the
    fused interior: K1 and K3 a layer each forward; K1-K4 a layer each
    step; K5 a layer each step on one device, PAR_SPLIT_K5 a layer on the
    halo-split layer (``split``), and ``k5_extra`` more; every other
    kernel 0."""
    n = forward + step
    k5 = (LAYERS * (PAR_SPLIT_K5["forward"] * forward
                    + PAR_SPLIT_K5["step"] * step) if split
          else LAYERS * step)
    return expect(fused_edge_fwd=LAYERS * n, fused_node_fwd=LAYERS * n,
                  fused_edge_bwd=LAYERS * step, fused_node_bwd=LAYERS * step,
                  segment_sum=k5 + k5_extra)


def par_check_launches(label, got, want):
    if got != want:
        raise AssertionError(f"parallel {label}: launches {got}, expected "
                             f"{want}")


def par_check_rows(label, got, ref):
    import numpy as np

    atol, rtol = SERVE_TOL
    err = np.abs(got - ref)
    if not np.isfinite(got).all() or (err > atol + rtol * np.abs(ref)).any():
        raise AssertionError(f"parallel {label}: max abs err {err.max():.3e}"
                             f" beyond atol={atol} rtol={rtol}")
    return float(err.max())


def par_check_grads(torch, label, got, ref):
    """Every parameter's gradient within TRAIN_GRAD_TOL of ``ref`` (torch
    tensors on the card); returns the worst error over max|p|."""
    worst = 0.0
    for n, r in ref.items():
        err = check_grad(torch, f"parallel {label} grad {n}",
                         torch.from_numpy(got[n]).to(r.device), r,
                         TRAIN_GRAD_TOL)
        worst = max(worst, err / max(float(r.abs().max()), 1e-30))
    return worst


def par_single_steps(torch, sample, graph):
    """The single-device step of the same model on the same mesh, timed
    like the ranks' (a warm step, then CUDA events; the median): through
    make_step_fns (``single``), and the halo-split step at P = 1 in this
    process, without a process group (``split``: the split layer's own
    cost, no collective); for one more bf16 step of each, its kernel
    launches and matrix products (``host_ops``)."""
    from aero_gnn_tpu_torch.parallel import halo as HL
    from aero_gnn_tpu_torch.parallel import mesh as PM
    from aero_gnn_tpu_torch.training import loop as TL

    sh = par_split(sample, 1).shard(0, graph.device)
    out = {"single": {}, "split": {}}
    for dt, n in PAR_TIMED:
        cfg = flagship_config(compute_dtype=dt)
        params = cfg.init(torch.Generator().manual_seed(0),
                          device=graph.device)
        fns = TL.make_step_fns(cfg, TL.make_optimizer(params, 1e-3),
                               device=graph.device)
        split = HL.make_halo_split_train_step(
            cfg, TL.make_optimizer(params, 1e-3), PM.make_mesh())
        for label, step in (("single", lambda: fns.train_step(params, graph)),
                            ("split", lambda: split(params, sh))):
            step()
            times = []
            for _ in range(n):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                step()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            out[label][dt] = statistics.median(times)
            if dt == "bfloat16":
                out.setdefault("host_ops", {})[label] = host_op_counts(
                    torch, step)
    return out


def host_op_counts(torch, fn, keys=("cudaLaunchKernel", "aten::mm")):
    """Calls of the named host-side events (kernel launches through the
    CUDA runtime, matrix products) in one warm call of ``fn``, from
    torch.profiler's key_averages."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for ev in prof.key_averages():
        counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return {k: counts.get(k, 0) for k in keys}


def phase_parallel(torch, smi, graphs):
    """Phase parallel (a)-(f); returns ({run: per-rank launches}, record).
    ``graphs``: the (sample, tight aligned graph) of meshes 0 and 1."""
    import tempfile

    import numpy as np

    from aero_gnn_tpu_torch.ops import hopper_fused as HF

    t_phase = time.perf_counter()
    (s0, g0), (s1, g1) = graphs[:2]
    cfg = flagship_config()
    dev = g0.device
    params = cfg.init(torch.Generator().manual_seed(0), device=dev)
    with torch.no_grad():
        ref_fwd = cfg.apply(params, g0)[:s0.num_nodes].cpu().numpy()
    loss0, grads0, _ = step_grads(torch, cfg, params, g0)
    loss1, grads1, _ = step_grads(torch, cfg, params, g1)
    mean_grads = {n: (grads0[n] + grads1[n]) / 2 for n in grads0}
    steps_ms = par_single_steps(torch, s0, g0)
    single_ms = steps_ms["single"]
    ops_ = steps_ms["host_ops"]
    log(f"[parallel] one bf16 step's host calls (torch.profiler): single "
        f"device {ops_['single']['cudaLaunchKernel']} cudaLaunchKernel, "
        f"{ops_['single']['aten::mm']} aten::mm; the split step at P = 1 "
        f"without a process group {ops_['split']['cudaLaunchKernel']}, "
        f"{ops_['split']['aten::mm']}")
    # K1 / K2 on the tight single-device graph: the yardstick of the
    # shard's interior times
    gen = torch.Generator(device=dev).manual_seed(1234)
    edge_args, edge_bwd = bwd_cases(
        torch, g0, torch.bfloat16,
        lambda *sh, scale=1.0: (torch.randn(*sh, generator=gen, device=dev)
                                * scale).to(torch.bfloat16),
        HIDDEN, N_HIDDEN)[:2]
    tight_ms = {"k1": cuda_time_ms(torch,
                                   lambda: HF.fused_edge_layer(*edge_args)),
                "k2": cuda_time_ms(torch,
                                   lambda: HF.fused_edge_layer_bwd(*edge_bwd))}
    del edge_args, edge_bwd
    requests, _ = bsms_requests(torch, [s0], dev)
    _, gb, aux = requests[0]
    bcfg = bsms_config()
    bparams = bcfg.init(torch.Generator().manual_seed(0), device=dev)
    with torch.no_grad():
        bsms_fwd = bcfg.apply(bparams, gb, hierarchy=aux["hierarchy"])[
            :s0.num_nodes].cpu().numpy()
    bparams.zero_grad(set_to_none=True)
    from aero_gnn_tpu_torch.training.loop import masked_mse

    bloss = masked_mse(bcfg.apply(bparams, gb, hierarchy=aux["hierarchy"]),
                       gb.y, gb.node_mask)
    bloss.backward()
    bsms_grads = {n: p.grad.clone() for n, p in bparams.named_parameters()}
    del requests, gb, aux, bparams
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t_phase
    log(f"[parallel] single-device references (forward, fp32 gradients of "
        f"meshes 0 and 1, BSMS, step times) in {ref_s:.1f} s")

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_dcp_")
    t0 = time.perf_counter()
    (pair,) = spawn_ranks((par_pair_rank, PAR_PARTS, {
        "address": f"tcp://localhost:{free_port()}", "ckpt_dir": ckpt}, {}))
    pair_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ((nccl,),) = spawn_ranks((par_nccl_rank, 1, {}, {
        "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
        "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
        "MASTER_PORT": str(free_port())}))
    nccl_s = time.perf_counter() - t0
    # (d) and (f) time nothing: they run side by side
    t0 = time.perf_counter()
    hybrid, restored = spawn_ranks(
        (par_hybrid_rank, 4, {"address": f"tcp://localhost:{free_port()}"},
         {}),
        (par_restore_rank, PAR_PARTS,
         {"address": f"tcp://localhost:{free_port()}", "ckpt_dir": ckpt}, {}))
    hybrid_s = time.perf_counter() - t0
    import shutil

    shutil.rmtree(ckpt, ignore_errors=True)

    launches, record = {}, {"card": smi, "single_step_ms": single_ms,
                            "split_p1_no_group_step_ms": steps_ms["split"],
                            "host_ops_bf16_step": ops_,
                            "tight_ms": tight_ms, "seconds": {
                                "references": ref_s, "pair": pair_s,
                                "nccl": nccl_s,
                                "hybrid_and_restore": hybrid_s}}
    # (a) and (b): the halo-split main path
    for label, recs in (("a", [r["a"] for r in pair]), ("b", [nccl])):
        r0 = recs[0]
        want_fwd, want_step = par_want(forward=1), par_want(step=PAR_STEPS)
        for i, r in enumerate(recs):
            if (not r["device"].startswith("cuda") or not r["fused"]
                    or not r["async_default"]):
                raise AssertionError(f"parallel ({label}) rank {i}: device "
                                     f"{r['device']}, fused {r['fused']}, "
                                     f"async {r['async_default']}")
            par_check_launches(f"({label}) rank {i} forward",
                               r["forward_launches"], want_fwd)
            par_check_launches(f"({label}) rank {i} steps",
                               r["step_launches"], want_step)
            if not r["replicas_bit_equal"]:
                raise AssertionError(f"parallel ({label}): the replicas' "
                                     "parameters differ")
        fwd_err = par_check_rows(f"({label}) forward", r0["forward"],
                                 ref_fwd)
        worst = par_check_grads(torch, f"({label})", r0["grads"], grads0)
        if abs(r0["loss"] - loss0) > 1e-4 * abs(loss0):
            raise AssertionError(f"parallel ({label}): loss {r0['loss']} vs "
                                 f"single device {loss0}")
        launches[label] = {"forward": [r["forward_launches"] for r in recs],
                           "steps": [r["step_launches"] for r in recs]}
        isz = {"bfloat16": 2, "float32": 4}
        parts = len(recs)
        bytes_layer = {dt: r0["halo_rows"] * HIDDEN * isz[dt] * parts
                       for dt in isz}
        record[label] = {k: v for k, v in r0.items()
                         if k not in ("forward", "grads", "saved")}
        record[label].update(forward_err=fwd_err, grad_worst_rel_err=worst,
                             bytes_per_layer=bytes_layer)
        log(f"[parallel] ({label}) halo-split P={parts} {r0['backend']} on "
            f"{r0['device']}: {r0['nodes_per_part']} rows per shard, halo "
            f"H={r0['halo_rows']} rows per peer, interior "
            f"{r0['interior_real']} real edges in {r0['interior_rows']} rows,"
            f" boundary {r0['boundary_real']} in {r0['boundary_rows']}; "
            f"exchanged per layer {bytes_layer['bfloat16']} B bf16, "
            f"{bytes_layer['float32']} B fp32 (H x {HIDDEN} x size x P), "
            f"the card's tensors handed to {r0['backend']} directly")
        log(f"[parallel] ({label}) fp32 forward vs single device: max abs "
            f"err {fwd_err:.3e} (SERVE_TOL); fp32 step gradients within "
            f"TRAIN_GRAD_TOL, worst {worst:.3e} of max|p|; loss "
            f"{r0['loss']:.6f} vs {loss0:.6f}; launches per rank: forward "
            f"{LAYERS} of K1, K3 and K5, {PAR_STEPS} steps "
            f"{LAYERS * PAR_STEPS} of K1-K4 and "
            f"{PAR_SPLIT_K5['step'] * LAYERS * PAR_STEPS} of K5, every other "
            f"kernel 0; replicas bit-equal")
        sm = r0["step_ms"]
        log(f"[parallel] ({label}) step ms a rank (CUDA events, median of "
            f"{len(PAR_TURNS) // 2 * PAR_TIMED[0][1]} bf16 / "
            f"{len(PAR_TURNS) // 2 * PAR_TIMED[1][1]} fp32 steps a setting, "
            f"settings in turns {', '.join(PAR_SETTING[t] for t in PAR_TURNS)}"
            f"): async bf16 {sm['async']['bfloat16']:.2f}, fp32 "
            f"{sm['async']['float32']:.2f}; sync bf16 "
            f"{sm['sync']['bfloat16']:.2f}, fp32 {sm['sync']['float32']:.2f};"
            f" single device bf16 {single_ms['bfloat16']:.2f}, fp32 "
            f"{single_ms['float32']:.2f}; the split step at P = 1 without a "
            f"process group bf16 {steps_ms['split']['bfloat16']:.2f}, fp32 "
            f"{steps_ms['split']['float32']:.2f} ({smi})")
        log(f"[parallel] ({label}) without deterministic algorithms: two "
            f"synchronous fp32 forwards and one step's gradients "
            f"({len(r0['grads'])} tensors) bit-equal, and "
            f"AERO_GNN_ASYNC_COLLECTIVES=1's bit-equal to them")
        for st, ov in r0["overlap_bf16"].items():
            if ov is None:
                log(f"[parallel] ({label}) {st} bf16 step: the profiler saw "
                    "no device event (overlap not measured)")
                continue
            log(f"[parallel] ({label}) {st} bf16 step on rank 0's timeline: "
                f"{ov['copies']} exchange copies and {ov['nccl_kernels']} "
                f"NCCL send / receive kernels, {ov['exchange_ms']:.3f} ms; "
                f"{ov['overlap_k12_ms']:.3f} ms of them overlap K1 / K2 "
                f"({ov['k12_ms']:.3f} ms), {ov['overlap_any_kernel_ms']:.3f}"
                f" ms overlap any kernel ({smi})")
        share = r0["interior_real"] / s0.num_edges
        ratio = {k: r0["interior_ms"][k] / (tight_ms[k] * share)
                 for k in tight_ms}
        record[label]["shard_tight_ratio"] = ratio
        chk = r0["interior_check"]
        log(f"[parallel] ({label}) shard 0 interior vs the tight "
            f"single-device graph: K1 {r0['interior_ms']['k1']:.4f} ms vs "
            f"{tight_ms['k1']:.4f} ms, K2 {r0['interior_ms']['k2']:.4f} vs "
            f"{tight_ms['k2']:.4f} (bf16); per real edge shard / tight: K1 "
            f"{ratio['k1']:.3f}, K2 {ratio['k2']:.3f}")
        for dt in ("bfloat16", "float32"):
            c = chk[dt]
            log(f"[parallel] ({label}) shard 0 interior kernels {dt} against "
                f"their plain versions ({r0['interior_rows']} edge rows, "
                f"{r0['nodes_per_part']} nodes): K1 max abs err "
                f"{c['K1']:.3e}, K3 {c['K3']:.3e} (TOL), K2 {c['K2'][0]:.3e} "
                f"(weight grads {c['K2'][1]:.3e} of max|p|), K4 "
                f"{c['K4'][0]:.3e} ({c['K4'][1]:.3e}), K5 {c['K5']:.3e}; "
                f"K2, K4, K5 bit-equal across launches")
    a0 = pair[0]["a"]
    log(f"[parallel] (a) all_to_all of a layer's halo ([{PAR_PARTS}, "
        f"{a0['halo_rows']}, {HIDDEN}]): bf16 "
        f"{a0['exchange_ms']['bfloat16']:.4f} ms, fp32 "
        f"{a0['exchange_ms']['float32']:.4f} ms ({smi})")
    # (c) data parallel
    for i, r in enumerate(pair):
        par_check_launches(f"(c) rank {i}", r["c"]["step_launches"],
                           par_want(step=1, split=False))
    worst_c = par_check_grads(torch, "(c)", pair[0]["c"]["grads"],
                              mean_grads)
    mean_loss = (loss0 + loss1) / 2
    for label, loss in (("c", pair[0]["c"]["loss"]),
                        ("d", hybrid[0]["loss"])):
        if abs(loss - mean_loss) > 1e-4 * abs(mean_loss):
            raise AssertionError(f"parallel ({label}): loss {loss} vs the "
                                 f"single-device mean {mean_loss}")
    launches["c"] = [r["c"]["step_launches"] for r in pair]
    record["c"] = {"loss": pair[0]["c"]["loss"], "grad_worst_rel_err": worst_c}
    log(f"[parallel] (c) data parallel, 2 gloo ranks, meshes 0 and 1: loss "
        f"{pair[0]['c']['loss']:.6f} (single-device mean {mean_loss:.6f}); "
        f"averaged gradients within TRAIN_GRAD_TOL of the mean of the two "
        f"single-device gradients, worst {worst_c:.3e} of max|p|")
    # (d) hybrid
    for i, r in enumerate(hybrid):
        par_check_launches(f"(d) rank {i}", r["step_launches"],
                           par_want(step=1))
        if not r["async_default"]:
            raise AssertionError(f"parallel (d) rank {i}: the exchange is "
                                 "not async by default")
    worst_d = par_check_grads(torch, "(d)", hybrid[0]["grads"], mean_grads)
    launches["d"] = [r["step_launches"] for r in hybrid]
    record["d"] = {"loss": hybrid[0]["loss"], "grad_worst_rel_err": worst_d}
    log(f"[parallel] (d) hybrid halo-split 2 x 2 gloo ranks, exchange "
        f"async: loss "
        f"{hybrid[0]['loss']:.6f}; gradients within TRAIN_GRAD_TOL of the "
        f"single-device mean, worst {worst_d:.3e} of max|p|")
    # (e) BSMS halo
    e0 = pair[0]["e"]
    for i, r in enumerate(pair):
        par_check_launches(
            f"(e) rank {i} forward", r["e"]["forward_launches"],
            par_want(forward=1, k5_extra=PAR_BSMS_K5["forward"]))
        par_check_launches(f"(e) rank {i} step", r["e"]["step_launches"],
                           par_want(step=1, k5_extra=PAR_BSMS_K5["step"]))
    err_e = par_check_rows("(e) forward", e0["forward"], bsms_fwd)
    worst_e = par_check_grads(torch, "(e)", e0["grads"], bsms_grads)
    launches["e"] = {"forward": [r["e"]["forward_launches"] for r in pair],
                     "step": [r["e"]["step_launches"] for r in pair]}
    record["e"] = {"levels": e0["levels"], "forward_err": err_e,
                   "pool_check": e0["pool_check"],
                   "grad_worst_rel_err": worst_e, "loss": e0["loss"],
                   "single_loss": float(bloss.detach())}
    log(f"[parallel] (e) BSMS halo P=2 (bistride, 3 scales, weighted, "
        f"levels (rows per shard, H) {e0['levels']}): forward max abs err "
        f"{err_e:.3e} vs single-device BSMS (SERVE_TOL); step gradients "
        f"worst {worst_e:.3e} of max|p|; loss {e0['loss']:.6f} vs "
        f"{float(bloss.detach()):.6f}; K5 {PAR_BSMS_K5['forward']} more a "
        f"forward and {PAR_BSMS_K5['step']} a step for the transfers; the "
        f"fp32 forward and step gradients twice bit-equal on each rank")
    for k, rows, err in e0["pool_check"]:
        log(f"[parallel] (e) rank 0 level {k} WEC spread: "
            f"ops.segment_pool_sum (K5) on {rows} interior rows x {HIDDEN} "
            f"fp32 against the plain segment sum, max abs err {err:.3e} "
            f"(TOL)")
    # (f) the checkpoint
    saved = a0["saved"]
    for i, r in enumerate(restored):
        if r["restored"] != (1, {"loss": [a0["loss"]]}):
            raise AssertionError(f"parallel (f) rank {i}: restored "
                                 f"{r['restored']}")
        got = r["state"]
        same = (len(got[0]) == len(saved[0])
                and all(np.array_equal(a, b)
                        for a, b in zip(got[0], saved[0]))
                and len(got[1]) == len(saved[1])
                and all(x[0] == y[0] and np.array_equal(x[1], y[1])
                        and np.array_equal(x[2], y[2])
                        for x, y in zip(got[1], saved[1])))
        if not same:
            raise AssertionError(f"parallel (f) rank {i}: the restored state "
                                 "is not the saved one bit for bit")
    log(f"[parallel] (f) save_dcp of (a)'s state (async) restored by "
        f"restore_dcp in 2 fresh ranks: {len(saved[0])} parameters and "
        f"{len(saved[1])} Adam states bit-equal")
    log(f"[parallel] ranks: pair {pair_s:.1f} s, nccl {nccl_s:.1f} s, hybrid "
        f"and restore side by side {hybrid_s:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", help="write the full JSON record here")
    ap.add_argument("--tail-only", action="store_true",
                    help="run only the device, build and tail phases")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run only the device, build and parallel phases")
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
    host_graph = host_graph_build(torch, graphs[0][0], dev, smi)
    if args.parallel_only:
        print(json.dumps({"parallel": phase_parallel(torch, smi, graphs)},
                         default=str))
        return 0
    tail = phase_tail(torch, *graphs[0])
    if args.tail_only:
        print(json.dumps({"tail": tail}))
        return 0
    kernels = phase_kernels(torch, graphs[0][1])
    zoo_reqs = zoo_requests(torch, [s for s, _ in graphs], dev)
    k6, k6_record = phase_gather(torch, [("tight", graphs[0][1]),
                                         ("loader", zoo_reqs[0][1])])
    kernels += k6
    k5_receiver = phase_k5_receiver(torch, zoo_reqs[0][1])
    for k in kernels:
        base, dtype = k["name"].rstrip("]").split("[")
        if base == "segment_sum":
            k["receiver_stream"] = k5_receiver[dtype]["masked"]
            k["receiver_unmasked_stream"] = k5_receiver[dtype]["unmasked"]
    requests, bsms_host = bsms_requests(torch, [s for s, _ in graphs], dev)
    k7, k7_record = phase_weighted(torch, requests[0][1],
                                   requests[0][2]["hierarchy"])
    kernels += k7
    phase_shapes(torch, flagship_graph(3, dev, n_nodes=4096)[1])
    switched, switched_record = phase_switched_kernels(torch, *graphs[0])
    kernels += switched
    k10, k10_record = phase_weighted2(torch, graphs[0][1])
    kernels.append(k10)
    launches, serve_ms = phase_serve(torch, graphs)
    train_launches, train_record = phase_train(torch, *graphs[0])
    cli_counts, cli_record = phase_cli(torch, smi)
    bsms_serve, bsms_serve_record = phase_bsms_serve(torch, requests)
    bsms_train, bsms_train_record = phase_bsms_train(torch, *requests[0])
    bsms_sw, bsms_sw_record = phase_bsms_switches(torch, requests)
    del requests
    torch.cuda.empty_cache()
    zoo = phase_zoo(torch, zoo_reqs)
    del zoo_reqs
    torch.cuda.empty_cache()
    save_launches, save_record = phase_save_acts(torch, *graphs[0])
    mega_launches, mega_record = phase_mega(torch, graphs)
    remat_record = phase_remat(torch, graphs[0][1])
    par_launches, par_record = phase_parallel(torch, smi, graphs)
    del graphs
    torch.cuda.empty_cache()
    large_launches, large_record = phase_large(torch, dev, smi)
    for k in kernels:
        base, dtype = k["name"].rstrip("]").split("[")
        if base in FUSED_STEP:
            # phase parallel: per rank, each run's forward and steps
            k["launches_parallel"] = {
                f"{run}_{what}": [c[base] for c in counts]
                for run, per in par_launches.items()
                for what, counts in (per.items() if isinstance(per, dict)
                                     else (("step", per),))}
            # phase large: the 1M-node training steps of each run
            k["launches_large"] = {
                label: large_launches[label][base]
                for label, dt, _, _ in LARGE_RUNS if dt == dtype}
        if dtype == "float32" and base in ("segment_sum",
                                           "segment_sum_weighted"):
            k["launches_bsms_switches"] = {
                label: {run: counts[base] for run, counts in c.items()}
                for label, c in bsms_sw.items()}
            if base == "segment_sum":
                k["pool"] = bsms_sw_record["pool"]
        if base == "segment_sum" and dtype == "float32":
            # poolMGN's and MGNv2's per-graph pools
            k["launches_zoo"] = {
                kind: {run: zoo[kind]["float32"][run]["launches"][base]
                       for run in ("serve", "train")} for kind in ZOO_REPEAT}
        fourier = zoo["fouriermgn"][dtype]
        if base in ("gather_rows", "segment_sum"):
            k["launches_fouriermgn_serve"] = \
                fourier["serve"]["launches"][base]
            k["launches_fouriermgn_train"] = \
                fourier["train"]["launches"][base]
        if base == "segment_sum_weighted2":
            pass  # counted over the probe's run (phase_weighted2)
        elif base in ("fused_edge_fwd_save", "fused_edge_bwd_saved"):
            # training with AERO_GNN_SAVE_ACTS=1 is their main path
            k["launches"] = save_launches[dtype][base]
            k["launches_per_train_step"] = (
                k["launches"] / SAVE_ACTS_STEPS[dtype])
        elif base in ("fused_mgn_fwd", "fused_mgn_bwd"):
            # serving (K9-fwd) and training with AERO_GNN_MEGA=1
            k["launches_train"] = mega_launches["train"][dtype][base]
            k["launches_per_train_step"] = (
                k["launches_train"] / MEGA_STEPS[dtype])
            k["launches"] = k["launches_train"]
            if base == "fused_mgn_fwd":
                k["launches"] = mega_launches["serve"][dtype][base]
                k["launches_per_forward"] = (
                    k["launches"] / mega_record["serve"][dtype]["n_forwards"])
        elif base == "gather_rows":
            # FourierMGN serving is K6's main path
            k["launches"] = fourier["serve"]["launches"][base]
            k["launches_per_forward"] = (
                k["launches"] / fourier["serve"]["n_forwards"])
            k["launches_train"] = fourier["train"]["launches"][base]
            k["launches_per_train_step"] = (
                k["launches_train"] / fourier["train"]["n_steps"])
        elif base == "segment_sum_weighted":
            # BSMS serving is K7's main path; training runs it
            k["launches"] = bsms_serve[base]
            k["launches_per_forward"] = (
                bsms_serve[base] / bsms_serve_record["n_forwards"])
            k["launches_train"] = bsms_train[base]
            k["launches_per_train_step"] = (
                bsms_train[base] / bsms_train_record["n_steps"])
        else:
            trained = train_launches[dtype][base]
            if base in ("fused_edge_fwd", "fused_node_fwd"):
                # serving is this kernel's main path (PR 1); training runs it
                k1, k3, n_fwd = launches[dtype]
                k["launches"] = k1 if base == "fused_edge_fwd" else k3
                k["launches_per_forward"] = k["launches"] / n_fwd
            else:
                k["launches"] = trained
            k["launches_train"] = trained
            k["launches_per_train_step"] = trained / TRAIN_STEPS[dtype]
            # the CLI's train (2 epochs + inference), infer and resume runs
            k["launches_cli"] = {run: counts[base]
                                 for run, counts in cli_counts[dtype].items()}
            if dtype == "float32":  # the BSMS path computes in fp32
                k["launches_bsms_serve"] = bsms_serve[base]
                k["launches_bsms_train"] = bsms_train[base]
        if not k["launches"]:
            raise AssertionError(f"{k['name']} never launched on the main path")
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as f:
            json.dump({"nvidia_smi": smi, "build_s": build_s,
                       "host_graph": host_graph,
                       "kernels": kernels, "launches": launches,
                       "serve_ms": serve_ms,
                       "train": train_record,
                       "train_launches": train_launches, "tail": tail,
                       "cli": cli_record, "cli_launches": cli_counts,
                       "k7": k7_record, "bsms_host": bsms_host,
                       "bsms_serve": bsms_serve_record,
                       "bsms_serve_launches": bsms_serve,
                       "bsms_train": bsms_train_record,
                       "bsms_train_launches": bsms_train,
                       "k6": k6_record, "zoo": zoo,
                       "switched": switched_record, "k10": k10_record,
                       "save_acts": save_record,
                       "save_acts_launches": save_launches,
                       "mega": mega_record, "mega_launches": mega_launches,
                       "bsms_switches": bsms_sw_record,
                       "bsms_switches_launches": bsms_sw,
                       "remat": remat_record, "large": large_record,
                       "large_launches": large_launches,
                       "parallel": par_record,
                       "parallel_launches": par_launches,
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
