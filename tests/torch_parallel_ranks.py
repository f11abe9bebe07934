"""Rank programs of the port's parallel tests (tests/test_torch_parallel_*).

``run_ranks(program, world, tmp_path, spec)`` starts ``world`` ranks through
the port's launcher (``parallel.distributed.spawn``), wires them as gloo
ranks on the CPU through a FileStore in ``tmp_path``
(``parallel.distributed.initialize``), runs ``program(rank, world, spec)``
in each and returns the ranks' results (picklable values). A rank that
raises fails the call with its traceback. This module imports torch and the
port only, so a rank starts without JAX.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

TIMEOUT_S = 150


def run_ranks(program, world: int, tmp_path, spec):
    from aero_gnn_tpu_torch.parallel import distributed as PD

    store = os.path.join(str(tmp_path),
                         f"store_{program.__name__}_{time.monotonic_ns()}")
    (results,) = PD.spawn([(functools.partial(_cpu_rank, program, store),
                            world, spec, {})], timeout_s=TIMEOUT_S)
    return results


def _cpu_rank(program, store, rank, world, spec):
    from aero_gnn_tpu_torch.parallel import distributed as PD

    torch.set_num_threads(1)
    PD.initialize(f"file://{store}", world, rank, device="cpu")
    return program(rank, world, spec)


def failing_program(rank: int, world: int, spec) -> None:
    """Rank 1 raises; the others wait in a barrier that never completes
    (the launcher must kill them and report rank 1's traceback)."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 gave up")
    dist.barrier()


# ---------------------------------------------------------------------------
# helpers shared by the programs and the tests
# ---------------------------------------------------------------------------

def mesh_sample(n_nodes: int, seed: int):
    """The port's make_random_mesh_sample with its features (the same
    arrays as the JAX package's, bit for bit)."""
    from aero_gnn_tpu_torch.data import dataset as D
    from aero_gnn_tpu_torch.data.synthetic import make_random_mesh_sample

    s = make_random_mesh_sample(n_nodes=n_nodes, seed=seed)
    D.compute_features([s], ["mach", "alpha"])
    return s


def graph_kw(s) -> dict:
    return dict(senders=s.senders, receivers=s.receivers, x=s.x,
                edge_attr=s.edge_attr, pos=s.pos, y=s.y)


def model_config(kind: str, kw: dict):
    from aero_gnn_tpu_torch.models.bsms import BSMSConfig
    from aero_gnn_tpu_torch.models.fouriermgn import FourierMGNConfig
    from aero_gnn_tpu_torch.models.mgn import MGNConfig
    from aero_gnn_tpu_torch.models.poolmgn import PoolMGNConfig

    return {"mgn": MGNConfig, "fouriermgn": FourierMGNConfig,
            "poolmgn": PoolMGNConfig, "bsms": BSMSConfig}[kind](**kw)


# the switched paths' kernel wrappers (K1's save variant, K8, K9, K10)
_SWITCHED = (("fused_edge_fwd_save", "hopper_fused", "fused_edge_layer_save"),
             ("fused_edge_bwd_saved", "hopper_fused",
              "fused_edge_layer_bwd_saved"),
             ("fused_mgn_fwd", "hopper_mega", "fused_mgn_layer"),
             ("fused_mgn_bwd", "hopper_mega", "fused_mgn_layer_bwd"),
             ("segment_sum_weighted2", "hopper_segment",
              "segment_sum_weighted2"))

COUNTED = (("fused_edge_fwd", "hopper_fused", "fused_edge_layer"),
           ("fused_edge_bwd", "hopper_fused", "fused_edge_layer_bwd"),
           ("fused_node_fwd", "hopper_node", "fused_node_layer"),
           ("fused_node_bwd", "hopper_node", "fused_node_layer_bwd"),
           ("segment_sum", "hopper_segment", "segment_sum"),
           ("segment_sum_weighted", "hopper_segment", "segment_sum_weighted"),
           ("gather_rows", "hopper_gather", "gather_rows"))


_COUNTS: dict = {}


def count_kernel_calls() -> dict:
    """Wrap each kernel wrapper of COUNTED (the function that launches the
    kernel on CUDA tensors and runs its plain version on CPU tensors) with
    a counter, once per process; returns {name: [calls]}."""
    import importlib

    if _COUNTS:
        return _COUNTS
    counts = _COUNTS
    for name, mod, fn in COUNTED:
        m = importlib.import_module(f"aero_gnn_tpu_torch.ops.{mod}")
        orig = getattr(m, fn)
        box = counts[name] = [0]

        def counted(*a, _orig=orig, _box=box, **k):
            _box[0] += 1
            return _orig(*a, **k)

        setattr(m, fn, counted)
    return counts


def snapshot(counts: dict) -> dict:
    return {k: v[0] for k, v in counts.items()}


def delta(before: dict, counts: dict) -> dict:
    return {k: v[0] - before[k] for k, v in counts.items()}


def partition(scheme: str, s, num_parts: int, part_kw: dict):
    from aero_gnn_tpu_torch.parallel import bsms_spatial as BS
    from aero_gnn_tpu_torch.parallel import halo as HL
    from aero_gnn_tpu_torch.parallel import spatial as SP

    kw = dict(graph_kw(s), num_parts=num_parts, **part_kw)
    if scheme == "bsms_halo":
        kw.update(senders=np.asarray(s.senders, np.int64),
                  receivers=np.asarray(s.receivers, np.int64))
    return {"spatial": SP.partition_graph, "model": SP.partition_graph,
            "halo": HL.partition_graph_halo,
            "halo_split": HL.partition_graph_halo_split,
            "bsms_spatial": BS.partition_bsms,
            "bsms_halo": BS.partition_bsms_halo}[scheme](**kw)


def _builders(scheme: str):
    from aero_gnn_tpu_torch.parallel import bsms_spatial as BS
    from aero_gnn_tpu_torch.parallel import halo as HL
    from aero_gnn_tpu_torch.parallel import spatial as SP

    return {"spatial": (SP.make_spatial_forward, SP.make_spatial_train_step),
            "model": (SP.make_spatial_forward, None),
            "halo": (HL.make_halo_forward, HL.make_halo_train_step),
            "halo_split": (HL.make_halo_split_forward,
                           HL.make_halo_split_train_step),
            "bsms_spatial": (BS.make_bsms_spatial_forward,
                             BS.make_bsms_spatial_train_step),
            "bsms_halo": (BS.make_bsms_halo_forward,
                          BS.make_bsms_halo_train_step)}[scheme]


def grads_tree(params, cfg) -> dict:
    from aero_gnn_tpu_torch.models.convert import params_to_jax

    return params_to_jax(params, cfg, grads=True)


def sharded_program(rank: int, world: int, spec: dict) -> dict:
    """One scheme of spec["scheme"] over a (data, graph) grid of
    spec["mesh"]: rank (d, g) holds shard g of the mesh of sample d
    (spec["samples"][d] = (n_nodes, seed)). Returns this rank's forward
    predictions (fp32 [Nl, Dy]), the gradients of one Adam step (the JAX
    tree's layout), the losses of spec["steps"] Adam steps (lr 1e-3) and,
    with spec["count"], the kernel wrappers' calls in the forward and in
    one step. With spec["psum_numerator"] the loss takes a numerator
    summed across ranks instead (the seed-inflation fault)."""
    from aero_gnn_tpu_torch.models.convert import params_from_jax
    from aero_gnn_tpu_torch.parallel import collectives as C
    from aero_gnn_tpu_torch.parallel import hybrid as HY
    from aero_gnn_tpu_torch.parallel import mesh as PM
    from aero_gnn_tpu_torch.parallel import spatial as SP
    from aero_gnn_tpu_torch.training.loop import make_optimizer

    counts = count_kernel_calls() if spec.get("count") else None
    data, graph = spec["mesh"]
    mesh = PM.make_mesh(data=data, graph=graph)
    d, g = mesh.coords()
    s = mesh_sample(*spec["samples"][d])
    cfg = model_config(spec["kind"], spec["cfg"])
    sh = partition(spec["scheme"], s, graph, spec.get("part", {})).shard(
        g, "cpu")
    fwd_fn, step_fn = _builders(spec["scheme"])
    params = params_from_jax(spec["tree"], cfg, device="cpu")
    out = {}
    if data == 1:
        before = counts and snapshot(counts)
        fwd = fwd_fn(cfg, mesh)(params, sh)
        out["forward"] = fwd.numpy()
        if counts:
            out["forward_counts"] = delta(before, counts)
    shard_loss = SP.shard_loss
    if spec.get("psum_numerator"):
        def psum_loss(pred, y, node_mask, group):
            m = node_mask[:, None]
            se = C.all_reduce_sum(torch.sum(torch.square(pred - y) * m),
                                  group)
            cnt = C.all_reduce_raw((torch.sum(m) * y.shape[-1]).detach(),
                                   group)
            return se / cnt

        SP.shard_loss = psum_loss
    steps = spec.get("steps", 0)
    if steps:
        opt = make_optimizer(params, 1e-3)
        if data > 1:
            step = (HY.make_hybrid_train_step if spec["scheme"] == "spatial"
                    else HY.make_hybrid_halo_split_train_step)(cfg, opt, mesh)
        else:
            step = step_fn(cfg, opt, mesh)
        losses = []
        for i in range(steps):
            before = counts and snapshot(counts)
            losses.append(float(step(params, sh)))
            if i == 0:
                out["grads"] = grads_tree(params, cfg)
                if counts:
                    out["step_counts"] = delta(before, counts)
        out["losses"] = losses
        out["params"] = [p.detach().numpy().copy()
                         for p in params.parameters()]
    SP.shard_loss = shard_loss
    return out


def multi_program(rank: int, world: int, specs: dict) -> dict:
    """sharded_program for each named spec, in one set of ranks."""
    return {name: sharded_program(rank, world, spec)
            for name, spec in specs.items()}


def dp_program(rank: int, world: int, spec: dict) -> dict:
    """Data parallelism over ``world`` ranks: rank r trains on sample
    spec["samples"][r] (a GraphBatch padded to spec["pad"]); the
    averaged gradients of the first Adam step, the losses of
    spec["steps"] steps, and the eval loss before them. With
    spec["dropout_seed"] the per-rank generators are drawn too."""
    from aero_gnn_tpu_torch.graph import padded
    from aero_gnn_tpu_torch.models.convert import params_from_jax
    from aero_gnn_tpu_torch.parallel import data_parallel as DP
    from aero_gnn_tpu_torch.parallel import mesh as PM
    from aero_gnn_tpu_torch.training.loop import make_optimizer

    mesh = PM.make_mesh(data=world, graph=1)
    s = mesh_sample(*spec["samples"][rank])
    n_pad, e_pad = spec["pad"]
    gb = padded.build_graph_batch(**graph_kw(s), num_nodes_pad=n_pad,
                                  num_edges_pad=e_pad, device="cpu")
    cfg = model_config(spec["kind"], spec["cfg"])
    params = params_from_jax(spec["tree"], cfg, device="cpu")
    out = {"eval": float(DP.make_dp_eval_step(cfg, mesh)(params, gb))}
    opt = make_optimizer(params, 1e-3)
    step = DP.make_dp_train_step(cfg, opt, mesh)
    losses = []
    for i in range(spec["steps"]):
        losses.append(float(step(params, gb)))
        if i == 0:
            out["grads"] = grads_tree(params, cfg)
    out["losses"] = losses
    if "dropout_seed" in spec:
        gen = DP.rank_generator(spec["dropout_seed"], mesh.coords()[0],
                                torch.device("cpu"))
        out["draw"] = torch.rand(8, generator=gen).numpy()
    return out


def dp_and_collectives_program(rank: int, world: int, spec: dict) -> dict:
    """dp_program and collectives_program in one set of ranks."""
    return {"dp": dp_program(rank, world, spec),
            "collectives": collectives_program(rank, world, spec)}


def collectives_program(rank: int, world: int, spec: dict) -> dict:
    """Central differences of the global objective sum_r <w_r, op(x_r)>
    (float64) against each collective's autograd gradient, at a few
    coordinates of each rank's input; returns [(op, autograd, numeric)]."""
    from aero_gnn_tpu_torch.parallel import collectives as C
    from aero_gnn_tpu_torch.parallel import mesh as PM

    group = PM.make_mesh(data=1, graph=world).group("graph")
    rng = np.random.default_rng(100 + rank)
    shapes = {"all_gather_tiled": (3, 2), "all_to_all": (world, 2, 3),
              "all_reduce_sum": (4, 2), "all_to_all_start": (world, 2, 3)}
    ops = dict(all_gather_tiled=C.all_gather_tiled, all_to_all=C.all_to_all,
               all_reduce_sum=C.all_reduce_sum,
               all_to_all_start=lambda x, g: C.all_to_all_start(x, g).wait())
    out = []
    for name in spec.get("collectives", ("all_gather_tiled", "all_to_all",
                                          "all_reduce_sum")):
        shape, op = shapes[name], ops[name]
        x = torch.tensor(rng.standard_normal(shape), requires_grad=True)
        y_shape = op(x.detach(), group).shape
        w = torch.tensor(rng.standard_normal(tuple(y_shape)))

        def objective(xx):
            return C.all_reduce_raw(torch.sum(w * op(xx, group)), group)

        torch.sum(w * op(x, group)).backward()
        eps = 1e-6
        for owner in range(world):
            for idx in [(0,) * len(shape), tuple(n - 1 for n in shape)]:
                vals = []
                for sign in (1.0, -1.0):
                    xx = x.detach().clone()
                    if rank == owner:
                        xx[idx] += sign * eps
                    vals.append(float(objective(xx)))
                num = (vals[0] - vals[1]) / (2 * eps)
                if rank == owner:
                    out.append((name, float(x.grad[idx]), num))
    return out


def checkpoint_program(rank: int, world: int, spec: dict) -> dict:
    """spec["mode"] "save": two Adam steps of the halo-split MGN, then
    save_dcp (asynchronous) as epoch 2, returns the state saved;
    "restore": fresh parameters and optimizer, restore_dcp, returns the
    state restored."""
    from aero_gnn_tpu_torch.models.convert import params_from_jax
    from aero_gnn_tpu_torch.parallel import halo as HL
    from aero_gnn_tpu_torch.parallel import mesh as PM
    from aero_gnn_tpu_torch.training import checkpoint as CK
    from aero_gnn_tpu_torch.training.loop import make_optimizer

    mesh = PM.make_mesh(data=1, graph=world)
    cfg = model_config("mgn", spec["cfg"])
    params = params_from_jax(spec["tree"], cfg, device="cpu")
    opt = make_optimizer(params, 1e-3)
    manager = CK.make_dcp_manager(spec["dir"], max_to_keep=2)
    if spec["mode"] == "save":
        s = mesh_sample(*spec["sample"])
        sh = HL.partition_graph_halo_split(
            **graph_kw(s), num_parts=world).shard(mesh.coords()[1], "cpu")
        step = HL.make_halo_split_train_step(cfg, opt, mesh)
        for epoch in range(3):
            step(params, sh)
            CK.save_dcp(manager, params, opt, epoch, {"epoch": [epoch]})
        manager.wait_until_finished()
        restored = None
    else:
        restored = CK.restore_dcp(manager, params, opt)
    state = opt.state_dict()["state"]
    return {"params": [p.detach().numpy().copy()
                       for p in params.parameters()],
            "adam": [(float(v["step"]), v["exp_avg"].numpy().copy(),
                      v["exp_avg_sq"].numpy().copy())
                     for _, v in sorted(state.items())],
            "restored": restored, "steps": manager.all_steps()}


def async_program(rank: int, world: int, spec: dict) -> dict:
    """The halo exchange issued asynchronously and synchronously:
    sharded_program for each case of spec["cases"] under
    AERO_GNN_ASYNC_COLLECTIVES "0" and "1" ({case: {setting: result}}),
    the order of one step's exchanges and interior kernels
    (exchange_order_program), and all_to_all_start's backward against
    central differences (collectives_program)."""
    saved = os.environ.get("AERO_GNN_ASYNC_COLLECTIVES")
    out = {"cases": {}}
    try:
        for name, case in spec["cases"].items():
            out["cases"][name] = {}
            for setting in ("0", "1"):
                os.environ["AERO_GNN_ASYNC_COLLECTIVES"] = setting
                out["cases"][name][setting] = sharded_program(rank, world,
                                                              case)
        os.environ["AERO_GNN_ASYNC_COLLECTIVES"] = "1"
        out["order"] = {name: exchange_order_program(rank, world, case)
                        for name, case in spec["order"].items()}
    finally:
        if saved is None:
            os.environ.pop("AERO_GNN_ASYNC_COLLECTIVES", None)
        else:
            os.environ["AERO_GNN_ASYNC_COLLECTIVES"] = saved
    out["collectives"] = collectives_program(
        rank, world, {"collectives": ("all_to_all_start",)})
    return out


class _LoggedWork:
    """A collective's work handle whose wait() is logged."""

    def __init__(self, work, log):
        self._work, self._log = work, log

    def wait(self, *a, **k):
        self._log.append("wait")
        return self._work.wait(*a, **k)


def exchange_order_program(rank: int, world: int, spec: dict) -> list:
    """One forward and backward of the halo-split MGN (spec as for
    sharded_program, one shard per rank) with every all_to_all_single
    ("start", or "sync" without async_op), every wait on its work
    ("wait"), the interior's fused edge layer ("interior") and its backward
    ("interior_bwd") logged in call order; "backward" marks the start of
    the backward. Returns the log."""
    import torch.distributed as dist

    from aero_gnn_tpu_torch.models.convert import params_from_jax
    from aero_gnn_tpu_torch.ops import hopper_fused as HF
    from aero_gnn_tpu_torch.parallel import halo as HL
    from aero_gnn_tpu_torch.parallel import mesh as PM
    from aero_gnn_tpu_torch.parallel import spatial as SP

    log = []
    originals = {"all_to_all_single": dist.all_to_all_single,
                 "fused_edge_layer": HF.fused_edge_layer,
                 "fused_edge_layer_bwd": HF.fused_edge_layer_bwd}

    def a2a(*a, async_op=False, **k):
        log.append("start" if async_op else "sync")
        work = originals["all_to_all_single"](*a, async_op=async_op, **k)
        return _LoggedWork(work, log) if async_op else work

    def logged(label, fn):
        def call(*a, **k):
            log.append(label)
            return fn(*a, **k)
        return call

    mesh = PM.make_mesh(data=1, graph=world)
    group = mesh.group("graph")
    s = mesh_sample(*spec["samples"][0])
    cfg = model_config("mgn", spec["cfg"])
    sh = partition("halo_split", s, world, spec["part"]).shard(
        mesh.coords()[1], "cpu")
    params = params_from_jax(spec["tree"], cfg, device="cpu")
    dist.all_to_all_single = a2a
    HF.fused_edge_layer = logged("interior", HF.fused_edge_layer)
    HF.fused_edge_layer_bwd = logged("interior_bwd", HF.fused_edge_layer_bwd)
    try:
        pred = HL.halo_split_mgn_forward(params, cfg, sh, group)
        loss = SP.shard_loss(pred, sh.y, sh.node_mask, group)
        log.append("backward")
        loss.backward()
    finally:
        dist.all_to_all_single = originals["all_to_all_single"]
        HF.fused_edge_layer = originals["fused_edge_layer"]
        HF.fused_edge_layer_bwd = originals["fused_edge_layer_bwd"]
    return log


# ---------------------------------------------------------------------------
# the order of the sums (tests/test_torch_determinism.py)
# ---------------------------------------------------------------------------

def _adds_atomically(name: str, args, kwargs) -> bool:
    """Whether an aten op adds rows in the order its CUDA atomics land:
    index_add, scatter_add, put / index_put with accumulate, a summing
    scatter_reduce; except where every value added is 0 or 1 (counts,
    exact in any order: ``ops.degree``, the ties of ``segment_max``'s
    backward)."""
    name = name.rstrip("_")
    values = None
    if name in ("index_add", "scatter_add"):
        values = args[3]
    elif name in ("index_put", "_index_put_impl", "put"):
        k = 2 if name == "put" else 3
        if not kwargs.get("accumulate", args[k] if len(args) > k else False):
            return False
        values = args[k - 1]
    elif name == "scatter_reduce":
        reduce = kwargs.get("reduce", args[3] if len(args) > 3 else None)
        if reduce not in ("sum", "mean"):
            return False
        values = args[2]
    else:
        return name == "embedding_dense_backward"
    return not bool(((values == 0) | (values == 1)).all())


class AtomicSums:
    """``with AtomicSums() as rec:`` records in ``rec.found`` every aten op
    of the block (backward passes included) that would add in the atomics'
    order on CUDA (``_adds_atomically``), outside the calls of the kernel
    wrappers (whose plain versions on CPU tensors sum with index_add_; on
    the card each launches its kernel); ``rec.k5`` counts the K5 wrapper's
    calls."""

    def __init__(self):
        import importlib

        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self
        self.found, self.k5, self._depth = [], 0, 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = func.overloadpacket.__name__
                if not rec._depth and _adds_atomically(name, args, kwargs):
                    rec.found.append(name)
                return func(*args, **kwargs)

        def exempt(fn, count):
            def wrapped(*a, **k):
                rec.k5 += count
                rec._depth += 1
                try:
                    return fn(*a, **k)
                finally:
                    rec._depth -= 1
            return wrapped

        self._mode = Mode()
        self._patches = []
        for name, mod, fn in COUNTED + _SWITCHED:
            m = importlib.import_module(f"aero_gnn_tpu_torch.ops.{mod}")
            self._patches.append(
                (m, fn, exempt(getattr(m, fn), name == "segment_sum")))

    def __enter__(self):
        self._saved = [(m, n, getattr(m, n)) for m, n, _ in self._patches]
        for m, n, fn in self._patches:
            setattr(m, n, fn)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        for m, n, fn in self._saved:
            setattr(m, n, fn)
        return False


def order_program(rank: int, world: int, specs: dict) -> dict:
    """For each named spec (scheme, kind, config, partition kwargs): this
    rank's shard of a small mesh, a forward and one training step on the
    cuda backend inside AtomicSums; returns {name: (found, K5 calls)}."""
    from aero_gnn_tpu_torch import ops
    from aero_gnn_tpu_torch.parallel import mesh as PM
    from aero_gnn_tpu_torch.training.loop import make_optimizer

    mesh = PM.make_mesh(data=1, graph=world)
    out = {}
    for name, (scheme, kind, kw, part) in specs.items():
        s = mesh_sample(480, 4)
        sh = partition(scheme, s, world, part).shard(mesh.coords()[1], "cpu")
        cfg = model_config(kind, kw)
        params = cfg.init(0, device="cpu")
        fwd_fn, step_fn = _builders(scheme)
        with ops.use_backend("cuda"), AtomicSums() as rec:
            fwd_fn(cfg, mesh)(params, sh)
            step_fn(cfg, make_optimizer(params, 1e-3), mesh)(params, sh)
        out[name] = (rec.found, rec.k5)
    return out
