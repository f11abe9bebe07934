"""The order of the port's sums on the cuda backend, on the CPU: every
float sum of a forward and of a training step runs on the K5 wrapper
(``hopper_segment.segment_sum``, its plain version on CPU tensors) over ids
sorted on the host, and no other op adds in the order of CUDA's atomics
(index_add, scatter_add, index_put with accumulate; ``ops.degree``'s exact
0/1 counts excepted), recorded by a dispatch mode over the models of the
registry, the flagship-shaped BSMS under each transfer switch and the
sharded schemes at P = 2 (gloo ranks, spawned once); each host order is
the stable sort of its table; the chunked per-graph pools of poolMGN and
MGNv2 and their first-step gradients against the JAX package (the
sharded forwards and gradients against JAX under the same routing:
tests/test_torch_parallel_{halo,bsms}.py); and
``inference.metrics.compute_errors`` and
``parallel.mesh.local_device_count`` against JAX's."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_zoo import MODELS, build_pair, loader_batches

import torch_parallel_ranks as R
from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.inference import metrics as JM
from aero_gnn_tpu.training import loop as JL
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data.batching import Loader
from aero_gnn_tpu_torch.data.synthetic import make_random_mesh_sample
from aero_gnn_tpu_torch.graph import padded
from aero_gnn_tpu_torch.inference import metrics as TM
from aero_gnn_tpu_torch.models import registry as TR
from aero_gnn_tpu_torch.models.bsms import BSMSConfig
from aero_gnn_tpu_torch.models.convert import params_to_jax
from aero_gnn_tpu_torch.parallel import bsms_spatial as BS
from aero_gnn_tpu_torch.parallel import halo as HL
from aero_gnn_tpu_torch.parallel import mesh as PM
from aero_gnn_tpu_torch.parallel.spatial import SortOrder
from aero_gnn_tpu_torch.training import loop as TL

H = 16
DIMS = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4)
MGN = dict(DIMS, processor_size=2, hidden_dim_processor=H,
           hidden_dim_node_encoder=H, hidden_dim_edge_encoder=H,
           hidden_dim_decoder=H, num_hidden_layers_node_processor=2,
           num_hidden_layers_edge_processor=2, do_concat_trick=True)
BSMS = dict(MGN, processor_size=5, num_scales=3, layers_per_scale=1,
            remat=False, hierarchy_mode="bistride", transfer="weighted")
_SWITCHES = ("AERO_GNN_SORTED_POOL", "AERO_GNN_WEC_FUSED")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(n_nodes=400, seed=3):
    s = make_random_mesh_sample(n_nodes=n_nodes, seed=seed)
    TD.compute_features([s], ["mach", "alpha"])
    return s


def _stable(ids):
    perm = np.argsort(ids, kind="stable")
    return perm, ids[perm]


# ---------------------------------------------------------------------------
# host orders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["runs", "one_id", "empty_ids", "tail"])
def test_chunk_plan_is_a_chunked_stable_sort(case):
    rng = np.random.default_rng(5)
    ids = {"runs": rng.integers(0, 40, 3000),
           "one_id": np.zeros(5000, np.int64),
           "empty_ids": rng.choice([1, 4, 9], 700),
           "tail": np.r_[np.repeat(np.arange(300), 3),
                         np.full(2000, 300)]}[case]
    n_seg = int(ids.max()) + 3
    perm, chunk, chunk_seg = padded.chunk_plan(ids, n_seg)
    ref_perm, ref_sorted = _stable(ids)
    np.testing.assert_array_equal(perm, ref_perm)
    size = max(16, int(np.ceil(np.sqrt(len(ids) / 8))))
    assert np.all(np.diff(chunk) >= 0) and np.all(np.diff(chunk_seg) >= 0)
    assert np.bincount(chunk).max() <= size
    np.testing.assert_array_equal(chunk_seg[chunk], ref_sorted)
    assert len(chunk_seg) == -(-len(ids) // size) + n_seg
    assert chunk.dtype == perm.dtype == chunk_seg.dtype == np.int32


def test_graph_batch_carries_the_chunk_plan():
    graphs = [dict(senders=s.senders, receivers=s.receivers, x=s.x,
                   edge_attr=s.edge_attr, pos=s.pos, y=s.y)
              for s in (_sample(300, 1), _sample(90, 2), _sample(500, 3))]
    gb = padded.batch_graphs(graphs, device="cpu")
    ng = gb.node_graph.numpy()
    want = padded.chunk_plan(ng, gb.num_graphs_pad)
    for got, ref in zip(gb.graph_chunks, want):
        np.testing.assert_array_equal(got.numpy(), ref)


def test_hierarchy_levels_carry_the_unpool_plan():
    _, aux = next(iter(Loader([_sample()], 1, num_scales=3,
                              hierarchy_mode="bistride", align_edges=True,
                              device="cpu")))
    for lv in aux["hierarchy"]:
        f2c = lv.fine_to_coarse.numpy()
        perm, chunk, node = lv.unpool_chunks
        for got, ref in zip((perm, chunk, node),
                            padded.chunk_plan(f2c, lv.num_coarse_nodes_pad)):
            np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(perm.numpy(),
                                      lv.node_pool_perm.numpy())


def _assert_sort(perm, srt, ids, valid=None, sink=None):
    """Each shard's (perm, sorted) is the stable sort of its ids, masked
    rows keyed ``sink``."""
    ids = np.asarray(ids).reshape(ids.shape[0], -1)
    if valid is not None:
        ids = np.where(np.asarray(valid).reshape(ids.shape), ids, sink)
    for p in range(ids.shape[0]):
        ref_perm, ref_sorted = _stable(ids[p])
        np.testing.assert_array_equal(perm[p], ref_perm)
        np.testing.assert_array_equal(srt[p], ref_sorted)
    assert perm.dtype == srt.dtype == np.int32


def _kw(s):
    return dict(senders=s.senders, receivers=s.receivers, x=s.x,
                edge_attr=s.edge_attr, pos=s.pos, y=s.y)


@pytest.mark.parametrize("align", [False, True])
def test_halo_split_orders(align):
    hg = HL.partition_graph_halo_split(**_kw(_sample()), num_parts=2,
                                       align_interior=align)
    _assert_sort(hg.sender_perm_bnd, hg.senders_bnd_sorted, hg.senders_bnd)
    _assert_sort(hg.send_perm, hg.send_sorted, hg.send_idx)
    hs = HL.partition_graph_halo(**_kw(_sample()), num_parts=2)
    _assert_sort(hs.send_perm, hs.send_sorted, hs.send_idx)


def test_bsms_spatial_orders():
    s = _sample()
    bg = BS.partition_bsms(**_kw(s), num_parts=2, num_scales=3,
                           mode="bistride", align_interior=True)
    _assert_sort(bg.f2c_order.perm, bg.f2c_order.ids, bg.fine_to_coarse)
    ec1 = bg.coarse_edge_mask[0].shape[0]
    _assert_sort(bg.e2c_order.perm, bg.e2c_order.ids, bg.edge_to_coarse,
                 bg.fine.edge_mask > 0, ec1)
    for sorts, tables in ((bg.coarse_sender_sort, bg.coarse_senders),
                          (bg.coarse_f2c_sort, bg.coarse_f2c),
                          (bg.coarse_e2c_sort, bg.coarse_e2c)):
        assert len(sorts) == len(tables)
        for (perm, srt), ids in zip(sorts, tables):
            _assert_sort(perm[None], srt[None], ids[None])


def test_bsms_halo_transfer_orders():
    s = _sample()
    bg = BS.partition_bsms_halo(
        **dict(_kw(s), senders=s.senders.astype(np.int64),
               receivers=s.receivers.astype(np.int64)),
        num_parts=2, num_scales=3, mode="bistride", align_interior=True)
    for k, lvl in enumerate(bg.levels[:-1]):
        plan, nxt = lvl.plan, bg.levels[k + 1].graph
        p_ = plan.node_recv_rows.shape[1]
        node_space = (nxt.node_mask.shape[1]
                      + p_ * plan.node_recv_rows.shape[2])
        edge_space = (nxt.edge_mask_int.shape[1] + nxt.edge_mask_bnd.shape[1]
                      + p_ * plan.edge_recv_rows.shape[2])
        orders = {"node_slot_order": (plan.node_slot,
                                      lvl.graph.node_mask > 0, node_space),
                  "edge_slot_int_order": (plan.edge_slot_int,
                                          lvl.graph.edge_mask_int > 0,
                                          edge_space),
                  "edge_slot_bnd_order": (plan.edge_slot_bnd,
                                          lvl.graph.edge_mask_bnd > 0,
                                          edge_space),
                  "node_recv_order": (plan.node_recv_rows, None, None),
                  "edge_recv_order": (plan.edge_recv_rows, None, None),
                  "up_send_order": (plan.up_send_rows, None, None),
                  "up_fetch_order": (plan.up_fetch, None, None)}
        for name, (ids, valid, sink) in orders.items():
            order = getattr(plan, name)
            assert isinstance(order, SortOrder), name
            _assert_sort(order.perm, order.ids, ids, valid, sink)
        _assert_sort(lvl.graph.sender_perm_bnd, lvl.graph.senders_bnd_sorted,
                     lvl.graph.senders_bnd)


# ---------------------------------------------------------------------------
# no sum in the atomics' order on the cuda backend
# ---------------------------------------------------------------------------

def _step_sums(cfg, graph, **apply_kw):
    """(atomic ops found, K5 calls) of a forward without grad and one
    forward + backward of the masked MSE on the cuda backend."""
    params = cfg.init(0, device="cpu")
    with tops.use_backend("cuda"), R.AtomicSums() as rec:
        with torch.no_grad():
            cfg.apply(params, graph, **apply_kw)
        TL.masked_mse(cfg.apply(params, graph, **apply_kw), graph.y,
                      graph.node_mask).backward()
    return rec.found, rec.k5


@pytest.mark.parametrize("kind", ["mgn", "mgn_unfused", "fouriermgn",
                                  "poolmgn_mean", "poolmgn_add",
                                  "poolmgn_max", "mgn_v2", "mlpnet"])
@pytest.mark.parametrize("align", [True, False])
def test_models_sum_in_a_fixed_order(kind, align):
    """Every registry kind through a two-mesh Loader batch (a pad graph and
    the pad-sink tail), aligned or not: no atomic sum outside K5."""
    mc = (dict(MODELS["mgn"], do_concat_trick=True) if kind == "mgn"
          else MODELS["mgn" if kind == "mgn_unfused" else kind])
    cfg = TR.build_model(dict(mc, remat=False), DIMS)
    graph, _ = next(iter(Loader([_sample(250, 2), _sample(250, 3)], 2,
                                align_edges=align, device="cpu")))
    found, k5 = _step_sums(cfg, graph)
    assert found == []
    assert (k5 > 0) == (kind != "mlpnet")


@pytest.mark.parametrize("switch", [{}, {"AERO_GNN_SORTED_POOL": "1"},
                                    {"AERO_GNN_WEC_FUSED": "0"}])
@pytest.mark.parametrize("transfer,align", [("weighted", True),
                                            ("weighted", False),
                                            ("mean", True)])
def test_bsms_sums_in_a_fixed_order(monkeypatch, switch, transfer, align):
    """The flagship-shaped BSMS (3 bistride scales, WEC or mean transfer)
    under each transfer switch: the pools, the unpool's backward and the
    WEC's sums on K5 (or K7), none in the atomics' order."""
    for k in _SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in switch.items():
        monkeypatch.setenv(k, v)
    graph, aux = next(iter(Loader([_sample()], 1, num_scales=3,
                                  hierarchy_mode="bistride",
                                  align_edges=align, device="cpu")))
    cfg = BSMSConfig(**dict(BSMS, transfer=transfer))
    found, k5 = _step_sums(cfg, graph, hierarchy=aux["hierarchy"])
    assert found == [] and k5 > 0


def test_the_torch_backend_stays_the_plain_reference():
    """The recorder sees the plain sums of the torch backend (the
    reference): the BSMS pools' and the gathers' index_add."""
    graph, aux = next(iter(Loader([_sample()], 1, num_scales=3,
                                  hierarchy_mode="bistride",
                                  align_edges=True, device="cpu")))
    cfg = BSMSConfig(**BSMS)
    params = cfg.init(0, device="cpu")
    with tops.use_backend("torch"), R.AtomicSums() as rec:
        TL.masked_mse(cfg.apply(params, graph, hierarchy=aux["hierarchy"]),
                      graph.y, graph.node_mask).backward()
    assert "index_add" in rec.found and rec.k5 == 0


# name: (scheme, kind, config, partition kwargs)
SHARDED = {
    "halo_split_aligned": ("halo_split", "mgn", MGN,
                           {"align_interior": True}),
    "halo_split": ("halo_split", "mgn", MGN, {}),
    "halo_split_unfused": ("halo_split", "mgn",
                           dict(MGN, do_concat_trick=False), {}),
    "halo": ("halo", "mgn", MGN, {}),
    "spatial_aligned": ("spatial", "mgn", MGN, {"align_interior": True}),
    "spatial_unfused": ("spatial", "mgn", dict(MGN, do_concat_trick=False),
                        {}),
    "bsms_halo_weighted": ("bsms_halo", "bsms", BSMS,
                           {"num_scales": 3, "mode": "bistride",
                            "align_interior": True}),
    "bsms_halo_mean": ("bsms_halo", "bsms", dict(BSMS, transfer="mean"),
                       {"num_scales": 3, "mode": "bistride"}),
    "bsms_spatial": ("bsms_spatial", "bsms", dict(BSMS, transfer="mean"),
                     {"num_scales": 3, "mode": "bistride",
                      "align_interior": True}),
}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every SHARDED case in one set of two gloo ranks."""
    return R.run_ranks(R.order_program, 2, tmp_path_factory.mktemp("order"),
                       SHARDED)


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_schemes_sum_in_a_fixed_order(sharded, name):
    """Each rank's forward and training step at P = 2: every sum on K5
    (the halo-split boundary chain, the exchange's send gather, the BSMS
    transfers), none in the atomics' order."""
    for found, k5 in (r[name] for r in sharded):
        assert found == [] and k5 > 0


# ---------------------------------------------------------------------------
# the chunked per-graph pools against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["mean", "add", "max"])
def test_chunked_graph_pool_matches_jax(method):
    """graph_pool then graph_broadcast on the cuda backend (K5 through the
    chunk plan, plain versions here) against the JAX package's ops, values
    and the VJP, over three graphs of which one holds most rows, and the
    pad rows of the last."""
    rng = np.random.default_rng(11)
    ng = np.r_[np.zeros(40), np.ones(1500), np.full(60, 2),
               np.full(100, 3)].astype(np.int32)
    mask = (np.arange(len(ng)) < 1600).astype(np.float32)
    x = rng.standard_normal((len(ng), 8)).astype(np.float32)
    ct = rng.standard_normal((len(ng), 8)).astype(np.float32)

    def jfn(v):
        pooled = jops.graph_pool(v, jnp.asarray(ng), 4, method=method,
                                 node_mask=jnp.asarray(mask))
        return jops.graph_broadcast(pooled, jnp.asarray(ng))

    jout, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(ct))
    chunks = tuple(torch.from_numpy(a) for a in padded.chunk_plan(ng, 4))
    xt = torch.from_numpy(x).requires_grad_(True)
    tng = torch.from_numpy(ng)
    with tops.use_backend("cuda"), R.AtomicSums() as rec:
        pooled = tops.graph_pool(xt, tng, 4, method=method,
                                 node_mask=torch.from_numpy(mask),
                                 chunks=chunks)
        out = tops.graph_broadcast(pooled, tng, chunks=chunks)
        out.backward(torch.from_numpy(ct))
    assert rec.found == [] and rec.k5 == 2 * (method != "max") + 2
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-3, atol=1e-5)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("kind", ["poolmgn_mean", "poolmgn_add", "mgn_v2"])
def test_pooled_models_first_step_grads_match_jax(kind):
    """poolMGN and MGNv2 on the cuda backend (the chunked pools, K5's
    plain versions) through the two-mesh Loader batch: the loss and the
    first-step gradients against jax.value_and_grad. (poolMGN's 'max' is
    left out: its pad graph's finfo.min rows overflow to NaN in the port's
    pad rows on either backend, and the masked loss with them, a known
    divergence recorded in ROADMAP.md.)"""
    jb, tb, _ = loader_batches()
    jcfg, tree, tcfg, params = build_pair(MODELS[kind])

    def loss_fn(p):
        return JL.masked_mse(jcfg.apply(p, jb), jb.y, jb.node_mask)

    jloss, jgrads = jax.value_and_grad(loss_fn)(tree)
    with tops.use_backend("cuda"):
        loss = TL.masked_mse(tcfg.apply(params, tb), tb.y, tb.node_mask)
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    tgrads = _leaves(params_to_jax(params, tcfg, grads=True))
    jgrads = _leaves(jgrads)
    assert tgrads.keys() == jgrads.keys()
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], g, rtol=1e-3,
                                   atol=1e-5 * np.abs(g).max(initial=1e-30),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# compute_errors, local_device_count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["random", "zeros", "mixed"])
def test_compute_errors_matches_jax(target):
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((50, 4)).astype(np.float32)
    tgt = {"random": rng.standard_normal((50, 4)),
           "zeros": np.zeros((50, 4)),
           "mixed": np.where(rng.random((50, 4)) < 0.5, 0.0,
                             rng.standard_normal((50, 4)))}[target]
    tgt = tgt.astype(np.float32)
    got, ref = TM.compute_errors(pred, tgt), JM.compute_errors(pred, tgt)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert (np.isnan(got[k]) and np.isnan(v)) or got[k] == v, k
    assert np.isnan(got["relative_mae"]) == (target == "zeros")


def test_local_device_count_on_the_cpu():
    """Without a card the port counts the CPU, one device, as JAX counts
    its default CPU backend (run without the suite's virtual devices)."""
    assert not torch.cuda.is_available()
    assert PM.local_device_count() == 1
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "from aero_gnn_tpu.parallel.mesh import local_device_count; "
         "print(local_device_count())"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert int(out.stdout.strip().splitlines()[-1]) == 1
