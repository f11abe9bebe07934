"""The port's spatially partitioned BSMS (parallel.bsms_spatial) in two
gloo ranks on the CPU against the JAX package at P = 2: the all_gather
baseline (replicated coarse levels) and the flagship halo scheme (every
level a split halo shard, owner-routed transfers), "mean" and "weighted"
(WeightedEdgeConv) transfers, and the aligned interior. Forwards within
rtol 2e-4 / atol 2e-5 of JAX's shard_map forwards, one step's gradients
within 1e-3 max|g| + 1e-3 |g| of JAX's single-device BSMS gradients, Adam
losses within rtol 1e-4 of JAX's sharded step (the weighted halo
scheme), the replicas bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as R
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data.synthetic import make_random_mesh_sample
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.graph.hierarchy import build_hierarchy
from aero_gnn_tpu.models.bsms import BSMSConfig as JBSMS
from aero_gnn_tpu.parallel import bsms_spatial as JB
from aero_gnn_tpu.parallel.mesh import make_mesh as jax_mesh
from aero_gnn_tpu.training.loop import make_optimizer as jax_adam
from aero_gnn_tpu.training.loop import masked_mse as jax_mse

P = 2
H = 16
N_NODES, SEED = 480, 41
STEPS = 2
BASE = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
            processor_size=2, hidden_dim_processor=H,
            hidden_dim_node_encoder=H, hidden_dim_edge_encoder=H,
            hidden_dim_decoder=H, num_hidden_layers_node_processor=2,
            num_hidden_layers_edge_processor=2, do_concat_trick=True,
            aggregation="add", num_scales=3, layers_per_scale=1, stride=2)
# name: (scheme, hierarchy mode, transfer, align_interior)
CASES = {
    "spatial_stride_mean": ("bsms_spatial", "stride", "mean", False),
    "halo_stride_mean": ("bsms_halo", "stride", "mean", False),
    "halo_bistride_weighted": ("bsms_halo", "bistride", "weighted", False),
    "halo_bistride_weighted_aligned": ("bsms_halo", "bistride", "weighted",
                                       True),
}


def _sample():
    s = make_random_mesh_sample(n_nodes=N_NODES, seed=SEED)
    JD.compute_features([s], ["mach", "alpha"])
    return s


def _cfg_kw(name):
    _, mode, transfer, _ = CASES[name]
    return dict(BASE, hierarchy_mode=mode, transfer=transfer)


def _tree(name):
    return jax.tree.map(np.asarray, JBSMS(**_cfg_kw(name)).init(
        jax.random.PRNGKey(41)))


def _part_kw(name):
    _, mode, _, align = CASES[name]
    kw = dict(num_scales=3, mode=mode, stride=2)
    if align:
        kw["align_interior"] = True
    return kw


def _jax_partition(name):
    s = _sample()
    scheme = CASES[name][0]
    kw = dict(senders=s.senders, receivers=s.receivers, x=s.x,
              edge_attr=s.edge_attr, pos=s.pos, y=s.y, num_parts=P,
              **_part_kw(name))
    if scheme == "bsms_halo":
        kw.update(senders=np.asarray(s.senders, np.int64),
                  receivers=np.asarray(s.receivers, np.int64))
        return JB.partition_bsms_halo(**kw)
    return JB.partition_bsms(**kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    specs = {name: dict(scheme=c[0], kind="bsms", cfg=_cfg_kw(name),
                        tree=_tree(name), mesh=(1, P),
                        samples=[(N_NODES, SEED)], part=_part_kw(name),
                        steps=STEPS, count=c[3])
             for name, c in CASES.items()}
    out = R.run_ranks(R.multi_program, P, tmp_path_factory.mktemp("bsms"),
                      specs)
    return {name: [o[name] for o in out] for name in specs}


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(runs, name):
    cfg = JBSMS(**_cfg_kw(name))
    bg = _jax_partition(name)
    mesh = jax_mesh(data=1, graph=P, devices=jax.devices()[:P])
    make = (JB.make_bsms_halo_forward if CASES[name][0] == "bsms_halo"
            else JB.make_bsms_spatial_forward)
    ref = np.asarray(make(cfg, mesh)(jax.tree.map(jnp.asarray, _tree(name)),
                                     bg))
    got = np.stack([r["forward"] for r in runs[name]])
    real = np.asarray(bg.fine.node_mask) > 0
    np.testing.assert_allclose(got[real], ref.reshape(got.shape)[real],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_step_grads_match_jax_single_device(runs, name):
    cfg = JBSMS(**_cfg_kw(name))
    s = _sample()
    gb = JP.build_graph_batch(senders=s.senders, receivers=s.receivers,
                              x=s.x, edge_attr=s.edge_attr, pos=s.pos,
                              y=s.y)
    levels = tuple(build_hierarchy(
        senders=np.asarray(s.senders, np.int64),
        receivers=np.asarray(s.receivers, np.int64),
        node_graph=np.zeros(s.num_nodes, np.int64), num_nodes=s.num_nodes,
        pos=s.pos.astype(np.float64), num_scales=3, mode=CASES[name][1],
        stride=2, num_fine_nodes_pad=gb.num_nodes_pad,
        num_fine_edges_pad=gb.num_edges_pad))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_mse(
        cfg.apply(p, gb, hierarchy=levels), gb.y, gb.node_mask)))(
            jax.tree.map(jnp.asarray, _tree(name)))
    ref = _leaves(grads)
    for r in runs[name]:
        np.testing.assert_allclose(r["losses"][0], float(loss), rtol=1e-5)
        got = _leaves(r["grads"])
        assert got.keys() == ref.keys()
        for k, g in ref.items():
            tol = 1e-3 * np.abs(g).max(initial=0.0) + 1e-3 * np.abs(g)
            assert (np.abs(got[k] - g) <= tol).all(), k
    r0, r1 = runs[name]
    assert r0["losses"] == r1["losses"]
    for a, b in zip(r0["params"], r1["params"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["halo_bistride_weighted"])
def test_adam_losses_match_jax(runs, name):
    """The flagship scheme's Adam losses against JAX's
    make_bsms_halo_train_step (its compile dominates this file's time, so
    one case)."""
    cfg = JBSMS(**_cfg_kw(name))
    bg = _jax_partition(name)
    mesh = jax_mesh(data=1, graph=P, devices=jax.devices()[:P])
    make = (JB.make_bsms_halo_train_step if CASES[name][0] == "bsms_halo"
            else JB.make_bsms_spatial_train_step)
    opt = jax_adam(1e-3)
    params = jax.tree.map(jnp.asarray, _tree(name))
    ost = opt.init(params)
    step = make(cfg, opt, mesh)
    losses = []
    for _ in range(STEPS):
        params, ost, loss = step(params, ost, bg)
        losses.append(float(np.asarray(loss).ravel()[0]))
    np.testing.assert_allclose(runs[name][0]["losses"], losses, rtol=1e-4)


def test_kernel_calls_per_rank_aligned(runs):
    """The aligned weighted scheme: every level's layers on the fused
    interior (K1 / K3 a layer in the forward, K1-K4 a layer in a step) with
    the split layer's K5 (once a layer in the forward, five times in a
    step: tests/test_torch_parallel_halo.py), and K5 for every sum of the
    transfers: 7 a down transfer in the forward (the WEC conv's two sums,
    the node reduction's two, the edge reduction's three), 3 an up transfer
    (the WEC spread's three); a step adds 3 a down transfer (the conv's
    three gathers' backward) and 4 an up transfer (the fetch's two, the
    spread's two). K7 and K6 never (chip_smoke.py phase parallel (e) holds
    the same on the card)."""
    from aero_gnn_tpu_torch.models.bsms import BSMSConfig

    cfg = BSMSConfig(**_cfg_kw("halo_bistride_weighted_aligned"))
    layers = 2 * sum(cfg.down_counts) + cfg.bottleneck_count
    transfers = cfg.num_scales - 1
    fwd = {k: 0 for k, _, _ in R.COUNTED}
    fwd.update(fused_edge_fwd=layers, fused_node_fwd=layers,
               segment_sum=layers + 10 * transfers)
    step = dict(fwd, fused_edge_bwd=layers, fused_node_bwd=layers,
                segment_sum=5 * layers + 17 * transfers)
    for r in runs["halo_bistride_weighted_aligned"]:
        assert r["forward_counts"] == fwd
        assert r["step_counts"] == step
