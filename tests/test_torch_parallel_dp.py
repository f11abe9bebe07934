"""The port's data-parallel and hybrid steps in gloo ranks on the CPU (2
ranks, and 2 x 2 for hybrid) against the JAX package, the collectives'
backward against central differences, and the distributed checkpoint's
save and restore in fresh ranks. Gradients within 1e-3 max|g| + 1e-3 |g|
of the mean of JAX's single-device gradients, Adam losses within rtol 1e-4
of JAX's shard_map steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as R
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data.synthetic import make_random_mesh_sample
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.models.mgn import MGNConfig as JMGN
from aero_gnn_tpu.parallel import data_parallel as JDP
from aero_gnn_tpu.parallel import halo as JH
from aero_gnn_tpu.parallel import hybrid as JHY
from aero_gnn_tpu.parallel.mesh import make_mesh as jax_mesh
from aero_gnn_tpu.training.loop import make_optimizer as jax_adam
from aero_gnn_tpu.training.loop import masked_mse as jax_mse

H = 16
SMALL = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
             processor_size=2, hidden_dim_processor=H,
             hidden_dim_node_encoder=H, hidden_dim_edge_encoder=H,
             hidden_dim_decoder=H, num_hidden_layers_node_processor=2,
             num_hidden_layers_edge_processor=2, do_concat_trick=True)
DP_SAMPLES = [(300, 0), (300, 1)]
DP_PAD = (384, 2048)
HYBRID_SAMPLES = [(256, 20), (256, 21)]
STEPS = 3


def _sample(n, seed):
    s = make_random_mesh_sample(n_nodes=n, seed=seed)
    JD.compute_features([s], ["mach", "alpha"])
    return s


def _tree(seed=7):
    return jax.tree.map(np.asarray, JMGN(**SMALL).init(
        jax.random.PRNGKey(seed)))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(n, seed, pad=None):
    s = _sample(n, seed)
    kw = {} if pad is None else dict(num_nodes_pad=pad[0],
                                     num_edges_pad=pad[1])
    return JP.build_graph_batch(senders=s.senders, receivers=s.receivers,
                                x=s.x, edge_attr=s.edge_attr, pos=s.pos,
                                y=s.y, **kw)


def _mean_ground_truth(samples, pad=None):
    """(mean loss, gradient leaves of the mean loss) over the samples,
    each on one device."""
    cfg = JMGN(**SMALL)
    gbs = [_batch(n, seed, pad) for n, seed in samples]

    def loss(p):
        return jnp.mean(jnp.stack([jax_mse(cfg.apply(p, g), g.y,
                                           g.node_mask) for g in gbs]))

    value, grads = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray,
                                                         _tree()))
    return float(value), _leaves(grads)


def _assert_grads(port_tree, ref):
    got = _leaves(port_tree)
    assert got.keys() == ref.keys()
    for k, g in ref.items():
        tol = 1e-3 * np.abs(g).max(initial=0.0) + 1e-3 * np.abs(g)
        assert (np.abs(got[k] - g) <= tol).all(), k


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    spec = dict(kind="mgn", cfg=SMALL, tree=_tree(), samples=DP_SAMPLES,
                pad=DP_PAD, steps=STEPS, dropout_seed=3)
    return R.run_ranks(R.dp_and_collectives_program, 2,
                       tmp_path_factory.mktemp("dp"), spec)


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    probe = [JH.partition_graph_halo_split(
        senders=s.senders, receivers=s.receivers, x=s.x,
        edge_attr=s.edge_attr, pos=s.pos, y=s.y, num_parts=2,
        edges_pad_multiple=32) for s in (_sample(*a) for a in
                                         HYBRID_SAMPLES)]
    common = dict(
        edges_pad_multiple=32,
        halo_rows=max(p.halo_size for p in probe),
        edges_int_rows=max(p.edge_attr_int.shape[1] for p in probe),
        edges_bnd_rows=max(p.edge_attr_bnd.shape[1] for p in probe))
    base = dict(kind="mgn", cfg=SMALL, tree=_tree(), mesh=(2, 2),
                samples=HYBRID_SAMPLES, steps=STEPS)
    specs = {"halo_split": dict(base, scheme="halo_split", part=common),
             "spatial": dict(base, scheme="spatial", part={}, steps=1)}
    out = R.run_ranks(R.multi_program, 4, tmp_path_factory.mktemp("hy"),
                      specs)
    return {name: [o[name] for o in out] for name in specs}, common


def test_dp_grads_are_the_mean_of_single_device_grads(dp):
    loss, ref = _mean_ground_truth(DP_SAMPLES, DP_PAD)
    for r in dp:
        np.testing.assert_allclose(r["dp"]["losses"][0], loss, rtol=1e-5)
        np.testing.assert_allclose(r["dp"]["eval"], loss, rtol=1e-5)
        _assert_grads(r["dp"]["grads"], ref)


def test_dp_adam_losses_match_jax_dp_step(dp):
    cfg = JMGN(**SMALL)
    opt = jax_adam(1e-3)
    params = jax.tree.map(jnp.asarray, _tree())
    ost = opt.init(params)
    mesh = jax_mesh(data=2, graph=1, devices=jax.devices()[:2])
    stacked = JDP.stack_batches([_batch(n, s, DP_PAD)
                                 for n, s in DP_SAMPLES])
    step = JDP.make_dp_train_step(cfg, opt, mesh)
    losses = []
    for _ in range(STEPS):
        params, ost, loss = step(params, ost, stacked, None,
                                 jax.random.PRNGKey(0))
        losses.append(float(loss))
    np.testing.assert_allclose(dp[0]["dp"]["losses"], losses, rtol=1e-4)
    assert dp[0]["dp"]["losses"] == dp[1]["dp"]["losses"]


def test_dp_dropout_streams_differ_per_rank(dp):
    """Each rank's generator is seeded from (seed, rank), in place of
    JAX's fold_in(rng, axis_index)."""
    a, b = (r["dp"]["draw"] for r in dp)
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("op", ["all_gather_tiled", "all_to_all",
                                "all_reduce_sum"])
def test_collective_backward_matches_central_differences(dp, op):
    checked = [(g, n) for r in dp for name, g, n in r["collectives"]
               if name == op]
    assert len(checked) == 4
    for g, n in checked:
        np.testing.assert_allclose(g, n, rtol=1e-6, atol=1e-8)


def test_hybrid_halo_split_grads_and_losses(hybrid):
    """2 meshes x 2 shards: the first step's gradients are the mean of the
    two meshes' single-device gradients; the Adam losses equal JAX's
    make_hybrid_halo_split_train_step on a 2 x 2 mesh; all four replicas
    bit-equal."""
    runs, common = hybrid
    loss, ref = _mean_ground_truth(HYBRID_SAMPLES)
    for r in runs["halo_split"]:
        np.testing.assert_allclose(r["losses"][0], loss, rtol=1e-5)
        _assert_grads(r["grads"], ref)
    cfg = JMGN(**SMALL)
    opt = jax_adam(1e-3)
    params = jax.tree.map(jnp.asarray, _tree())
    ost = opt.init(params)
    stacked = JHY.stack_halo_split([JH.partition_graph_halo_split(
        senders=s.senders, receivers=s.receivers, x=s.x,
        edge_attr=s.edge_attr, pos=s.pos, y=s.y, num_parts=2, **common)
        for s in (_sample(*a) for a in HYBRID_SAMPLES)])
    step = JHY.make_hybrid_halo_split_train_step(
        cfg, opt, jax_mesh(data=2, graph=2, devices=jax.devices()[:4]))
    losses = []
    for _ in range(STEPS):
        params, ost, value = step(params, ost, stacked)
        losses.append(float(value))
    np.testing.assert_allclose(runs["halo_split"][0]["losses"], losses,
                               rtol=1e-4)
    first = runs["halo_split"][0]["params"]
    for r in runs["halo_split"][1:]:
        for a, b in zip(first, r["params"]):
            np.testing.assert_array_equal(a, b)


def test_hybrid_spatial_grads(hybrid):
    """make_hybrid_train_step (the all_gather exchange): the same
    ground truth."""
    runs, _ = hybrid
    loss, ref = _mean_ground_truth(HYBRID_SAMPLES)
    for r in runs["spatial"]:
        np.testing.assert_allclose(r["losses"][0], loss, rtol=1e-5)
        _assert_grads(r["grads"], ref)


def test_dcp_checkpoint_round_trip(tmp_path):
    """Two ranks train the halo-split MGN 3 steps, saving each (async,
    max_to_keep 2); two fresh ranks restore the newest: parameters and
    Adam state bit-equal, the epoch and history back."""
    spec = dict(cfg=SMALL, tree=_tree(), dir=str(tmp_path / "ckpt"),
                sample=(300, 2))
    saved = R.run_ranks(R.checkpoint_program, 2, tmp_path,
                        dict(spec, mode="save"))
    fresh = dict(spec, mode="restore", tree=_tree(seed=8))
    restored = R.run_ranks(R.checkpoint_program, 2, tmp_path, fresh)
    for s, r in zip(saved, restored):
        assert s["steps"] == [1, 2]
        assert r["restored"] == (2, {"epoch": [2]})
        for a, b in zip(s["params"], r["params"]):
            np.testing.assert_array_equal(a, b)
        assert len(s["adam"]) == len(r["adam"]) > 0
        for (sa, ma, va), (sb, mb, vb) in zip(s["adam"], r["adam"]):
            assert sa == sb == 3.0
            np.testing.assert_array_equal(ma, mb)
            np.testing.assert_array_equal(va, vb)
