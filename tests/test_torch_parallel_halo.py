"""The port's sharded MGN paths (parallel.spatial, parallel.halo) in two
gloo ranks on the CPU against the JAX package's shard_map programs at the
same P on the conftest's virtual CPU devices: forwards within rtol 2e-4 /
atol 2e-5 (fp32), one step's gradients within 1e-3 max|g| + 1e-3 |g| of
JAX's single-device gradients, three Adam losses within rtol 1e-4, the
replicas' parameters bit-equal, the loss's local numerator, and the
kernel wrappers' calls per rank on the aligned interior. A 480-node mesh,
2 layers at width 16, 2 hidden layers per MLP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parallel_ranks as R
from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data.synthetic import make_random_mesh_sample
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.models.fouriermgn import FourierMGNConfig as JFourier
from aero_gnn_tpu.models.mgn import MGNConfig as JMGN
from aero_gnn_tpu.models.poolmgn import PoolMGNConfig as JPool
from aero_gnn_tpu.parallel import halo as JH
from aero_gnn_tpu.parallel import spatial as JS
from aero_gnn_tpu.parallel.mesh import make_mesh as jax_mesh
from aero_gnn_tpu.training.loop import make_optimizer as jax_adam
from aero_gnn_tpu.training.loop import masked_mse as jax_mse

P = 2
H = 16
N_NODES, SEED = 480, 4
LAYERS = 2
SMALL = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
             processor_size=LAYERS, hidden_dim_processor=H,
             hidden_dim_node_encoder=H, hidden_dim_edge_encoder=H,
             hidden_dim_decoder=H, num_hidden_layers_node_processor=2,
             num_hidden_layers_edge_processor=2, do_concat_trick=True)
JAX_CFG = {"mgn": JMGN, "fouriermgn": JFourier, "poolmgn": JPool}
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
STEPS = 3

# name: (scheme, kind, extra config, partition kwargs, Adam steps)
CASES = {
    "halo_split": ("halo_split", "mgn", {}, {}, STEPS),
    "halo_split_aligned": ("halo_split", "mgn", {},
                           {"align_interior": True}, STEPS),
    "halo_split_unfused": ("halo_split", "mgn",
                           {"do_concat_trick": False}, {}, 1),
    "halo": ("halo", "mgn", {}, {}, 2),
    "spatial": ("spatial", "mgn", {}, {}, 2),
    "spatial_aligned": ("spatial", "mgn", {}, {"align_interior": True}, 1),
    "spatial_unfused": ("spatial", "mgn", {"do_concat_trick": False}, {},
                        0),
    "fouriermgn": ("model", "fouriermgn", {}, {}, 0),
    "poolmgn_mean": ("model", "poolmgn", {"global_pool_method": "mean"}, {},
                     0),
    "poolmgn_max": ("model", "poolmgn", {"global_pool_method": "max"}, {},
                    0),
}
STEP_CASES = [n for n, c in CASES.items() if c[4]]


def _sample():
    s = make_random_mesh_sample(n_nodes=N_NODES, seed=SEED)
    JD.compute_features([s], ["mach", "alpha"])
    return s


def _cfg(name):
    _, kind, extra, _, _ = CASES[name]
    return kind, dict(SMALL, **extra)


def _tree(name):
    kind, kw = _cfg(name)
    tree = JAX_CFG[kind](**kw).init(jax.random.PRNGKey(7))
    return jax.tree.map(np.asarray, tree)


def _jax_partition(scheme, s, parts, part_kw):
    fn = {"spatial": JS.partition_graph, "model": JS.partition_graph,
          "halo": JH.partition_graph_halo,
          "halo_split": JH.partition_graph_halo_split}[scheme]
    return fn(senders=s.senders, receivers=s.receivers, x=s.x,
              edge_attr=s.edge_attr, pos=s.pos, y=s.y, num_parts=parts,
              **part_kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in one set of two ranks: {name: [rank 0, rank 1]}."""
    specs = {}
    for name, (scheme, kind, extra, part, steps) in CASES.items():
        specs[name] = dict(scheme=scheme, kind=kind, cfg=_cfg(name)[1],
                           tree=_tree(name), mesh=(1, P),
                           samples=[(N_NODES, SEED)], part=part,
                           steps=steps,
                           count=name == "halo_split_aligned")
    specs["psum_numerator"] = dict(specs["halo_split"], steps=1,
                                   psum_numerator=True)
    out = R.run_ranks(R.multi_program, P, tmp_path_factory.mktemp("halo"),
                      specs)
    return {name: [o[name] for o in out] for name in specs}


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_ground_truth(name):
    """(loss, gradient leaves) of JAX's single-device full-batch loss."""
    kind, kw = _cfg(name)
    cfg = JAX_CFG[kind](**kw)
    s = _sample()
    gb = JP.build_graph_batch(senders=s.senders, receivers=s.receivers,
                              x=s.x, edge_attr=s.edge_attr, pos=s.pos,
                              y=s.y)
    loss, grads = jax.value_and_grad(
        lambda p: jax_mse(cfg.apply(p, gb), gb.y, gb.node_mask))(
            jax.tree.map(jnp.asarray, _tree(name)))
    return float(loss), _leaves(grads)


def _close_grads(port_tree, jax_leaves):
    """Names of the gradients outside 1e-3 max|g| + 1e-3 |g|."""
    got = _leaves(port_tree)
    assert got.keys() == jax_leaves.keys()
    bad = []
    for k, ref in jax_leaves.items():
        tol = 1e-3 * np.abs(ref).max(initial=0.0) + 1e-3 * np.abs(ref)
        if not (np.abs(got[k] - ref) <= tol).all():
            bad.append(k)
    return bad


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(runs, name):
    scheme, kind, _, part, _ = CASES[name]
    cfg = JAX_CFG[kind](**_cfg(name)[1])
    s = _sample()
    sg = _jax_partition(scheme, s, P, part)
    mesh = jax_mesh(data=1, graph=P, devices=jax.devices()[:P])
    make = {"spatial": JS.make_spatial_forward,
            "model": JS.make_spatial_forward,
            "halo": JH.make_halo_forward,
            "halo_split": JH.make_halo_split_forward}[scheme]
    ref = np.asarray(make(cfg, mesh)(jax.tree.map(jnp.asarray, _tree(name)),
                                     sg))
    got = np.stack([r["forward"] for r in runs[name]])
    real = np.asarray(sg.node_mask) > 0
    np.testing.assert_allclose(got[real], ref[real], **FWD_TOL)


@pytest.mark.parametrize("name", STEP_CASES)
def test_step_grads_match_jax_single_device(runs, name):
    """The summed per-shard gradients of the first step equal JAX's
    single-device full-batch gradient; the step's loss is the global
    loss."""
    loss, ref = _jax_ground_truth(name)
    for r in runs[name]:
        np.testing.assert_allclose(r["losses"][0], loss, rtol=1e-5)
        assert not _close_grads(r["grads"], ref)


@pytest.mark.parametrize("name", STEP_CASES)
def test_adam_losses_match_jax(runs, name):
    """JAX's sharded step (make_*_train_step, Adam 1e-3) at P = 2 gives
    the same losses, and the replicas stay bit-equal."""
    scheme, kind, _, part, steps = CASES[name]
    cfg = JAX_CFG[kind](**_cfg(name)[1])
    sg = _jax_partition(scheme, _sample(), P, part)
    mesh = jax_mesh(data=1, graph=P, devices=jax.devices()[:P])
    make = {"spatial": JS.make_spatial_train_step,
            "halo": JH.make_halo_train_step,
            "halo_split": JH.make_halo_split_train_step}[scheme]
    opt = jax_adam(1e-3)
    params = jax.tree.map(jnp.asarray, _tree(name))
    ost = opt.init(params)
    step = make(cfg, opt, mesh)
    losses = []
    for _ in range(steps):
        params, ost, loss = step(params, ost, sg)
        losses.append(float(np.asarray(loss).ravel()[0]))
    r0, r1 = runs[name]
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-4)
    assert r0["losses"] == r1["losses"]
    for a, b in zip(r0["params"], r1["params"]):
        np.testing.assert_array_equal(a, b)


def test_psum_numerator_fails_ground_truth(runs):
    """A loss whose numerator is summed across ranks inside the
    differentiated function seeds each rank's backward with the sum of the
    seeds: its gradients are P times too large, and the ground-truth
    comparison must catch it (the local numerator passes it above)."""
    _, ref = _jax_ground_truth("halo_split")
    for r in runs["psum_numerator"]:
        bad = _close_grads(r["grads"], ref)
        assert len(bad) == len(ref)
        k = next(iter(ref))
        np.testing.assert_allclose(_leaves(r["grads"])[k], P * ref[k],
                                   rtol=1e-3, atol=1e-3 * np.abs(
                                       ref[k]).max())


def test_kernel_calls_per_rank(runs):
    """On the aligned interior every rank's forward calls K1 and K3 once a
    layer, and K5 once a layer for the boundary chain's masked sum; a step
    K1-K4 once a layer and K5 five times a layer (the boundary sum, the
    backward of the interior sender gather, of the send gather, of the
    halo-table gather and of the boundary receiver gather); nothing else.
    On the card these are the launches (chip_smoke.py phase parallel holds
    them)."""
    fwd = {k: 0 for k, _, _ in R.COUNTED}
    fwd.update(fused_edge_fwd=LAYERS, fused_node_fwd=LAYERS,
               segment_sum=LAYERS)
    step = {k: 0 for k, _, _ in R.COUNTED}
    step.update({k: LAYERS for k in ("fused_edge_fwd", "fused_edge_bwd",
                                     "fused_node_fwd", "fused_node_bwd")},
                segment_sum=5 * LAYERS)
    for r in runs["halo_split_aligned"]:
        assert r["forward_counts"] == fwd
        assert r["step_counts"] == step


def test_fused_interior_p1_matches_jax_pallas_interpret():
    """P = 1 (no process group: the exchange is the identity) on the
    aligned interior against JAX's fused interior in interpret mode, at the
    smallest size (tests/test_parallel.py:540)."""
    from aero_gnn_tpu_torch.models.convert import params_from_jax
    from aero_gnn_tpu_torch.models.mgn import MGNConfig
    from aero_gnn_tpu_torch.parallel import halo as TH
    from aero_gnn_tpu_torch.parallel import mesh as TM

    kw = dict(SMALL, processor_size=1)
    jcfg = JMGN(**kw)
    tree = jcfg.init(jax.random.PRNGKey(31))
    s = make_random_mesh_sample(n_nodes=300, seed=31)
    JD.compute_features([s], ["mach", "alpha"])
    part = dict(senders=s.senders, receivers=s.receivers, x=s.x,
                edge_attr=s.edge_attr, pos=s.pos, y=s.y, num_parts=1,
                align_interior=True)
    sg = JH.partition_graph_halo_split(**part)
    mesh = jax_mesh(data=1, graph=1, devices=jax.devices()[:1])
    with jops.use_backend("pallas"), pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JH.make_halo_split_forward(jcfg, mesh)(tree, sg))
    cfg = MGNConfig(**kw)
    params = params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                             device="cpu")
    tsg = TH.partition_graph_halo_split(**part)
    sh = tsg.shard(0, "cpu")
    assert TH.fused_interior(cfg.layer_cfg, torch.zeros(
        tsg.nodes_per_part, H), sh)
    got = TH.make_halo_split_forward(cfg, TM.make_mesh(data=1, graph=1))(
        params, sh).numpy()
    real = np.asarray(sg.node_mask[0]) > 0
    np.testing.assert_allclose(got[real], ref[0][real], rtol=3e-4,
                               atol=3e-4)
