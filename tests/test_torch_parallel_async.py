"""The overlapped halo exchange (parallel.collectives.all_to_all_start, the
counterpart of the async all-to-all JAX turns on with
AERO_GNN_ASYNC_COLLECTIVES) in two gloo ranks on the CPU, against the same
programs with AERO_GNN_ASYNC_COLLECTIVES=0: the halo-split MGN (fused
interior on the kernels' plain versions, concat trick, unfused; remat on
and off), the halo layer and the BSMS halo scheme. Forwards and first-step
gradients bit-equal between the two settings; the async forwards within
rtol 2e-4 / atol 2e-5 of JAX's shard_map forwards (the bound
test_torch_parallel_halo.py holds); the order of one step's exchanges,
waits and interior kernels; and all_to_all_start's backward against
central differences in float64. A 480-node mesh, 2 layers at width 16, 2
hidden layers per MLP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as R
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data.synthetic import make_random_mesh_sample
from aero_gnn_tpu.models.mgn import MGNConfig as JMGN
from aero_gnn_tpu.parallel import halo as JH
from aero_gnn_tpu.parallel.mesh import make_mesh as jax_mesh

P = 2
H = 16
N_NODES, SEED = 480, 4
LAYERS = 2
MGN = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
           processor_size=LAYERS, hidden_dim_processor=H,
           hidden_dim_node_encoder=H, hidden_dim_edge_encoder=H,
           hidden_dim_decoder=H, num_hidden_layers_node_processor=2,
           num_hidden_layers_edge_processor=2, do_concat_trick=True)
BSMS = dict(MGN, aggregation="add", num_scales=3, layers_per_scale=1,
            stride=2, hierarchy_mode="bistride", transfer="weighted")
FWD_TOL = dict(rtol=2e-4, atol=2e-5)

# name: (scheme, kind, config, partition kwargs)
CASES = {
    "split_fused": ("halo_split", "mgn", MGN, {"align_interior": True}),
    "split_fused_remat_full": ("halo_split", "mgn",
                               dict(MGN, remat_policy="full"),
                               {"align_interior": True}),
    "split_concat": ("halo_split", "mgn", MGN, {}),
    "split_concat_no_remat": ("halo_split", "mgn", dict(MGN, remat=False),
                              {}),
    "split_unfused": ("halo_split", "mgn", dict(MGN, do_concat_trick=False),
                      {}),
    "split_unfused_no_remat": ("halo_split", "mgn",
                               dict(MGN, do_concat_trick=False, remat=False),
                               {}),
    "halo": ("halo", "mgn", MGN, {}),
    "halo_unfused": ("halo", "mgn", dict(MGN, do_concat_trick=False), {}),
    "bsms_halo": ("bsms_halo", "bsms", BSMS,
                  dict(num_scales=3, mode="bistride", stride=2,
                       align_interior=True)),
}
JAX_FORWARD = ("split_fused", "split_concat", "split_unfused")
# the exchange-order runs: (case, one layer's forward, one layer's
# backward); the per-layer "full" remat recomputes the layer's forward at
# the start of its backward
ORDER = {
    "split_fused": (["start", "interior", "wait"],
                    ["start", "interior_bwd", "wait"]),
    "split_fused_remat_full": (["start", "interior", "wait"],
                               ["start", "interior", "wait",
                                "start", "interior_bwd", "wait"]),
}


def _sample():
    s = make_random_mesh_sample(n_nodes=N_NODES, seed=SEED)
    JD.compute_features([s], ["mach", "alpha"])
    return s


def _tree(kind, kw):
    from aero_gnn_tpu.models.bsms import BSMSConfig as JBSMS

    cfg = (JMGN if kind == "mgn" else JBSMS)(**kw)
    return jax.tree.map(np.asarray, cfg.init(jax.random.PRNGKey(7)))


def _spec(name):
    scheme, kind, kw, part = CASES[name]
    return dict(scheme=scheme, kind=kind, cfg=kw, tree=_tree(kind, kw),
                mesh=(1, P), samples=[(N_NODES, SEED)], part=part, steps=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case under both settings, the order runs and the
    central-difference check, in one set of two ranks."""
    spec = {"cases": {name: _spec(name) for name in CASES},
            "order": {name: _spec(name) for name in ORDER}}
    return R.run_ranks(R.async_program, P, tmp_path_factory.mktemp("async"),
                       spec)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", list(CASES))
def test_async_forward_bit_equal_to_sync(runs, name):
    for r in runs:
        run = r["cases"][name]
        np.testing.assert_array_equal(run["1"]["forward"],
                                      run["0"]["forward"])


@pytest.mark.parametrize("name", list(CASES))
def test_async_step_grads_bit_equal_to_sync(runs, name):
    """First-step gradients (summed over the ranks) and the step's loss
    bit-equal: the engine accumulates every parameter's contributions in
    the same order under both settings."""
    for r in runs:
        run = r["cases"][name]
        assert run["1"]["losses"] == run["0"]["losses"]
        sync, asy = _leaves(run["0"]["grads"]), _leaves(run["1"]["grads"])
        assert sync.keys() == asy.keys()
        for k, ref in sync.items():
            np.testing.assert_array_equal(asy[k], ref, err_msg=k)


@pytest.mark.parametrize("name", JAX_FORWARD)
def test_async_forward_matches_jax_shard_map(runs, name):
    _, _, kw, part = CASES[name]
    s = _sample()
    sg = JH.partition_graph_halo_split(
        senders=s.senders, receivers=s.receivers, x=s.x,
        edge_attr=s.edge_attr, pos=s.pos, y=s.y, num_parts=P, **part)
    mesh = jax_mesh(data=1, graph=P, devices=jax.devices()[:P])
    ref = np.asarray(JH.make_halo_split_forward(JMGN(**kw), mesh)(
        jax.tree.map(jnp.asarray, _tree("mgn", kw)), sg))
    got = np.stack([r["cases"][name]["1"]["forward"] for r in runs])
    real = np.asarray(sg.node_mask) > 0
    np.testing.assert_allclose(got[real], ref[real], **FWD_TOL)


@pytest.mark.parametrize("name", list(ORDER))
def test_exchange_overlaps_interior(runs, name):
    """Forward: each layer issues its exchange (async_op=True), runs the
    interior's fused edge layer, then waits. Backward, layer by layer from
    the last: the reverse exchange is started, the interior's backward
    runs, then it is waited for. No exchange is synchronous."""
    fwd, bwd = ORDER[name]
    for r in runs:
        log = r["order"][name]
        cut = log.index("backward")
        assert log[:cut] == fwd * LAYERS
        assert log[cut + 1:] == bwd * LAYERS


def test_all_to_all_start_backward_matches_central_differences(runs):
    checked = [(g, n) for r in runs for name, g, n in r["collectives"]
               if name == "all_to_all_start"]
    assert len(checked) == 4
    for g, n in checked:
        np.testing.assert_allclose(g, n, rtol=1e-6, atol=1e-8)
