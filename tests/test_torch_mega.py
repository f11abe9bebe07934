"""Port parity for the single-kernel MGN layer (AERO_GNN_MEGA=1): kernel
K9's plain versions and its autograd Function against the JAX package's
pallas_mega.fused_mgn_layer and jax.grad of it (Pallas kernels in interpret
mode); the routing of mgn_layer_apply under the knob; and the first-step
gradients of a small flagship-shaped MGN under each knob (AERO_GNN_MEGA,
AERO_GNN_SAVE_ACTS) against jax.value_and_grad with the same knob. fp32
inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from aero_gnn_tpu.nn import blocks as JB
from aero_gnn_tpu.ops import pallas_mega as PM
from aero_gnn_tpu.training import loop as JL
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.models.convert import (
    _load_layer,
    params_from_jax,
    params_to_jax,
)
from aero_gnn_tpu_torch.models.mgn import MGNConfig
from aero_gnn_tpu_torch.nn import blocks as TB
from aero_gnn_tpu_torch.ops import hopper_fused as HF
from aero_gnn_tpu_torch.ops import hopper_mega as HM
from aero_gnn_tpu_torch.ops import hopper_node as HN
from aero_gnn_tpu_torch.training import loop as TL
from aero_gnn_tpu_torch.utils import profiling as PR

# the JAX package's own tolerance for its single-kernel layer against the
# composition (tests/test_pallas.py TestFusedMGNLayer), fp32
TOL = 3e-4
H = 16


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(3)
    n, e = 300, 1500
    g = dict(senders=rng.integers(0, n, e), receivers=rng.integers(0, n, e),
             x=rng.standard_normal((n, 4)).astype(np.float32),
             edge_attr=rng.standard_normal((e, 8)).astype(np.float32),
             pos=rng.standard_normal((n, 2)).astype(np.float32))
    return (JP.build_graph_batch(**g, align_edges=True),
            TP.build_graph_batch(**g, align_edges=True, device="cpu"))


def _data(gb, seed, nh=2):
    """The inputs of tests/test_pallas.py TestFusedMGNLayer._data, as numpy
    (nh hidden layers in each chain)."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.1

    E, N = gb.num_edges_pad, gb.num_nodes_pad
    e, sg, d_proj, x = f(E, H) * 10, f(E, H) * 10, f(N, H) * 10, f(N, H) * 10
    ep = dict(w_e=f(H, H), ws=f(nh, H, H), bs=f(nh, H), w_out=f(H, H),
              b_out=f(H), ln_scale=np.ones(H, np.float32),
              ln_bias=np.zeros(H, np.float32))
    npar = dict(w1x=f(H, H), w1a=f(H, H), b1=f(H), ws=f(nh, H, H),
                bs=f(nh, H), w_out=f(H, H), b_out=f(H),
                ln_scale=np.ones(H, np.float32),
                ln_bias=np.zeros(H, np.float32))
    return e, sg, d_proj, x, ep, npar


def _torch(a, grad=False):
    if isinstance(a, dict):
        return {k: _torch(v, grad) for k, v in a.items()}
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def test_mega_forward_matches_jax(graphs):
    jb, tb = graphs
    e, sg, d_proj, x, ep, npar = _data(jb, seed=31)
    N = jb.num_nodes_pad
    with pltpu.force_tpu_interpret_mode():
        x_ref, e_ref = PM.fused_mgn_layer(*map(jnp.asarray, (e, sg, d_proj,
                                                             x)),
                                          jb.edge_mask, jb.receivers,
                                          ep, npar, N)
    x2, e2, agg = HM.fused_mgn_layer(*map(_torch, (e, sg, d_proj, x)),
                                     tb.edge_mask, tb.receivers,
                                     _torch(ep), _torch(npar), N)
    real = tb.edge_mask.numpy() > 0
    np.testing.assert_allclose(x2.numpy(), np.asarray(x_ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(e2.numpy()[real], np.asarray(e_ref)[real],
                               rtol=TOL, atol=TOL)
    # the plain version is the edge layer's followed by the node layer's
    e_k1, agg_k1 = HF.fused_edge_layer(
        *map(_torch, (e, sg, d_proj)), tb.edge_mask, tb.receivers,
        *[_torch(ep[k]) for k in HM.EDGE_KEYS], N)
    assert torch.equal(e2, e_k1) and torch.equal(agg, agg_k1)


def test_mega_forward_deep_matches_jax(graphs):
    """A deep stack (9 hidden layers in each chain): K9's plain version
    against pallas_mega's kernel in interpret mode, and bit-equal to the
    edge layer's plain version followed by the node layer's."""
    jb, tb = graphs
    e, sg, d_proj, x, ep, npar = _data(jb, seed=37, nh=9)
    N = jb.num_nodes_pad
    with pltpu.force_tpu_interpret_mode():
        x_ref, e_ref = PM.fused_mgn_layer(*map(jnp.asarray, (e, sg, d_proj,
                                                             x)),
                                          jb.edge_mask, jb.receivers,
                                          ep, npar, N)
    PR.reset_counters()
    x2, e2, agg = HM.fused_mgn_layer(*map(_torch, (e, sg, d_proj, x)),
                                     tb.edge_mask, tb.receivers,
                                     _torch(ep), _torch(npar), N)
    # CPU tensors: plain version
    assert PR.counters().get("launch.K9-fwd", 0) == 0
    real = tb.edge_mask.numpy() > 0
    np.testing.assert_allclose(x2.numpy(), np.asarray(x_ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(e2.numpy()[real], np.asarray(e_ref)[real],
                               rtol=TOL, atol=TOL)
    x3 = HN.fused_node_layer(_torch(x), agg,
                             *[_torch(npar[k]) for k in HM.NODE_KEYS])
    assert torch.equal(x2, x3)


def test_mega_grads_match_jax(graphs):
    """Gradients of the autograd Function (K9-bwd's plain version) against
    jax.grad of the JAX layer (its Pallas backward kernel), every input and
    weight, and equal to the K1 -> K3 composition's autograd."""
    jb, tb = graphs
    e, sg, d_proj, x, ep, npar = _data(jb, seed=32)
    N = jb.num_nodes_pad
    rng = np.random.default_rng(33)
    px = rng.standard_normal(x.shape).astype(np.float32)
    # pad-edge rows of e' are unobservable by contract: mask the probe
    pe = (rng.standard_normal(e.shape).astype(np.float32)
          * np.asarray(jb.edge_mask)[:, None])

    def jloss(e, sg, d_proj, x, ep, npar):
        x2, e2 = PM.fused_mgn_layer(e, sg, d_proj, x, jb.edge_mask,
                                    jb.receivers, ep, npar, N)
        return jnp.sum(x2 * px) + jnp.sum(e2 * pe)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=tuple(range(6)))(
            *map(jnp.asarray, (e, sg, d_proj, x)),
            jax.tree.map(jnp.asarray, ep), jax.tree.map(jnp.asarray, npar))

    def port(layer_fn):
        ins = [_torch(a, True) for a in (e, sg, d_proj, x)]
        tep, tnp = _torch(ep, True), _torch(npar, True)
        x2, e2 = layer_fn(*ins, tep, tnp)
        (torch.sum(x2 * _torch(px)) + torch.sum(e2 * _torch(pe))).backward()
        return ([t.grad for t in ins] + [tep[k].grad for k in HM.EDGE_KEYS]
                + [tnp[k].grad for k in HM.NODE_KEYS])

    got = port(lambda e, sg, d_proj, x, tep, tnp: HM.fused_mgn_layer_autograd(
        e, sg, d_proj, x, tb.edge_mask, tb.receivers, tep, tnp, N))
    names = (["e", "sg", "d_proj", "x"] + [f"ep.{k}" for k in HM.EDGE_KEYS]
             + [f"npar.{k}" for k in HM.NODE_KEYS])
    want = list(ref[:4]) + [ref[4][k] for k in HM.EDGE_KEYS] + \
        [ref[5][k] for k in HM.NODE_KEYS]
    for name, g, r in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL,
                                   atol=TOL, err_msg=name)

    def composed(e, sg, d_proj, x, tep, tnp):
        e2, agg = HF.fused_edge_layer_autograd(
            e, sg, d_proj, tb.edge_mask, tb.receivers,
            *[tep[k] for k in HM.EDGE_KEYS], N)
        return HN.fused_node_layer_autograd(
            x, agg, *[tnp[k] for k in HM.NODE_KEYS]), e2

    for name, g, c in zip(names, got, port(composed)):
        assert torch.equal(g, c), name


def test_mgn_layer_routes_to_mega(graphs, monkeypatch):
    """AERO_GNN_MEGA=1 routes mgn_layer_apply through the single-kernel
    layer (the blocks.py packing included; its wrapper is called once, the
    fused edge layer's never) and matches the JAX package's
    test_mgn_layer_routes_to_mega case on its pallas path; without the knob
    the layer takes K1 / K3 and gives the same values."""
    jb, tb = graphs
    cfg_kw = dict(node_dim=H, edge_dim=H, hidden_dim=H,
                  num_hidden_layers_node=2, num_hidden_layers_edge=2,
                  do_concat_trick=True)
    jcfg, tcfg = JB.MGNLayerConfig(**cfg_kw), TB.MGNLayerConfig(**cfg_kw)
    params = JB.mgn_layer_init(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(51)
    x = rng.standard_normal((jb.num_nodes_pad, H)).astype(np.float32)
    e = rng.standard_normal((jb.num_edges_pad, H)).astype(np.float32)
    monkeypatch.setenv("AERO_GNN_MEGA", "1")
    with jops.use_backend("pallas"), pltpu.force_tpu_interpret_mode():
        x_ref, e_ref = JB.mgn_layer_apply(
            params, jcfg, jnp.asarray(x), jnp.asarray(e), jb.senders,
            jb.receivers, jb.edge_mask, jb.sender_perm, jb.senders_sorted,
            True)
    layer = TB.MGNLayer(tcfg, torch.Generator().manual_seed(0))
    _load_layer(layer, jax.tree.map(np.asarray, params), "layer")
    calls = []
    for mod, name in ((HM, "fused_mgn_layer"), (HF, "fused_edge_layer")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    args = (tcfg, torch.from_numpy(x), torch.from_numpy(e), tb.senders,
            tb.receivers, tb.edge_mask, tb.sender_perm, tb.senders_sorted,
            True)
    with torch.no_grad():
        assert TB._mega_layer_ok(layer, tcfg, args[1])
        x_out, e_out = TB.mgn_layer_apply(layer, *args)
        assert calls == ["fused_mgn_layer"]
        monkeypatch.delenv("AERO_GNN_MEGA")
        assert not TB._mega_layer_ok(layer, tcfg, args[1])
        x_k, e_k = TB.mgn_layer_apply(layer, *args)
        assert calls == ["fused_mgn_layer", "fused_edge_layer"]
    real = tb.edge_mask.numpy() > 0
    np.testing.assert_allclose(x_out.numpy(), np.asarray(x_ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(e_out.numpy()[real], np.asarray(e_ref)[real],
                               rtol=TOL, atol=TOL)
    assert torch.equal(x_out, x_k) and torch.equal(e_out, e_k)


_SMALL = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
              processor_size=3, hidden_dim_processor=32,
              hidden_dim_node_encoder=32, hidden_dim_edge_encoder=32,
              hidden_dim_decoder=32, num_hidden_layers_node_processor=2,
              num_hidden_layers_edge_processor=2,
              num_hidden_layers_node_encoder=2,
              num_hidden_layers_edge_encoder=2, num_hidden_layers_decoder=2,
              do_concat_trick=True, remat=False)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("knob", ["AERO_GNN_MEGA", "AERO_GNN_SAVE_ACTS"])
def test_first_step_grads_match_jax_with_knob(knob, monkeypatch):
    """A small flagship-shaped MGN (h = 32, 3 layers, remat off: an
    interpret-mode pallas_call cannot sit under jax.checkpoint) with the
    knob set: the port's first-step loss and gradients (the knob's kernels'
    plain versions on CPU tensors) against jax.value_and_grad with the
    same knob on the pallas backend, rtol 1e-3 as test_torch_training.py."""
    monkeypatch.setenv(knob, "1")
    s = JS.make_random_mesh_sample(n_nodes=500, avg_degree=6, seed=2)
    JD.compute_features([s], ["mach", "alpha"])
    g = dict(senders=s.senders, receivers=s.receivers, x=s.x,
             edge_attr=s.edge_attr, pos=s.pos, y=s.y)
    jb = JP.build_graph_batch(**g, align_edges=True)
    tb = TP.build_graph_batch(**g, align_edges=True, device="cpu")
    jcfg, tcfg = JaxMGNConfig(**_SMALL), MGNConfig(**_SMALL)
    tree = jcfg.init(jax.random.PRNGKey(7))

    def loss_fn(p):
        return JL.masked_mse(jcfg.apply(p, jb), jb.y, jb.node_mask)

    with jops.use_backend("pallas"), pltpu.force_tpu_interpret_mode():
        jloss, jgrads = jax.value_and_grad(loss_fn)(tree)
    jgrads = _leaves(jgrads)
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")
    wrapper = (HM, "fused_mgn_layer") if knob == "AERO_GNN_MEGA" else \
        (HF, "fused_edge_layer_bwd_saved")
    calls = []
    fn = getattr(*wrapper)
    monkeypatch.setattr(*wrapper, lambda *a, **k: (calls.append(1),
                                                   fn(*a, **k))[1])
    with tops.use_backend("cuda"):
        loss = TL.masked_mse(tcfg.apply(params, tb), tb.y, tb.node_mask)
        loss.backward()
    assert len(calls) == _SMALL["processor_size"]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    tgrads = _leaves(params_to_jax(params, tcfg, grads=True))
    assert tgrads.keys() == jgrads.keys()
    for name, gj in jgrads.items():
        np.testing.assert_allclose(tgrads[name], gj, rtol=1e-3,
                                   atol=1e-5 * np.abs(gj).max(initial=1e-30),
                                   err_msg=name)

