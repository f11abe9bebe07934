"""Port parity for training and serving the BSMS: first-step gradients of
the whole model against jax.value_and_grad, Adam losses, the float32
behaviour whatever compute_dtype says, AeroInference with the Loader's
hierarchy, the parameter round trip, and the pad-tail repair's plumbing
(predictions on real rows equal through a tight and a Loader-padded
graph)."""

import jax
import numpy as np
import pytest
import torch

from aero_gnn_tpu.data import batching as JB
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.models.bsms import BSMSConfig as JaxBSMSConfig
from aero_gnn_tpu.training import loop as JL
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.data import batching as TB
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data import synthetic as TS
from aero_gnn_tpu_torch.graph import hierarchy as TH
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.inference.engine import AeroInference
from aero_gnn_tpu_torch.models.bsms import BSMSConfig
from aero_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from aero_gnn_tpu_torch.training import loop as TL

H = 16
SMALL = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
             processor_size=5, num_scales=3, layers_per_scale=1,
             hidden_dim_processor=H, hidden_dim_node_encoder=H,
             hidden_dim_edge_encoder=H, hidden_dim_decoder=H,
             num_hidden_layers_node_processor=2,
             num_hidden_layers_edge_processor=2, do_concat_trick=True,
             remat=False, hierarchy_mode="bistride", transfer="weighted")
STATS = {"target_mean": np.zeros(4), "target_std": np.ones(4)}


def _samples(n_samples=1):
    js = [JS.make_random_mesh_sample(n_nodes=900 + 100 * i, seed=i + 2)
          for i in range(n_samples)]
    ts = [TS.make_random_mesh_sample(n_nodes=900 + 100 * i, seed=i + 2)
          for i in range(n_samples)]
    JD.compute_features(js, ["mach", "alpha"])
    TD.compute_features(ts, ["mach", "alpha"])
    return js, ts


def _batches():
    js, ts = _samples()
    (jg, jaux), = JB.Loader(js, 1, num_scales=3, hierarchy_mode="bistride",
                            align_edges=True)
    (tg, taux), = TB.Loader(ts, 1, num_scales=3, hierarchy_mode="bistride",
                            align_edges=True, device="cpu")
    return jg, jaux["hierarchy"], tg, taux["hierarchy"]


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("port_backend", ["cuda", "torch"])
def test_first_step_grads_match_jax(port_backend):
    """port_backend "cuda": K1-K5 and K7 through their plain versions on
    CPU tensors with the kernels' autograd Functions; "torch": the plain
    composition."""
    jcfg, tcfg = JaxBSMSConfig(**SMALL), BSMSConfig(**SMALL)
    tree = jcfg.init(jax.random.PRNGKey(7))
    jg, jh, tg, th = _batches()

    def loss_fn(p):
        return JL.masked_mse(jcfg.apply(p, jg, hierarchy=jh), jg.y,
                             jg.node_mask)

    jloss, jgrads = jax.value_and_grad(loss_fn)(tree)
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")
    with tops.use_backend(port_backend):
        loss = TL.masked_mse(tcfg.apply(params, tg, hierarchy=th), tg.y,
                             tg.node_mask)
        loss.backward()
    tgrads = _leaves(params_to_jax(params, tcfg, grads=True))
    jgrads = _leaves(jgrads)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert tgrads.keys() == jgrads.keys()
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], g, rtol=1e-3,
                                   atol=1e-5 * np.abs(g).max(initial=1e-30),
                                   err_msg=name)


def test_three_adam_steps_track_jax():
    jcfg, tcfg = JaxBSMSConfig(**SMALL), BSMSConfig(**SMALL)
    tree = jcfg.init(jax.random.PRNGKey(7))
    jg, jh, tg, th = _batches()
    opt = JL.make_optimizer(1e-3)
    fns = JL.make_step_fns(jcfg, opt, needs_hierarchy=True, donate=False)
    p, st, jlosses = tree, opt.init(tree), []
    for _ in range(3):
        p, st, loss = fns.train_step(p, st, jg, jh, None)
        jlosses.append(float(loss))
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")
    tfns = TL.make_step_fns(tcfg, TL.make_optimizer(params, 1e-3),
                            device="cpu", needs_hierarchy=True)
    tlosses = [float(tfns.train_step(params, tg, th)) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert float(tfns.eval_step(params, tg, th)) < tlosses[0]
    with pytest.raises(ValueError, match="hierarchy"):
        tfns.train_step(params, tg)


def test_bf16_compute_dtype_computes_in_fp32_as_jax():
    """The JAX BSMS ignores compute_dtype: bf16 parameters and a bf16
    compute_dtype still give JAX's float32 result."""
    jcfg = JaxBSMSConfig(**SMALL, compute_dtype="bfloat16")
    tcfg = BSMSConfig(**SMALL, compute_dtype="bfloat16")
    tree = jax.tree.map(lambda a: a.astype(jax.numpy.bfloat16),
                        jcfg.init(jax.random.PRNGKey(7)))
    jg, jh, tg, th = _batches()
    ref = np.asarray(jcfg.apply(tree, jg, hierarchy=jh))
    assert ref.dtype == np.float32
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu").to(torch.bfloat16)
    with torch.no_grad():
        got = tcfg.apply(params, tg, hierarchy=th)
    assert got.dtype == torch.float32
    n = tg.n_node
    np.testing.assert_allclose(got.numpy()[:n], ref[:n], rtol=2e-4,
                               atol=2e-5)
    eng = AeroInference(tcfg, params, STATS, device="cpu",
                        needs_hierarchy=True)
    assert all(p.dtype == torch.float32 for p in eng.params.parameters())


def test_engine_serves_loader_batches_with_hierarchy():
    js, ts = _samples(2)
    jcfg, tcfg = JaxBSMSConfig(**SMALL), BSMSConfig(**SMALL)
    tree = jcfg.init(jax.random.PRNGKey(5))
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")
    eng = AeroInference(tcfg, params, STATS, device="cpu",
                        needs_hierarchy=True)
    loader = TB.Loader(ts, 2, num_scales=3, hierarchy_mode="bistride",
                       device="cpu")
    (g, aux), = loader
    outs = eng.predict_batch(g, aux)
    jl = JB.Loader(js, 2, num_scales=3, hierarchy_mode="bistride",
                   align_edges=True)
    (jg, jaux), = jl
    ref = np.asarray(jcfg.apply(tree, jg, hierarchy=jaux["hierarchy"]))
    off = 0
    for (pred, tgt, pn, tn), s in zip(outs, ts):
        assert pred.shape == (s.num_nodes, 4) and np.isfinite(pred).all()
        np.testing.assert_allclose(pn, ref[off:off + s.num_nodes],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(tn, s.y)
        off += s.num_nodes
    single = eng.predict_single(g, aux, ts[0].num_nodes)[2]
    np.testing.assert_array_equal(single, outs[0][2])
    with pytest.raises(ValueError, match="hierarchy"):
        eng.predict_single(g)


def test_params_round_trip():
    jcfg, tcfg = JaxBSMSConfig(**SMALL), BSMSConfig(**SMALL)
    tree = jax.tree.map(np.asarray, jcfg.init(jax.random.PRNGKey(1)))
    back = params_to_jax(params_from_jax(tree, tcfg, device="cpu"), tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (k, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(k))
    own = tcfg.init(3, device="cpu")
    assert [n for n, _ in own.named_parameters()] == \
        [n for n, _ in params_from_jax(tree, tcfg,
                                       device="cpu").named_parameters()]
    with pytest.raises(ValueError, match="stages"):
        params_from_jax({**tree, "down": tree["down"][:1]}, tcfg)


def test_tight_and_loader_padded_graphs_agree():
    """The Loader pads the stream with a tail of pad-sink rows (pad tiles
    the kernels skip); predictions and gradients on real rows are those of
    a tight aligned graph."""
    _, ts = _samples()
    s = ts[0]
    cfg = BSMSConfig(**SMALL)
    params = cfg.init(0, device="cpu")
    loader = TB.Loader(ts, 1, num_scales=3, hierarchy_mode="bistride",
                       device="cpu")
    (padded, aux), = loader
    tight, amap = TP.build_graph_batch(
        senders=s.senders, receivers=s.receivers, x=s.x,
        edge_attr=s.edge_attr, pos=s.pos, y=s.y,
        num_nodes_pad=padded.num_nodes_pad, align_edges=True,
        return_align_map=True, device="cpu")
    sink = padded.num_nodes_pad - 1
    assert not (tight.receivers == sink).any()
    assert int((padded.receivers != sink).sum()) == tight.num_edges_pad \
        < padded.num_edges_pad
    real = TH.build_hierarchy_real(
        senders=s.senders, receivers=s.receivers,
        node_graph=np.zeros(s.num_nodes, np.int64), num_nodes=s.num_nodes,
        pos=s.pos.astype(np.float64), num_scales=3, mode="bistride")
    lv = TH.collate_hierarchies(
        [real], num_fine_nodes_pad=tight.num_nodes_pad,
        num_fine_edges_pad=tight.num_edges_pad,
        pad_plan=loader.pad_spec.hierarchy_pad_plan, device="cpu")
    hier = TH.align_hierarchy(lv, amap, device="cpu")
    n = s.num_nodes
    outs = []
    for g, h in ((tight, hier), (padded, aux["hierarchy"])):
        params.zero_grad(set_to_none=True)
        out = cfg.apply(params, g, hierarchy=h)
        TL.masked_mse(out, g.y, g.node_mask).backward()
        outs.append((out.detach().numpy()[:n],
                     [p.grad.clone() for p in params.parameters()]))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)

