"""Port parity for the BSMS transfer switches (AERO_GNN_SORTED_POOL=1,
AERO_GNN_WEC_FUSED=0) and the op they need: segment_pool_sum against the
JAX package's values and jax.vjp, the sorted pools' pad tails, a small
BSMS's forward and first-step gradients against JAX under each switch (JAX
on its XLA backend), and the kernels each switch routes to, counted
through their plain versions. AERO_GNN_WEC_DTYPE=compute is the identity
on a float32 BSMS in the JAX package and not read by the port: its cases
hold the port, which ignores it, to JAX with it set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.data import batching as JB
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.models.bsms import BSMSConfig as JaxBSMSConfig
from aero_gnn_tpu.training import loop as JL
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.data import batching as TB
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data import synthetic as TS
from aero_gnn_tpu_torch.models.bsms import BSMSConfig
from aero_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from aero_gnn_tpu_torch.ops import hopper_segment as HS
from aero_gnn_tpu_torch.training import loop as TL

H = 16
SMALL = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
             processor_size=5, num_scales=3, layers_per_scale=1,
             hidden_dim_processor=H, hidden_dim_node_encoder=H,
             hidden_dim_edge_encoder=H, hidden_dim_decoder=H,
             num_hidden_layers_node_processor=2,
             num_hidden_layers_edge_processor=2, do_concat_trick=True,
             remat=False, hierarchy_mode="bistride")
SWITCHES = {"default": {}, "sorted_pool": {"AERO_GNN_SORTED_POOL": "1"},
            "wec_unfused": {"AERO_GNN_WEC_FUSED": "0"},
            "wec_dtype": {"AERO_GNN_WEC_DTYPE": "compute"}}
_ALL = ("AERO_GNN_SORTED_POOL", "AERO_GNN_WEC_FUSED", "AERO_GNN_WEC_DTYPE")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    worker processes at once, and torch's default pool in each (one thread
    a core) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _switch(monkeypatch, name):
    for k in _ALL:
        monkeypatch.delenv(k, raising=False)
    for k, v in SWITCHES[name].items():
        monkeypatch.setenv(k, v)


def _pool_case(width):
    rng = np.random.default_rng(width)
    rows, n = 300, 40
    ids = rng.integers(0, n - 3, rows).astype(np.int32)  # some empty
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    shape = (rows,) if width is None else (rows, width)
    data = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal((n,) + shape[1:]).astype(np.float32)
    return data, ids, perm, ids[perm], n, ct


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("width", [None, 1, 16])
def test_segment_pool_sum_matches_jax(backend, width):
    data, ids, perm, srt, n, ct = _pool_case(width)

    def jfn(d):
        return jops.segment_pool_sum(d, jnp.asarray(ids), n,
                                     perm=jnp.asarray(perm),
                                     seg_sorted=jnp.asarray(srt))

    jout, vjp = jax.vjp(jfn, jnp.asarray(data))
    (jgrad,) = vjp(jnp.asarray(ct))
    d = torch.from_numpy(data).requires_grad_(True)
    with tops.use_backend(backend):
        out = tops.segment_pool_sum(d, torch.from_numpy(ids), n,
                                    perm=torch.from_numpy(perm),
                                    seg_sorted=torch.from_numpy(srt))
    out.backward(torch.from_numpy(ct))
    assert out.shape == jout.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(d.grad.numpy(), np.asarray(jgrad))


@pytest.fixture(scope="module")
def batches():
    js = [JS.make_random_mesh_sample(n_nodes=900, seed=2)]
    ts = [TS.make_random_mesh_sample(n_nodes=900, seed=2)]
    JD.compute_features(js, ["mach", "alpha"])
    TD.compute_features(ts, ["mach", "alpha"])
    (jg, jaux), = JB.Loader(js, 1, num_scales=3, hierarchy_mode="bistride",
                            align_edges=True)
    (tg, taux), = TB.Loader(ts, 1, num_scales=3, hierarchy_mode="bistride",
                            align_edges=True, device="cpu")
    return jg, jaux["hierarchy"], tg, taux["hierarchy"]


@pytest.mark.parametrize("kind", ["node", "edge"])
def test_sorted_pool_stops_before_the_pad_tail(batches, kind):
    """Each level's sorted pool stream, cut at its ``*_pool_live`` rows,
    leaves out exactly the pad fine rows (all keyed by the pad last coarse
    id), and the pool of a masked operand over the cut stream equals the
    pool over the whole stream."""
    _, _, tg, th = batches
    fine_mask = tg.node_mask if kind == "node" else tg.edge_mask
    for lv in th:
        ids = lv.fine_to_coarse if kind == "node" else lv.edge_to_coarse
        perm = getattr(lv, f"{kind}_pool_perm")
        srt = getattr(lv, f"{kind}_pool_sorted")
        live = getattr(lv, f"{kind}_pool_live")
        coarse_mask = lv.node_mask if kind == "node" else lv.edge_mask
        n = coarse_mask.shape[0]
        assert float(coarse_mask[-1]) == 0.0
        assert 0 < live < perm.shape[0]
        assert (srt[live:] == n - 1).all() and (srt[:live] < n - 1).all()
        assert int((fine_mask[perm[live:].long()] != 0).sum()) == 0
        assert live == int((fine_mask != 0).sum())
        data = torch.randn(perm.shape[0], H, generator=torch.Generator()
                           .manual_seed(5)) * fine_mask[:, None]
        for backend in ("cuda", "torch"):
            with tops.use_backend(backend):
                cut = tops.segment_pool_sum(data, ids, n, perm=perm[:live],
                                            seg_sorted=srt[:live])
                whole = tops.segment_pool_sum(data, ids, n, perm=perm,
                                              seg_sorted=srt)
            assert torch.equal(cut, whole), backend
        fine_mask = coarse_mask


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("transfer", ["weighted", "mean"])
@pytest.mark.parametrize("switch", list(SWITCHES)[1:])
def test_forward_and_grads_match_jax(batches, monkeypatch, switch, transfer):
    """Under each switch: the forward and the first-step gradients of both
    port backends against JAX's (XLA backend) under the same switch."""
    _switch(monkeypatch, switch)
    jg, jh, tg, th = batches
    jcfg = JaxBSMSConfig(**SMALL, transfer=transfer)
    tcfg = BSMSConfig(**SMALL, transfer=transfer)
    tree = jcfg.init(jax.random.PRNGKey(7))

    def loss_fn(p):
        pred = jcfg.apply(p, jg, hierarchy=jh)
        return JL.masked_mse(pred, jg.y, jg.node_mask), pred

    with jops.use_backend("xla"):
        (jloss, jpred), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
            tree)
    jgrads = _leaves(jgrads)
    for backend in ("cuda", "torch"):
        params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                                 device="cpu")
        with tops.use_backend(backend):
            pred = tcfg.apply(params, tg, hierarchy=th)
            loss = TL.masked_mse(pred, tg.y, tg.node_mask)
            loss.backward()
        np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                                   rtol=2e-4, atol=2e-5, err_msg=backend)
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5, err_msg=backend)
        tgrads = _leaves(params_to_jax(params, tcfg, grads=True))
        assert tgrads.keys() == jgrads.keys()
        for name, g in jgrads.items():
            np.testing.assert_allclose(
                tgrads[name], g, rtol=1e-3,
                atol=1e-5 * np.abs(g).max(initial=1e-30),
                err_msg=f"{backend} {name}")


def _counted(monkeypatch, name):
    calls = []
    fn = getattr(HS, name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(HS, name, counted)
    return calls


# (K5, K7) calls of one forward and of one training step on the cuda
# backend, SMALL's 5 fused layers over 2 levels: K5 is the sender backward
# once a layer; the WEC runs A down and A^T up at each level (K7, or K5
# under WEC_FUSED=0), a step adds each one's adjoint; the sorted pools
# (every setting on the cuda backend) add three K5 a level (nodes, edges,
# the weight sums) to every forward, and the unpool's backward two a level
# (its chunk plan's two passes) to a step
ROUTES = {"default": ((6, 4), (15, 8)), "sorted_pool": ((6, 4), (15, 8)),
          "wec_unfused": ((10, 0), (23, 0)), "wec_dtype": ((6, 4), (15, 8))}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_routes_to_its_kernels(batches, monkeypatch, switch):
    _switch(monkeypatch, switch)
    _, _, tg, th = batches
    cfg = BSMSConfig(**SMALL, transfer="weighted")
    params = cfg.init(0, device="cpu")
    k5 = _counted(monkeypatch, "segment_sum")
    k7 = _counted(monkeypatch, "segment_sum_weighted")
    with tops.use_backend("cuda"):
        with torch.no_grad():
            cfg.apply(params, tg, hierarchy=th)
        forward = (len(k5), len(k7))
        TL.masked_mse(cfg.apply(params, tg, hierarchy=th), tg.y,
                      tg.node_mask).backward()
    step = (len(k5) - forward[0], len(k7) - forward[1])
    assert (forward, step) == ROUTES[switch]
