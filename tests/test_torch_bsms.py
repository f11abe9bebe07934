"""Port parity for the BSMS forward: the whole model against the JAX
package's on its xla backend and on its pallas backend in interpret mode,
through unaligned and aligned Loaders, for (stride, mean), (bistride, mean)
and (bistride, weighted); and the WeightedEdgeConv pair (wec_aggregate,
wec_up) with its custom VJPs, on a symmetric stream and on an asymmetric
one (the sender-sorted adjoint). fp32, inputs and JAX-initialised weights
from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.data import batching as JB
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.graph import hierarchy as JH
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.models import bsms as JBS
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.data import batching as TB
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data import synthetic as TS
from aero_gnn_tpu_torch.graph import hierarchy as TH
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.models import bsms as TBS
from aero_gnn_tpu_torch.models.convert import params_from_jax

H = 16
SMALL = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
             processor_size=5, num_scales=3, layers_per_scale=1,
             hidden_dim_processor=H, hidden_dim_node_encoder=H,
             hidden_dim_edge_encoder=H, hidden_dim_decoder=H,
             num_hidden_layers_node_processor=2,
             num_hidden_layers_edge_processor=2, do_concat_trick=True,
             remat=False)
RTOL, ATOL = 2e-4, 2e-5
D = 8


def _samples(n_nodes=700, seed=1):
    js = [JS.make_random_mesh_sample(n_nodes=n_nodes, seed=seed)]
    ts = [TS.make_random_mesh_sample(n_nodes=n_nodes, seed=seed)]
    JD.compute_features(js, ["mach", "alpha"])
    TD.compute_features(ts, ["mach", "alpha"])
    return js, ts


@pytest.mark.parametrize("mode,transfer", [("stride", "mean"),
                                           ("bistride", "mean"),
                                           ("bistride", "weighted")])
def test_forward_matches_jax(mode, transfer):
    js, ts = _samples()
    jcfg = JBS.BSMSConfig(**SMALL, hierarchy_mode=mode, transfer=transfer)
    tcfg = TBS.BSMSConfig(**SMALL, hierarchy_mode=mode, transfer=transfer)
    tree = jcfg.init(jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")
    for align in (False, True):
        (jg, jaux), = JB.Loader(js, 1, num_scales=3, hierarchy_mode=mode,
                                align_edges=align)
        (tg, taux), = TB.Loader(ts, 1, num_scales=3, hierarchy_mode=mode,
                                align_edges=align, device="cpu")
        n = tg.n_node
        outs = {}
        for port_backend in ("cuda", "torch"):
            with tops.use_backend(port_backend), torch.no_grad():
                outs[port_backend] = tcfg.apply(
                    params, tg, hierarchy=taux["hierarchy"]).numpy()[:n]
            assert outs[port_backend].dtype == np.float32
        for jax_backend in (("xla", "pallas") if align else ("xla",)):
            with jops.use_backend(jax_backend), \
                    pltpu.force_tpu_interpret_mode():
                ref = np.asarray(jcfg.apply(
                    tree, jg, hierarchy=jaux["hierarchy"]))[:n]
            for port_backend, got in outs.items():
                np.testing.assert_allclose(
                    got, ref, rtol=RTOL, atol=ATOL,
                    err_msg=f"align={align} {jax_backend} {port_backend}")


def _aligned_level(symmetric):
    """(JAX graph, JAX level 0, port graph, port level 0) of one aligned
    batch: a mesh (symmetric stream: the reverse-edge adjoint) or random
    directed edges (no reverse map: the sender-sorted adjoint)."""
    rng = np.random.default_rng(8)
    if symmetric:
        s = JS.make_random_mesh_sample(n_nodes=700, seed=5)
        snd, rcv, pos = s.senders, s.receivers, s.pos
    else:
        n = 700
        keys = np.unique(rng.integers(0, n * n, 3000))
        snd, rcv = keys // n, keys % n
        pos = rng.random((n, 2)).astype(np.float32)
    n = pos.shape[0]
    g = dict(senders=snd, receivers=rcv, pos=pos,
             x=rng.standard_normal((n, 2)).astype(np.float32),
             edge_attr=rng.standard_normal((len(snd), 3)).astype(np.float32),
             y=np.zeros((n, 1), np.float32))
    real = JH.build_hierarchy_real(
        senders=snd, receivers=rcv, node_graph=np.zeros(n, np.int64),
        num_nodes=n, pos=pos.astype(np.float64), num_scales=2,
        mode="bistride")
    plan = [(JP.bucket_size(real[0]["num_nodes"] + 1),
             JP.bucket_size(real[0]["num_edges"]))]
    out = []
    for P, Hm, kw in ((JP, JH, {}), (TP, TH, {"device": "cpu"})):
        gb, amap = P.batch_graphs([g], num_nodes_pad=1024,
                                  num_edges_pad=8 * 1024, align_edges=True,
                                  return_align_map=True, **kw)
        lv = Hm.collate_hierarchies(
            [real], num_fine_nodes_pad=1024, num_fine_edges_pad=8 * 1024,
            pad_plan=plan, **kw)
        out += [gb, Hm.align_hierarchy(lv, amap, **kw)[0]]
    assert (out[1].conv_edge_t is None) == (not symmetric)
    assert (out[3].conv_edge_t is None) == (not symmetric)
    return out


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("op", ["wec_aggregate", "wec_up"])
def test_wec_ops_and_vjps_match_jax(op, symmetric):
    jg, jlv, tg, tlv = _aligned_level(symmetric)
    n = tg.num_nodes_pad
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, D)).astype(np.float32)
    ct = rng.standard_normal((n, D)).astype(np.float32)
    for aligned, jax_backend in ((False, "xla"), (True, "pallas")):
        with jops.use_backend(jax_backend), pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(lambda a: getattr(JBS, op)(
                jlv, a, jg.senders, jg.receivers, jg.sender_perm,
                jg.senders_sorted, aligned), jnp.asarray(x))
            (dx_ref,) = vjp(jnp.asarray(ct))
        xt = torch.from_numpy(x).requires_grad_()
        got = getattr(TBS, op)(tlv, xt, tg.senders, tg.receivers,
                               tg.sender_perm, tg.senders_sorted, aligned)
        got.backward(torch.from_numpy(ct))
        tag = f"{op} symmetric={symmetric} aligned={aligned}"
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                                   rtol=1e-5, atol=1e-6, err_msg=tag)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref),
                                   rtol=1e-5, atol=1e-6, err_msg=tag)
