"""Port parity for kernel K6 (the aligned receiver gather) and the unfused
aggregation's pad sink: K6's plain version and ops.gather_receivers against
the JAX package's gather_receivers_pallas in interpret mode on a Loader
batch with a pad-sink tail, values and gradients; the pad sink declared or
not gives the same aggregation and the same model gradients. fp32 inputs
from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu.data import batching as JB
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.ops import pallas_segment as PS
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.data import batching as TB
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data import synthetic as TS
from aero_gnn_tpu_torch.models.mgn import MGNConfig
from aero_gnn_tpu_torch.ops import hopper_gather as HG
from aero_gnn_tpu_torch.ops import hopper_segment as HS
from aero_gnn_tpu_torch.training.loop import masked_mse
from aero_gnn_tpu_torch.utils import profiling as PR

RTOL, ATOL = 1e-4, 1e-5
D = 16


def _loader_graphs():
    """One mesh's aligned Loader batch from each package (bit-equal): its
    edge stream ends in a tail of pad rows keyed by the pad sink."""
    js = JS.make_random_mesh_sample(n_nodes=700, avg_degree=6, seed=4)
    ts = TS.make_random_mesh_sample(n_nodes=700, avg_degree=6, seed=4)
    JD.compute_features([js], ["mach", "alpha"])
    TD.compute_features([ts], ["mach", "alpha"])
    jb = next(iter(JB.Loader([js], 1, align_edges=True)))[0]
    tb = next(iter(TB.Loader([ts], 1, align_edges=True, device="cpu")))[0]
    sink = tb.num_nodes_pad - 1
    assert int((tb.receivers == sink).sum()) >= PS.ET  # a whole pad tile
    return jb, tb


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("route", ["gather_rows", "gather_receivers"])
def test_receiver_gather_matches_pallas_kernel(route):
    """Values bit-equal to the JAX kernel; gradients of a cotangent that is
    zero on pad rows (as on every model path) within rtol 1e-4 / atol 1e-5
    x max|g|. Only gather_receivers has a backward (K5's plain version with
    pad_sink, the cuda backend on CPU tensors)."""
    jb, tb = _loader_graphs()
    n, e = tb.num_nodes_pad, tb.num_edges_pad
    x = _randn(n, D, seed=1)
    ct = _randn(e, D, seed=2) * tb.edge_mask.numpy()[:, None]
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda a: PS.gather_receivers_pallas(
            a, jb.receivers), jnp.asarray(x))
        (dx_ref,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    PR.reset_counters()
    if route == "gather_rows":
        with torch.no_grad():
            got = HG.gather_rows(xt, tb.receivers)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            got.numpy(), HG.gather_rows_ref(xt, tb.receivers).detach())
        return
    with tops.use_backend("cuda"):
        got = tops.gather_receivers(xt, tb.receivers, aligned=True)
        got.backward(torch.from_numpy(ct))
    launched = PR.counters()
    assert launched.get("launch.K6", 0) == launched.get("launch.K5", 0) == 0
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    g = np.asarray(dx_ref)
    np.testing.assert_allclose(xt.grad.numpy(), g, rtol=RTOL,
                               atol=ATOL * np.abs(g).max())


def test_receiver_backward_skips_only_the_sink():
    """With a cotangent on every row the sink's gradient is 0 (its rows are
    skipped) and every other row is the JAX kernel's."""
    jb, tb = _loader_graphs()
    n, e = tb.num_nodes_pad, tb.num_edges_pad
    x, ct = _randn(n, D, seed=3), _randn(e, D, seed=4)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a: PS.gather_receivers_pallas(
            a, jb.receivers), jnp.asarray(x))
        g = np.asarray(vjp(jnp.asarray(ct))[0])
    xt = torch.from_numpy(x).requires_grad_()
    tops.gather_receivers(xt, tb.receivers, aligned=True).backward(
        torch.from_numpy(ct))
    got = xt.grad.numpy()
    assert np.all(got[-1] == 0.0) and np.any(g[-1] != 0.0)
    np.testing.assert_allclose(got[:-1], g[:-1], rtol=RTOL,
                               atol=ATOL * np.abs(g).max())


@pytest.mark.parametrize("aggregation", ["add", "mean"])
def test_aggregation_with_sink_declared_is_the_full_sum(aggregation):
    """On a Loader batch aggregate_edges with pad_sink equals the sum over
    every row (the sink's rows are masked), values and gradients, and the
    plain path's."""
    _, tb = _loader_graphs()
    n, e = tb.num_nodes_pad, tb.num_edges_pad
    msgs, ct = _randn(e, D, seed=5), _randn(n, D, seed=6)
    outs = []
    for backend, sink in (("cuda", True), ("cuda", False), ("torch", False)):
        mt = torch.from_numpy(msgs).requires_grad_()
        with tops.use_backend(backend):
            out = tops.aggregate_edges(mt, tb.receivers, n,
                                       aggregation=aggregation,
                                       edge_mask=tb.edge_mask, aligned=True,
                                       pad_sink=sink)
        out.backward(torch.from_numpy(ct))
        outs.append((out.detach().numpy(), mt.grad.numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert np.all(outs[0][0][-1] == 0.0)
    np.testing.assert_allclose(outs[0][0], outs[2][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(outs[0][1], outs[2][1])


def test_unfused_model_grads_same_with_and_without_pad_sink(monkeypatch):
    """The gradient of a small unfused MGN through a Loader batch is the
    same whether K5 skips the sink's rows (the receiver backward, the
    aggregation and the sender backward) or sums them: their cotangent is
    zero."""
    _, tb = _loader_graphs()
    cfg = MGNConfig(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
                    processor_size=3, hidden_dim_processor=32,
                    hidden_dim_node_encoder=32, hidden_dim_edge_encoder=32,
                    hidden_dim_decoder=32, aggregation="mean")
    runs = []
    for force_off in (False, True):
        if force_off:
            k5 = HS.segment_sum
            monkeypatch.setattr(HS, "segment_sum", lambda *a, **k: k5(
                *a, **{**k, "pad_sink": False}))
        params = cfg.init(3, device="cpu")
        pred = cfg.apply(params, tb)
        masked_mse(pred, tb.y, tb.node_mask).backward()
        runs.append({name: p.grad.clone()
                     for name, p in params.named_parameters()})
        runs[-1]["pred"] = pred.detach()
    for name, g in runs[0].items():
        assert torch.isfinite(g).all(), name
        assert torch.equal(runs[1][name], g), name
