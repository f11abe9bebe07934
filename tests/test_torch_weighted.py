"""Port parity for the weighted sorted segment sum (kernel K7's plain
version) and ``ops.aggregate_edges_weighted``: against the JAX package's
segment_agg_weighted_pallas in interpret mode on an aligned stream, values
and gradients, and against its XLA fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.ops import pallas_segment as PS
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.ops import hopper_segment as HS
from aero_gnn_tpu_torch.utils import profiling as PR

D = 16


def _graphs(align=True):
    rng = np.random.default_rng(11)
    n, e = 400, 2000
    g = dict(senders=rng.integers(0, n, e), receivers=rng.integers(0, n, e),
             x=rng.standard_normal((n, 4)).astype(np.float32),
             edge_attr=rng.standard_normal((e, 3)).astype(np.float32),
             pos=rng.standard_normal((n, 2)).astype(np.float32))
    return (JP.build_graph_batch(**g, align_edges=align),
            TP.build_graph_batch(**g, align_edges=align, device="cpu"))


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_k7_matches_pallas_kernel(with_mask):
    """fp32, within 1e-5: the plain version with and without ``mask``, and
    with ``rows`` (the gather folded in) equal to the explicit gather."""
    jb, tb = _graphs()
    n, e = tb.num_nodes_pad, tb.num_edges_pad
    x, msgs = _randn(n, D, seed=1), _randn(e, D, seed=2)
    w = np.random.default_rng(3).random(e).astype(np.float32)
    mask = jb.edge_mask if with_mask else None
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(PS.segment_agg_weighted_pallas(
            jnp.asarray(msgs), jnp.asarray(w), jb.receivers, n, mask=mask))
        ref_rows = np.asarray(PS.segment_agg_weighted_pallas(
            jnp.asarray(x)[jb.senders], jnp.asarray(w), jb.receivers, n,
            mask=mask))
    tmask = tb.edge_mask if with_mask else None
    wt = torch.from_numpy(w)
    got = HS.segment_sum_weighted(torch.from_numpy(msgs), tb.receivers, wt,
                                  n, mask=tmask)
    got_rows = HS.segment_sum_weighted(torch.from_numpy(x), tb.receivers, wt,
                                       n, mask=tmask, rows=tb.senders)
    assert PR.counters().get("launch.K7", 0) == 0  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_rows.numpy(), ref_rows, rtol=1e-5,
                               atol=1e-5)
    explicit = HS.segment_sum_weighted_ref(
        torch.from_numpy(x)[tb.senders.long()], tb.receivers, wt, n,
        mask=tmask)
    np.testing.assert_array_equal(got_rows.numpy(), explicit.numpy())
    empty = np.bincount(tb.receivers.numpy(), minlength=n) == 0
    assert np.all(got.numpy()[empty] == 0.0)


def test_bf16_rounds_the_weight_first():
    """bf16 messages: the weight takes the messages' dtype before the
    product, as the TPU kernel's weighted one-hot does; the products and
    the sum are fp32 with one rounding."""
    ids = torch.tensor([0, 0, 1, 3], dtype=torch.int32)
    msgs = torch.tensor([[1.0], [1.0], [3.0], [1.0]], dtype=torch.bfloat16)
    w = torch.tensor([1.0 + 2 ** -10, 1.0, 1.0 / 3.0, 2.0])
    got = HS.segment_sum_weighted(msgs, ids, w, 5)
    assert got.dtype == torch.bfloat16
    wb = w.bfloat16().float()
    want = torch.tensor([[wb[0] + wb[1]], [3.0 * wb[2]], [0.0], [2.0],
                         [0.0]]).bfloat16()
    assert torch.equal(got, want)
    assert float(got[0]) == 2.0  # 1 + 2^-10 rounds to 1 in bf16
    jref = np.asarray(jops.aggregate_edges_weighted(
        jnp.asarray(msgs.float().numpy(), jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(ids.numpy()), 5))
    np.testing.assert_array_equal(got.float().numpy(),
                                  jref.astype(np.float32))


@pytest.mark.parametrize("with_rows", [False, True])
@pytest.mark.parametrize("jax_backend,align", [("xla", False),
                                               ("pallas", True)])
def test_aggregate_edges_weighted_grads_match_jax(jax_backend, align,
                                                  with_rows):
    """Values and d_msgs / d_w against jax.vjp: the port's cuda backend on
    an aligned stream runs K7's plain version with the _sswp_bwd backward;
    on a plain stream the explicit multiply and sorted segment sum. With
    ``rows`` the messages are node rows gathered by senders (the
    WeightedEdgeConv's call), against JAX's explicit gather."""
    jb, tb = _graphs(align)
    n, e = tb.num_nodes_pad, tb.num_edges_pad
    msgs = _randn(n if with_rows else e, D, seed=4)
    ct = _randn(n, D, seed=5)
    w = np.random.default_rng(6).random(e).astype(np.float32)

    def jfn(m, ww):
        if with_rows:
            m = m[jb.senders]
        return jops.aggregate_edges_weighted(
            m, ww, jb.receivers, n, aligned=align, mask=jb.edge_mask)

    with jops.use_backend(jax_backend), pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(jfn, jnp.asarray(msgs), jnp.asarray(w))
        dm_ref, dw_ref = vjp(jnp.asarray(ct))
    mt = torch.from_numpy(msgs).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = tops.aggregate_edges_weighted(
        mt, wt, tb.receivers, n, aligned=align, mask=tb.edge_mask,
        rows=tb.senders if with_rows else None)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(dm_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_ref),
                               rtol=1e-4, atol=1e-5)
