"""Port parity: the sorted segment sum (kernel K5's plain version), the
gather / segment ops with their custom backward passes, and the
sender-sorted stream of the graph builder, against the JAX package (its
Pallas segment kernel in interpret mode, its XLA ops by plain autodiff).
fp32 inputs from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.ops import pallas_segment as PS
from aero_gnn_tpu.ops import scatter as JS
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.ops import hopper_segment as HS
from aero_gnn_tpu_torch.utils import profiling as PR

RTOL, ATOL = 1e-4, 1e-5
D = 16


def _mesh(seed=3, n=300, e=1500):
    rng = np.random.default_rng(seed)
    return dict(senders=rng.integers(0, n, e), receivers=rng.integers(0, n, e),
                x=rng.standard_normal((n, 4)).astype(np.float32),
                edge_attr=rng.standard_normal((e, 8)).astype(np.float32),
                pos=rng.standard_normal((n, 2)).astype(np.float32))


def _graphs(align):
    g = _mesh()
    return (JP.build_graph_batch(**g, align_edges=align),
            TP.build_graph_batch(**g, align_edges=align, device="cpu"))


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("align", [False, True])
def test_sender_stream_matches_jax(align):
    jb, tb = _graphs(align)
    np.testing.assert_array_equal(tb.sender_perm.numpy(),
                                  np.asarray(jb.sender_perm))
    np.testing.assert_array_equal(tb.senders_sorted.numpy(),
                                  np.asarray(jb.senders_sorted))
    assert tb.senders_aligned == align
    # real rows carry their sender; pad slots point at a masked row
    perm = tb.sender_perm.numpy()
    real = tb.edge_mask.numpy()[perm] > 0
    np.testing.assert_array_equal(tb.senders_sorted.numpy()[real],
                                  tb.senders.numpy()[perm][real])
    assert tb.to("cpu").senders_aligned == align


def test_sender_stream_without_masked_row_stays_plain():
    """JAX returns the sender stream unaligned when no edge row is masked
    (graph/padded.py:513-516); the port's plain version
    (padded._align_sender_stream_ref, which native.edge_layout's aligned
    sender stream is held to) does the same and records it."""
    rng = np.random.default_rng(1)
    s = np.sort(rng.integers(0, 600, 3000)).astype(np.int32)
    perm = np.argsort(s, kind="stable").astype(np.int32)
    mask = np.ones(3000, np.float32)
    jp, jk = JP._align_sender_stream(perm, s[perm], mask, 768)
    tp, tk, aligned = TP._align_sender_stream_ref(perm, s[perm], mask, 768)
    assert not aligned
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tk, jk)
    mask[17] = 0.0
    jp, jk = JP._align_sender_stream(perm, s[perm], mask, 768)
    tp, tk, aligned = TP._align_sender_stream_ref(perm, s[perm], mask, 768)
    assert aligned and len(tp) % TP.ALIGN_EDGE_TILE == 0
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tk, jk)


@pytest.mark.parametrize("align,jax_backend", [
    (False, "xla"), (True, "xla"), (True, "pallas")])
def test_gather_senders_value_and_grad_match_jax(align, jax_backend):
    """The port's backward is ct[sender_perm] summed by senders_sorted (K5's
    plain version with ``rows`` when aligned on the cuda backend)."""
    jb, tb = _graphs(align)
    x, ct = _randn(tb.num_nodes_pad, D, seed=1), _randn(tb.num_edges_pad, D,
                                                        seed=2)
    with jops.use_backend(jax_backend), pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a: JS.gather_senders(
            a, jb.senders, jb.sender_perm, jb.senders_sorted, align),
            jnp.asarray(x))
        (dx_ref,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    got = tops.gather_senders(xt, tb.senders, tb.sender_perm,
                              tb.senders_sorted, align)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref),
                               rtol=RTOL, atol=ATOL)


def test_gather_receivers_and_segment_sum_grads_match_jax():
    jb, tb = _graphs(False)
    n, e = tb.num_nodes_pad, tb.num_edges_pad
    x, ct_e = _randn(n, D, seed=3), _randn(e, D, seed=4)
    data, ct_n = _randn(e, D, seed=5), _randn(n, D, seed=6)
    out, vjp = jax.vjp(lambda a: JS.gather_receivers(a, jb.receivers),
                       jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(ct_e))
    xt = torch.from_numpy(x).requires_grad_()
    got = tops.gather_receivers(xt, tb.receivers)
    got.backward(torch.from_numpy(ct_e))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref),
                               rtol=RTOL, atol=ATOL)

    out, vjp = jax.vjp(lambda a: JS.segment_sum_sorted(a, jb.receivers, n),
                       jnp.asarray(data))
    (dd_ref,) = vjp(jnp.asarray(ct_n))
    dt = torch.from_numpy(data).requires_grad_()
    got = tops.segment_sum_sorted(dt, tb.receivers, n)
    got.backward(torch.from_numpy(ct_n))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(dt.grad.numpy(), np.asarray(dd_ref))


@pytest.mark.parametrize("aggregation", ["add", "mean"])
def test_aligned_aggregation_matches_pallas_segment_kernel(aggregation):
    """aggregate_edges on an aligned stream (cuda backend: K5's plain
    version on CPU tensors) against segment_agg_pallas in interpret mode,
    values and gradients; nodes without a real edge get exact zeros."""
    jb, tb = _graphs(True)
    n, e = tb.num_nodes_pad, tb.num_edges_pad
    msgs, ct = _randn(e, D, seed=7), _randn(n, D, seed=8)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda m: PS.segment_agg_pallas(
            m, jb.receivers, n, aggregation=aggregation, mask=jb.edge_mask),
            jnp.asarray(msgs))
        (dm_ref,) = vjp(jnp.asarray(ct))
    mt = torch.from_numpy(msgs).requires_grad_()
    PR.reset_counters()
    got = tops.aggregate_edges(mt, tb.receivers, n, aggregation=aggregation,
                               edge_mask=tb.edge_mask, aligned=True)
    got.backward(torch.from_numpy(ct))
    assert PR.counters().get("launch.K5", 0) == 0  # CPU tensors: plain version
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(dm_ref),
                               rtol=RTOL, atol=ATOL)
    real = tb.edge_mask.numpy() > 0
    deg = np.bincount(tb.receivers.numpy()[real], minlength=n)
    assert np.all(got.detach().numpy()[deg == 0] == 0.0)


def test_segment_sum_rows_and_mask():
    """K5's plain version: ``rows`` gathers first, ``mask`` scales rows;
    the rows fold equals the explicit permutation gather."""
    _, tb = _graphs(True)
    n = tb.num_nodes_pad
    data = torch.from_numpy(_randn(tb.num_edges_pad, D, seed=9))
    folded = HS.segment_sum(data, tb.senders_sorted, n, rows=tb.sender_perm)
    explicit = HS.segment_sum_ref(data[tb.sender_perm.long()],
                                  tb.senders_sorted, n)
    np.testing.assert_array_equal(folded.numpy(), explicit.numpy())
    m = tb.edge_mask
    masked = HS.segment_sum(data, tb.receivers, n, mask=m)
    np.testing.assert_allclose(
        masked.numpy(),
        HS.segment_sum_ref(data * m[:, None], tb.receivers, n).numpy(),
        rtol=RTOL, atol=ATOL)


def test_batch_graphs_matches_jax():
    meshes = [_mesh(seed=s, n=100 + 20 * s, e=400 + 50 * s) for s in (1, 2)]
    for g in meshes:
        g["y"] = np.zeros((g["x"].shape[0], 2), np.float32)
    for align in (False, True):
        kw = dict(num_nodes_pad=512, num_edges_pad=(8 * 1024 if align
                                                    else 1024),
                  num_graphs_pad=3, align_edges=align)
        jb = JP.batch_graphs(meshes, **kw)
        tb = TP.batch_graphs(meshes, **kw, device="cpu")
        for name in ("senders", "receivers", "sender_perm", "senders_sorted",
                     "x", "edge_attr", "edge_mask", "node_mask", "node_graph",
                     "graph_mask"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=f"{name} align={align}")
