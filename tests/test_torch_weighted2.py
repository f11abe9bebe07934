"""Port parity for kernel K10 (two weighted segment sums over one receiver
stream, the WEC pair probe): segment_sum_weighted2's plain version against
the JAX package's segment_agg_weighted2_pallas (interpret mode) and against
two single weighted segment sums of either package, on the aligned layout
of benchmarks/micro_wec2.py (zero weights on pad edges). Inputs from a
numpy seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.ops import pallas_segment as PS
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.ops import hopper_segment as HS

H = 32
# fp32: the kernels sum up to a node's degree of products of order 1 in
# another order than the plain version (rtol 1e-5 / atol 1e-5); bf16: the
# TPU kernel rounds each tile's contribution to bf16 before it adds it, the
# port accumulates in fp32 and rounds once, a few bf16 ulps (2^-8) apart
TOLS = {"float32": (1e-5, 1e-5), "bfloat16": (1.6e-2, 3.2e-2)}


@pytest.fixture(scope="module")
def case():
    s = JS.make_random_mesh_sample(n_nodes=500, avg_degree=6, seed=4)
    JD.compute_features([s], ["mach", "alpha"])
    g = dict(senders=s.senders, receivers=s.receivers, x=s.x,
             edge_attr=s.edge_attr, pos=s.pos, y=s.y)
    np_pad = -(-(s.num_nodes + 1) // 512) * 512  # as micro_wec2.py pads
    jb = JP.build_graph_batch(**g, num_nodes_pad=np_pad, align_edges=True)
    tb = TP.build_graph_batch(**g, num_nodes_pad=np_pad, align_edges=True,
                              device="cpu")
    E = tb.num_edges_pad
    rng = np.random.default_rng(0)
    em = tb.edge_mask.numpy()
    arrays = (rng.standard_normal((E, H)).astype(np.float32),
              (rng.standard_normal(E) * em).astype(np.float32),
              rng.standard_normal((E, H)).astype(np.float32),
              (rng.standard_normal(E) * em).astype(np.float32))
    return jb, tb, arrays


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted2_matches_jax(case, dtype):
    jb, tb, (m1, w1, m2, w2) = case
    N = tb.num_nodes_pad
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = PS.segment_agg_weighted2_pallas(
            jnp.asarray(m1).astype(jdt), jnp.asarray(w1),
            jnp.asarray(m2).astype(jdt), jnp.asarray(w2), jb.receivers, N)
    out = tops.segment_sum_weighted2(
        torch.from_numpy(m1).to(tdt), torch.from_numpy(w1),
        torch.from_numpy(m2).to(tdt), torch.from_numpy(w2), tb.receivers, N)
    rtol, atol = TOLS[dtype]
    for o, r in zip(out, ref):
        assert o.dtype == tdt and o.shape == (N, H)
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)


def test_weighted2_is_two_weighted_sums(case):
    """The pair equals two K7 calls of the port (its plain version) bit for
    bit, and two segment_agg_weighted_pallas calls of the JAX package within
    the fp32 tolerance; pad edges add nothing (their weights are 0)."""
    jb, tb, (m1, w1, m2, w2) = case
    N = tb.num_nodes_pad
    t = [torch.from_numpy(a) for a in (m1, w1, m2, w2)]
    out = HS.segment_sum_weighted2(*t, tb.receivers, N)
    singles = (HS.segment_sum_weighted(t[0], tb.receivers, t[1], N),
               HS.segment_sum_weighted(t[2], tb.receivers, t[3], N))
    with pltpu.force_tpu_interpret_mode():
        jax_singles = [PS.segment_agg_weighted_pallas(
            jnp.asarray(m), jnp.asarray(w), jb.receivers, N)
            for m, w in ((m1, w1), (m2, w2))]
    for o, s, j in zip(out, singles, jax_singles):
        assert torch.equal(o, s)
        np.testing.assert_allclose(o.numpy(), np.asarray(j),
                                   rtol=TOLS["float32"][0],
                                   atol=TOLS["float32"][1])
    pad = tb.edge_mask.numpy() == 0
    assert pad.any() and (w1[pad] == 0).all() and (w2[pad] == 0).all()
    recv = tb.receivers.numpy()
    empty = np.bincount(recv[~pad], minlength=N) == 0
    assert empty.any()
    for o in out:
        assert (o.numpy()[empty] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted2_zero_weights_on_different_rows(case, dtype):
    """w1 and w2 zero on different real rows (each stream drops a row only
    where its own weight is 0, csrc/segment_pair.cuh): the port's plain
    version against segment_agg_weighted2_pallas in interpret mode, and a
    node whose only real rows have w1 = 0 gets 0 in out1 and its sum in
    out2."""
    jb, tb, (m1, w1, m2, w2) = case
    N = tb.num_nodes_pad
    recv = tb.receivers.numpy()
    real = np.flatnonzero(tb.edge_mask.numpy() != 0)
    w1, w2 = w1.copy(), w2.copy()
    w1[real[0::3]] = 0.0
    w2[real[1::3]] = 0.0
    # every real row of one node without a weight in stream 1 only
    node = recv[real[len(real) // 2]]
    rows = real[recv[real] == node]
    w1[rows], w2[rows] = 0.0, 1.0 + np.arange(len(rows), dtype=np.float32)
    assert ((w1 == 0) != (w2 == 0)).any()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = PS.segment_agg_weighted2_pallas(
            jnp.asarray(m1).astype(jdt), jnp.asarray(w1),
            jnp.asarray(m2).astype(jdt), jnp.asarray(w2), jb.receivers, N)
    t1, t2 = (torch.from_numpy(m).to(tdt) for m in (m1, m2))
    out = HS.segment_sum_weighted2(t1, torch.from_numpy(w1), t2,
                                   torch.from_numpy(w2), tb.receivers, N)
    rtol, atol = TOLS[dtype]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)
    assert (out[0][node] == 0).all()
    expect = (t2[rows].float() * torch.from_numpy(w2[rows]).to(tdt).float()
              [:, None]).sum(0).to(tdt)
    assert torch.equal(out[1][node], expect)

