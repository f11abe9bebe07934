"""K5's plain version at every width class its kernel dispatches on
(csrc/segment_sum.cu): 1 and 34 values (no whole 16-byte pieces: lane
groups with single values), 4 (lane groups with 4-value vectors), 128
(the bulk-copy ring) and 640 (lane groups in column blocks), on both of
its streams, against the JAX package: the sender backward's stream
(``rows`` = sender_perm, pad sink declared) against the XLA sorted
segment sum of the gathered cotangent, and the unfused aggregation's
receiver stream (edge mask, pad sink declared) against
``segment_agg_pallas`` in interpret mode. fp32 inputs from a numpy seed;
the cotangent is zero on pad rows, as on the training path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.ops import pallas_segment as PS
from aero_gnn_tpu.ops import scatter as JS
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.ops import hopper_segment as HS

RTOL, ATOL = 1e-4, 1e-5
WIDTHS = (1, 4, 34, 128, 640)


def _graphs(seed=5, n=300, e=1400):
    rng = np.random.default_rng(seed)
    g = dict(senders=rng.integers(0, n, e), receivers=rng.integers(0, n, e),
             x=rng.standard_normal((n, 4)).astype(np.float32),
             edge_attr=rng.standard_normal((e, 3)).astype(np.float32),
             pos=rng.standard_normal((n, 2)).astype(np.float32))
    return (JP.build_graph_batch(**g, align_edges=True),
            TP.build_graph_batch(**g, align_edges=True, device="cpu"))


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


def _data(rows, h, mask, seed):
    d = np.random.default_rng(seed).standard_normal((rows, h)).astype(
        np.float32)
    return d * mask[:, None]


@pytest.mark.parametrize("h", WIDTHS)
def test_sender_stream_matches_jax(graphs, h):
    jb, tb = graphs
    n = tb.num_nodes_pad
    assert tb.senders_aligned
    mask = tb.edge_mask.numpy()
    ct = _data(tb.num_edges_pad, h, mask, seed=h)
    perm = tb.sender_perm.numpy()
    ref = JS.segment_sum_sorted(jnp.asarray(ct)[jnp.asarray(perm)],
                                jb.senders_sorted, n)
    got = HS.segment_sum(torch.from_numpy(ct), tb.senders_sorted, n,
                         rows=tb.sender_perm, pad_sink=True)
    assert got.shape == (n, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    empty = np.bincount(tb.senders_sorted.numpy()[mask[perm] > 0],
                        minlength=n) == 0
    assert np.all(got.numpy()[empty] == 0.0)


@pytest.mark.parametrize("h", WIDTHS)
def test_receiver_stream_matches_pallas(graphs, h):
    jb, tb = graphs
    n = tb.num_nodes_pad
    msgs = np.random.default_rng(100 + h).standard_normal(
        (tb.num_edges_pad, h)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = PS.segment_agg_pallas(jnp.asarray(msgs), jb.receivers, n,
                                    mask=jb.edge_mask)
    got = HS.segment_sum(torch.from_numpy(msgs), tb.receivers, n,
                         mask=tb.edge_mask, pad_sink=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert np.all(got.numpy()[-1] == 0.0)  # the pad sink


@pytest.mark.parametrize("h", WIDTHS)
def test_receiver_stream_without_mask_matches_jax(graphs, h):
    """K6's backward: the receiver stream, no rows, no mask, the pad sink
    declared (its rows' cotangent zero)."""
    jb, tb = graphs
    n = tb.num_nodes_pad
    ct = _data(tb.num_edges_pad, h, tb.edge_mask.numpy(), seed=200 + h)
    ref = JS.segment_sum_sorted(jnp.asarray(ct), jb.receivers, n)
    got = HS.segment_sum(torch.from_numpy(ct), tb.receivers, n,
                         pad_sink=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)

