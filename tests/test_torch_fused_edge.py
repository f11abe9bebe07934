"""Port parity: the fused edge layer (kernel K1's plain version) against the
JAX package's reference composition and its Pallas kernel in interpret mode.
On CPU tensors the wrapper runs the plain version and launches nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.ops import pallas_fused as PF
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.ops import hopper_fused as HF
from aero_gnn_tpu_torch.utils import profiling as PR

RTOL, ATOL = 2e-4, 2e-5  # fp32 CPU bar (tests/test_reference_parity.py)
H = 32


def _case(n_hidden, seed=5):
    rng = np.random.default_rng(3)
    n, e = 300, 1500
    g = dict(senders=rng.integers(0, n, e), receivers=rng.integers(0, n, e),
             x=rng.standard_normal((n, 4)).astype(np.float32),
             edge_attr=rng.standard_normal((e, 8)).astype(np.float32),
             pos=rng.standard_normal((n, 2)).astype(np.float32))
    jb = JP.build_graph_batch(**g, align_edges=True)
    tb = TP.build_graph_batch(**g, align_edges=True, device="cpu")
    E, N = tb.num_edges_pad, tb.num_nodes_pad
    r = np.random.default_rng(seed)

    def f(*s, scale=1.0):
        return (r.standard_normal(s) * scale).astype(np.float32)

    arrays = dict(e=f(E, H), sg=f(E, H), d_proj=f(N, H),
                  w_e=f(H, H, scale=0.2), ws=f(n_hidden, H, H, scale=0.2),
                  bs=f(n_hidden, H, scale=0.1), w_out=f(H, H, scale=0.2),
                  b_out=f(H, scale=0.1), ln_scale=1 + f(H, scale=0.1),
                  ln_bias=f(H, scale=0.1))
    order = ("e", "sg", "d_proj", "mask", "receivers", "w_e", "ws", "bs",
             "w_out", "b_out", "ln_scale", "ln_bias")
    jargs = [jnp.asarray(arrays[k]) if k in arrays else
             (jb.edge_mask if k == "mask" else jb.receivers) for k in order]
    targs = [torch.from_numpy(arrays[k]) if k in arrays else
             (tb.edge_mask if k == "mask" else tb.receivers) for k in order]
    return jargs, targs, N, tb.edge_mask.numpy() > 0


@pytest.mark.parametrize("n_hidden", [0, 2])
def test_fused_edge_plain_matches_jax(n_hidden):
    jargs, targs, N, real = _case(n_hidden)
    PR.reset_counters()
    e2, agg = HF.fused_edge_layer(*targs, N, "relu")
    assert PR.counters().get("launch.K1", 0) == 0  # CPU tensors: plain version
    e2, agg = e2.numpy(), agg.numpy()

    e_ref, agg_ref = PF._equiv(*jargs, num_nodes=N)
    with pltpu.force_tpu_interpret_mode():
        e_pk, agg_pk = PF.fused_edge_layer(*jargs, N, "relu")
    for name, (ej, aj) in {"equiv": (e_ref, agg_ref),
                           "pallas": (e_pk, agg_pk)}.items():
        # pad-edge rows of e' are never observed: compare real rows only
        np.testing.assert_allclose(e2[real], np.asarray(ej)[real],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(agg, np.asarray(aj), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    deg = np.bincount(targs[4].numpy()[real], minlength=N)
    assert np.all(agg[deg == 0] == 0.0)  # empty nodes, pad node included


def test_fused_edge_rejects_other_activations():
    jargs, targs, N, _ = _case(0)
    with pytest.raises(ValueError, match="relu"):
        HF.fused_edge_layer(*targs, N, "gelu")
