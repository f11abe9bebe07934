"""Port parity: the fused edge layer's backward (kernel K2's plain version,
through the autograd Function whose forward is K1's) against jax.vjp of the
JAX package's fused_edge_layer, whose custom VJP runs its Pallas backward
kernel in interpret mode, and of its reference composition _equiv. fp32
inputs from a numpy seed, h = 32."""

import jax
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

# atol scales with the leaf: weight gradients sum thousands of fp32 rows of
# order 1 (values ~1e2), where the summation order alone moves ~2e-5
RTOL, ATOL = 1e-4, 1e-5
H = 32
ORDER = ("e", "sg", "d_proj", "mask", "receivers", "w_e", "ws", "bs",
         "w_out", "b_out", "ln_scale", "ln_bias")
DIFF = (0, 1, 2, 5, 6, 7, 8, 9, 10, 11)  # positions with a gradient


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
    real = tb.edge_mask.numpy() > 0
    # pad edges never reach the loss: their cotangent is zero
    ct_e = f(E, H) * real[:, None]
    ct_agg = f(N, H)
    jargs = [jnp.asarray(arrays[k]) if k in arrays else
             (jb.edge_mask if k == "mask" else jb.receivers) for k in ORDER]
    targs = [torch.from_numpy(arrays[k]) if k in arrays else
             (tb.edge_mask if k == "mask" else tb.receivers) for k in ORDER]
    return jargs, targs, N, ct_e, ct_agg


def _jax_grads(fn, jargs, ct_e, ct_agg):
    def f(*diff):
        a = list(jargs)
        for i, v in zip(DIFF, diff):
            a[i] = v
        return fn(*a)

    out, vjp = jax.vjp(f, *[jargs[i] for i in DIFF])
    grads = vjp((jnp.asarray(ct_e), jnp.asarray(ct_agg)))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("reference", ["pallas", "equiv"])
@pytest.mark.parametrize("n_hidden", [0, 2])
def test_fused_edge_grads_match_jax(n_hidden, reference):
    jargs, targs, N, ct_e, ct_agg = _case(n_hidden)
    if reference == "pallas":
        with pltpu.force_tpu_interpret_mode():
            out, ref = _jax_grads(
                lambda *a: PF.fused_edge_layer(*a, N, "relu"), jargs, ct_e,
                ct_agg)
    else:
        out, ref = _jax_grads(lambda *a: PF._equiv(*a, num_nodes=N), jargs,
                              ct_e, ct_agg)
    leaves = [t.clone().requires_grad_() if i in DIFF else t
              for i, t in enumerate(targs)]
    PR.reset_counters()
    e2, agg = HF.fused_edge_layer_autograd(*leaves, N)
    torch.autograd.backward((e2, agg), (torch.from_numpy(ct_e),
                                        torch.from_numpy(ct_agg)))
    assert PR.counters().get("launch.K2", 0) == 0  # CPU: plain version
    real = targs[3].numpy() > 0  # pad-edge rows of e' are never observed
    np.testing.assert_allclose(e2.detach().numpy()[real], out[0][real],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(agg.detach().numpy(), out[1], rtol=RTOL,
                               atol=ATOL)
    for i, r in zip(DIFF, ref):
        np.testing.assert_allclose(leaves[i].grad.numpy(), r, rtol=RTOL,
                                   atol=ATOL * np.abs(r).max(initial=1.0),
                                   err_msg=ORDER[i])


def test_fused_edge_bwd_pad_rows_and_weight_dtype():
    """With a zero cotangent on pad rows, d_sg is exactly zero there (the
    sender backward's pad slots rely on it, graph/padded.py); weight
    gradients come back fp32 from the raw backward."""
    jargs, targs, N, ct_e, ct_agg = _case(2)
    grads = HF.fused_edge_layer_bwd(*targs, torch.from_numpy(ct_e),
                                    torch.from_numpy(ct_agg), N)
    pad = targs[3].numpy() == 0
    assert np.all(grads[1].numpy()[pad] == 0.0)
    assert all(g.dtype == torch.float32 for g in grads[3:])
    assert tuple(grads[4].shape) == (2, H, H)
