"""Port parity for the saved-activation path (AERO_GNN_SAVE_ACTS=1): the
save variant of K1 and kernel K8 through their plain versions, against the
JAX package's _fused_fwd(save_acts=True) and _fused_bwd_saved, whose Pallas
kernels run in interpret mode; the autograd Function's routing under the
knob. fp32 inputs from a numpy seed, h = 32. The first-step gradients of a
small MGN under the knob are in test_torch_mega.py."""

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

# fp32 on the CPU: the forward's values are of order 1 (rtol 1e-4 / atol
# 1e-5); weight gradients sum thousands of rows, so their atol scales with
# the leaf (as in test_torch_fused_edge_bwd.py)
RTOL, ATOL = 1e-4, 1e-5
H = 32
ORDER = ("e", "sg", "d_proj", "mask", "receivers", "w_e", "ws", "bs",
         "w_out", "b_out", "ln_scale", "ln_bias")
DIFF = (0, 1, 2, 5, 6, 7, 8, 9, 10, 11)  # positions with a gradient
GRADS = ("d_e", "d_sg", "d_dproj", "dW_e", "dWs", "dbs", "dW_out", "db_out",
         "dscale", "dbias")


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
    return jargs, targs, N, ct_e, ct_agg, real


@pytest.mark.parametrize("n_hidden", [0, 2])
def test_save_forward_matches_jax(n_hidden):
    """(e', agg, zs, d, mu, inv) of the plain save variant against the JAX
    save_acts forward kernel; e' and the saved rows on real edges only
    (pad rows are never observed)."""
    jargs, targs, N, _, _, real = _case(n_hidden)
    with pltpu.force_tpu_interpret_mode():
        ref = PF._fused_fwd(*jargs, N, "relu", save_acts=True)
    out = HF.fused_edge_layer_save(*targs, N)
    assert len(out) == len(ref) == 6
    assert out[2].shape == (n_hidden + 1, real.size, H)
    for name, o, r in zip(("e'", "agg", "zs", "d", "mu", "inv"), out, ref):
        o, r = o.numpy(), np.asarray(r)
        if name == "zs":
            o, r = o[:, real], r[:, real]
        elif name != "agg":
            o = o.reshape(real.size, -1)[real]
            r = r.reshape(real.size, -1)[real]
        np.testing.assert_allclose(o, r, rtol=RTOL, atol=ATOL, err_msg=name)
    # the save variant's (e', agg) are K1's
    for a, b in zip(out[:2], HF.fused_edge_layer(*targs, N)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_hidden", [0, 2])
def test_saved_backward_matches_jax(n_hidden):
    """K8's plain version against the JAX saved backward kernel on the same
    saved activations (those of the JAX save forward)."""
    jargs, targs, N, ct_e, ct_agg, _ = _case(n_hidden)
    e, mask, recv = jargs[0], jargs[3], jargs[4]
    w_e, ws, bs, w_out, b_out, ln_scale, ln_bias = jargs[5:]
    with pltpu.force_tpu_interpret_mode():
        saved = PF._fused_fwd(*jargs, N, "relu", save_acts=True)[2:]
        ref = PF._fused_bwd_saved(
            e, mask, recv, w_e, ws, w_out, ln_scale, saved, N,
            (jnp.asarray(ct_e), jnp.asarray(ct_agg)), bs_shape=bs,
            b_out_shape=b_out, ln_bias_shape=ln_bias)
    ref = [r for r in ref if r is not None]  # no sg / d_proj cotangent slot
    zs, d, mu, inv = (torch.from_numpy(np.array(a)) for a in saved)
    t = dict(zip(ORDER, targs))
    out = HF.fused_edge_layer_bwd_saved(
        t["e"], t["mask"], t["receivers"], t["w_e"], t["ws"], t["w_out"],
        t["ln_scale"], zs, d, mu[:, 0], inv[:, 0], torch.from_numpy(ct_e),
        torch.from_numpy(ct_agg), N)
    assert len(out) == len(ref) == len(GRADS)
    for name, o, r in zip(GRADS, out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=RTOL,
                                   atol=ATOL * np.abs(r).max(initial=1.0),
                                   err_msg=name)


def _port_grads(targs, N, ct_e, ct_agg):
    leaves = [t.clone().requires_grad_() if i in DIFF else t
              for i, t in enumerate(targs)]
    e2, agg = HF.fused_edge_layer_autograd(*leaves, N)
    torch.autograd.backward((e2, agg), (torch.from_numpy(ct_e),
                                        torch.from_numpy(ct_agg)))
    return (e2.detach(), agg.detach()), [leaves[i].grad for i in DIFF]


def test_knob_routes_autograd_to_save_variant_and_k8(monkeypatch):
    """With AERO_GNN_SAVE_ACTS=1 a call that needs a gradient runs the save
    variant forward and K8 backward (their wrappers; plain versions on CPU
    tensors), never K2; the values and gradients equal the knob-off path's
    and match jax.vjp of the JAX layer under the same knob. Without a
    gradient to take, K1 serves."""
    jargs, targs, N, ct_e, ct_agg, real = _case(2)
    calls = []

    def spy(name):
        fn = getattr(HF, name)

        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(HF, name, wrapped)

    for name in ("fused_edge_layer", "fused_edge_layer_save",
                 "fused_edge_layer_bwd", "fused_edge_layer_bwd_saved"):
        spy(name)
    off_out, off_grads = _port_grads(targs, N, ct_e, ct_agg)
    assert calls == ["fused_edge_layer", "fused_edge_layer_bwd"]
    monkeypatch.setenv("AERO_GNN_SAVE_ACTS", "1")
    assert HF.save_acts_enabled()
    calls.clear()
    on_out, on_grads = _port_grads(targs, N, ct_e, ct_agg)
    assert calls == ["fused_edge_layer_save", "fused_edge_layer_bwd_saved"]
    for a, b in zip(on_out + tuple(on_grads), off_out + tuple(off_grads)):
        assert torch.equal(a, b)
    calls.clear()
    with torch.no_grad():
        HF.fused_edge_layer_autograd(*targs, N)
    assert calls == ["fused_edge_layer"]

    def f(*diff):
        a = list(jargs)
        for i, v in zip(DIFF, diff):
            a[i] = v
        return PF.fused_edge_layer(*a, N, "relu")

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *[jargs[i] for i in DIFF])
        ref = vjp((jnp.asarray(ct_e), jnp.asarray(ct_agg)))
    np.testing.assert_allclose(on_out[0].numpy()[real],
                               np.asarray(out[0])[real], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(on_out[1].numpy(), np.asarray(out[1]),
                               rtol=RTOL, atol=ATOL)
    for i, g, r in zip(DIFF, on_grads, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL,
                                   atol=ATOL * np.abs(r).max(initial=1.0),
                                   err_msg=ORDER[i])


def test_saved_backward_checks_shapes():
    """The argument checks the K8 wrapper makes before a launch (on CUDA
    tensors only, so called directly here): zs [n_hidden + 1, E, h] of the
    compute dtype, mu / inv [E] fp32."""
    E, N, h = HF.ET, HF.NB, 64
    e, ws = torch.zeros(E, h), torch.zeros(2, h, h)
    recv = torch.zeros(E, dtype=torch.int32)
    assert HF._check_args(e, recv, N, ws=ws, zs=torch.zeros(3, E, h),
                          mu=torch.zeros(E), inv=torch.zeros(E)) == (E, h, 2)
    with pytest.raises(ValueError, match="zs has shape"):
        HF._check_args(e, recv, N, ws=ws, zs=torch.zeros(2, E, h))
    with pytest.raises(ValueError, match="mu has dtype"):
        HF._check_args(e, recv, N, ws=ws,
                       mu=torch.zeros(E, dtype=torch.float64))
