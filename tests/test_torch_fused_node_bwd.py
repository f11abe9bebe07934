"""Port parity: the fused node layer's backward (kernel K4's plain version,
through the autograd Function whose forward is K3's) against jax.vjp of the
JAX package's fused_node_layer, whose custom VJP runs its Pallas backward
kernel in interpret mode, and of its reference composition _equiv. fp32
inputs from a numpy seed, h = 32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu.ops import pallas_node as PN
from aero_gnn_tpu_torch.ops import hopper_node as HN
from aero_gnn_tpu_torch.utils import profiling as PR

# atol scales with the leaf: weight gradients sum thousands of fp32 rows of
# order 1 (values ~1e2), where the summation order alone moves ~2e-5
RTOL, ATOL = 1e-4, 1e-5
H = 32
NAMES = ("x", "agg", "w1x", "w1a", "b1", "ws", "bs", "w_out", "b_out",
         "ln_scale", "ln_bias")


def _arrays(n_hidden):
    rng = np.random.default_rng(11 + n_hidden)

    def f(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    arrays = [f(512, H), f(512, H, scale=3.0), f(H, H, scale=0.2),
              f(H, H, scale=0.2), f(H, scale=0.1), f(n_hidden, H, H, scale=0.2),
              f(n_hidden, H, scale=0.1), f(H, H, scale=0.2), f(H, scale=0.1),
              1 + f(H, scale=0.1), f(H, scale=0.1)]
    return arrays, f(512, H)


@pytest.mark.parametrize("reference", ["pallas", "equiv"])
@pytest.mark.parametrize("n_hidden", [0, 2])
def test_fused_node_grads_match_jax(n_hidden, reference):
    arrays, ct = _arrays(n_hidden)
    jargs = list(map(jnp.asarray, arrays))
    fn = PN.fused_node_layer if reference == "pallas" else PN._equiv
    with pltpu.force_tpu_interpret_mode():
        value, vjp = jax.vjp(fn, *jargs)
        ref = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    PR.reset_counters()
    out = HN.fused_node_layer_autograd(*leaves)
    out.backward(torch.from_numpy(ct))
    assert PR.counters().get("launch.K4", 0) == 0  # CPU: plain version
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(value),
                               rtol=RTOL, atol=ATOL)
    for name, leaf, r in zip(NAMES, leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=RTOL,
                                   atol=ATOL * np.abs(r).max(initial=1.0),
                                   err_msg=name)


def test_fused_node_bwd_raw_wrapper_returns_fp32_weight_grads():
    arrays, ct = _arrays(2)
    grads = HN.fused_node_layer_bwd(*map(torch.from_numpy, arrays),
                                    torch.from_numpy(ct))
    assert len(grads) == 11
    assert all(g.dtype == torch.float32 for g in grads[2:])
    assert tuple(grads[5].shape) == (2, H, H)
