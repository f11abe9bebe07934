"""Port parity: the fused node layer (kernel K3's plain version) against the
JAX package's reference composition and its Pallas kernel in interpret mode.
On CPU tensors the wrapper runs the plain version and launches nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu.ops import pallas_node as PN
from aero_gnn_tpu_torch.ops import hopper_node as HN

RTOL, ATOL = 2e-4, 2e-5  # fp32 CPU bar (tests/test_reference_parity.py)
H = 32


@pytest.mark.parametrize("n_hidden", [0, 2])
def test_fused_node_plain_matches_jax(n_hidden):
    rng = np.random.default_rng(11 + n_hidden)

    def f(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    arrays = [f(512, H), f(512, H, scale=3.0), f(H, H, scale=0.2),
              f(H, H, scale=0.2), f(H, scale=0.1), f(n_hidden, H, H, scale=0.2),
              f(n_hidden, H, scale=0.1), f(H, H, scale=0.2), f(H, scale=0.1),
              1 + f(H, scale=0.1), f(H, scale=0.1)]
    HN.fused_node_layer.launches = 0
    out = HN.fused_node_layer(*map(torch.from_numpy, arrays)).numpy()
    assert HN.fused_node_layer.launches == 0  # CPU tensors: plain version

    jargs = list(map(jnp.asarray, arrays))
    ref = np.asarray(PN._equiv(*jargs))
    with pltpu.force_tpu_interpret_mode():
        pk = np.asarray(PN.fused_node_layer(*jargs))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, pk, rtol=RTOL, atol=ATOL)
