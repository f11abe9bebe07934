"""Port parity: aero_gnn_tpu_torch.nn.mlp against aero_gnn_tpu.nn.mlp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aero_gnn_tpu.nn import mlp as JM
from aero_gnn_tpu_torch.models.convert import load_mlp
from aero_gnn_tpu_torch.nn import mlp as TM

RTOL, ATOL = 2e-4, 2e-5  # fp32 CPU bar (tests/test_reference_parity.py)


@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("num_hidden_layers", [0, 1, 2])
def test_mlp_apply_matches_jax(num_hidden_layers, use_ln):
    tree = JM.mlp_init(jax.random.PRNGKey(num_hidden_layers), 7, 32, 5,
                       num_hidden_layers=num_hidden_layers,
                       use_layer_norm=use_ln)
    x = np.random.default_rng(0).standard_normal((50, 7)).astype(np.float32)
    ref = np.asarray(JM.mlp_apply(tree, jnp.asarray(x), activation="relu"))

    mlp = TM.MLP(7, 32, 5, num_hidden_layers=num_hidden_layers,
                 use_layer_norm=use_ln)
    assert len(mlp.linears) == len(TM.mlp_dims(7, 32, 5, num_hidden_layers))
    load_mlp(mlp, jax.tree.map(np.asarray, tree))
    with torch.no_grad():
        out = TM.mlp_apply(mlp, torch.from_numpy(x), activation="relu")
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_linear_init_bounds_and_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a, b = TM.Linear(16, 8, generator=g1), TM.Linear(16, 8, generator=g2)
    assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)
    assert a.w.shape == (16, 8)  # [in, out], the JAX layout
    assert float(a.w.detach().abs().max()) <= 0.25
    assert float(a.b.detach().abs().max()) <= 0.25


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="Unsupported activation"):
        TM.activation_fn("softplus2")
