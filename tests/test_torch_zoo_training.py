"""Port parity for training the registry's model zoo: FourierMGN's
first-step gradients against jax.value_and_grad of the JAX package (via
params_to_jax), and five Adam steps of each new kind tracking the JAX
losses, through a two-mesh Loader batch (tests/test_torch_zoo.py)."""

import jax
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu
from test_torch_zoo import MODELS, build_pair, loader_batches

from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.training import loop as JL
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.models.convert import params_to_jax
from aero_gnn_tpu_torch.training import loop as TL


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("jax_backend,remat,port_backend", [
    ("xla", True, "cuda"), ("xla", True, "torch"), ("pallas", False, "cuda")])
def test_fouriermgn_first_step_grads_match_jax(jax_backend, remat,
                                               port_backend):
    """port_backend "cuda": the unfused layer with K6's and K5's plain
    versions (K6's backward and the aggregation with the pad sink), under
    per-layer checkpoints when remat is on. Interpret-mode pallas_call
    cannot sit under jax.checkpoint, so the pallas reference runs with
    remat off."""
    jb, tb, _ = loader_batches()
    mc = dict(MODELS["fouriermgn"], remat=remat)
    jcfg, tree, tcfg, params = build_pair(mc)

    def loss_fn(p):
        return JL.masked_mse(jcfg.apply(p, jb), jb.y, jb.node_mask)

    with jops.use_backend(jax_backend), pltpu.force_tpu_interpret_mode():
        jloss, jgrads = jax.value_and_grad(loss_fn)(tree)
    with tops.use_backend(port_backend):
        loss = TL.masked_mse(tcfg.apply(params, tb), tb.y, tb.node_mask)
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    tgrads = _leaves(params_to_jax(params, tcfg, grads=True))
    jgrads = _leaves(jgrads)
    assert tgrads.keys() == jgrads.keys()
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], g, rtol=1e-3,
                                   atol=1e-5 * np.abs(g).max(initial=1e-30),
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["fouriermgn", "poolmgn_mean", "mgn_v2",
                                  "mlpnet"])
def test_five_adam_steps_track_jax(kind):
    jb, tb, _ = loader_batches()
    jcfg, tree, tcfg, params = build_pair(MODELS[kind])
    opt = JL.make_optimizer(1e-3)
    fns = JL.make_step_fns(jcfg, opt, donate=False)
    p, st, jlosses = tree, opt.init(tree), []
    for _ in range(5):
        p, st, loss = fns.train_step(p, st, jb, None, None)
        jlosses.append(float(loss))
    tfns = TL.make_step_fns(tcfg, TL.make_optimizer(params, 1e-3),
                            device="cpu")
    tlosses = [float(tfns.train_step(params, tb)) for _ in range(5)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
