"""Port parity: the flagship MeshGraphNet structure at small width (h = 32,
3 layers, 2 hidden layers per MLP, concat trick) with JAX-initialised
weights carried over by params_from_jax, against JAX MGNConfig.apply on the
xla backend and on the pallas backend in interpret mode."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.models.convert import params_from_jax
from aero_gnn_tpu_torch.models.mgn import MGNConfig

RTOL, ATOL = 2e-4, 2e-5  # fp32 CPU bar (tests/test_reference_parity.py)
H = 32

_SMALL = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
              processor_size=3, hidden_dim_processor=H,
              hidden_dim_node_encoder=H, hidden_dim_edge_encoder=H,
              hidden_dim_decoder=H, num_hidden_layers_node_processor=2,
              num_hidden_layers_edge_processor=2,
              num_hidden_layers_node_encoder=2,
              num_hidden_layers_edge_encoder=2, num_hidden_layers_decoder=2,
              do_concat_trick=True)


def _graphs(align=True):
    s = JS.make_random_mesh_sample(n_nodes=500, avg_degree=6, seed=2)
    JD.compute_features([s], ["mach", "alpha"])
    g = dict(senders=s.senders, receivers=s.receivers, x=s.x,
             edge_attr=s.edge_attr, pos=s.pos, y=s.y)
    return (JP.build_graph_batch(**g, align_edges=align),
            TP.build_graph_batch(**g, align_edges=align, device="cpu"),
            s.num_nodes)


def _run(cfg_kw, jax_backend, port_backend):
    jcfg = JaxMGNConfig(**_SMALL, **cfg_kw)
    tcfg = MGNConfig(**_SMALL, **cfg_kw)
    tree = jcfg.init(jax.random.PRNGKey(7))
    jb, tb, n = _graphs()
    with jops.use_backend(jax_backend), pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jcfg.apply(tree, jb))[:n]
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")
    with tops.use_backend(port_backend):
        out = tcfg.apply(params, tb).numpy()[:n]
    return out, ref


@pytest.mark.parametrize("port_backend", ["cuda", "torch"])
@pytest.mark.parametrize("jax_backend,aggregation,separate", [
    ("xla", "add", False), ("xla", "mean", False), ("xla", "add", True),
    ("pallas", "add", False), ("pallas", "mean", True)])
def test_mgn_forward_matches_jax(jax_backend, aggregation, separate,
                                 port_backend):
    """port_backend "cuda" takes the fused path (K1/K3 plain versions on CPU
    tensors); "torch" the unfused plain composition."""
    out, ref = _run(dict(aggregation=aggregation,
                         separate_decoders=separate), jax_backend,
                    port_backend)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_mgn_bfloat16_matches_jax():
    # bf16 keeps 8 mantissa bits (eps 2^-8 = 3.9e-3); the two frameworks
    # round at the same ops but may keep fp32 across fused elementwise ops
    # (XLA) or not (PyTorch), and a 1-ulp flip propagates through 3 layers:
    # 3e-2 absolute on outputs of order 1 is a few ulps.
    out, ref = _run(dict(compute_dtype="bfloat16"), "xla", "cuda")
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=3e-2, atol=3e-2)


def test_mgn_unaligned_graph_and_layer_count_check():
    jcfg = JaxMGNConfig(**_SMALL)
    tcfg = MGNConfig(**_SMALL)
    tree = jcfg.init(jax.random.PRNGKey(3))
    jb, tb, n = _graphs(align=False)
    ref = np.asarray(jcfg.apply(tree, jb))[:n]
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")
    np.testing.assert_allclose(tcfg.apply(params, tb).numpy()[:n], ref,
                               rtol=RTOL, atol=ATOL)
    bad = dataclasses.replace(tcfg, processor_size=2)
    with pytest.raises(ValueError, match="processor layers"):
        params_from_jax(jax.tree.map(np.asarray, tree), bad, device="cpu")


def test_aggregate_edges_rejects_unknown_mode():
    with pytest.raises(ValueError, match="Unsupported aggregation"):
        tops.aggregate_edges(torch.zeros(4, 2),
                             torch.zeros(4, dtype=torch.int32), 3,
                             aggregation="max")


def test_aligned_stream_on_card_refuses_unported_kernels():
    """On the cuda backend an aligned stream on the card must not fall back
    to the plain ops: K5 (aggregation) and K6 (receiver gather) are not
    ported yet. The plain ops serve CPU tensors and the torch backend."""
    from types import SimpleNamespace

    on_card = SimpleNamespace(is_cuda=True)
    with pytest.raises(NotImplementedError, match="K5"):
        tops.refuse_unported_kernel("aggregate_edges", "K5", on_card)
    with pytest.raises(NotImplementedError, match="K6"):
        tops.refuse_unported_kernel("gather_receivers", "K6", on_card)
    with tops.use_backend("torch"):
        tops.refuse_unported_kernel("aggregate_edges", "K5", on_card)
    tops.refuse_unported_kernel("aggregate_edges", "K5",
                                SimpleNamespace(is_cuda=False))
