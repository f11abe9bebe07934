"""Port parity for grouped and host-offloaded remat: the JAX package's remat
cases (tests/test_models.py::TestRematVariants: a 6-layer, width-16 concat
trick MGN on a 100-node ring) against jax.grad of the JAX package under the
same knobs, the port's own no-remat gradients bit for bit, the two
refusals, encoder dropout under grouped remat, and how many times each
scheme runs a layer's forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from aero_gnn_tpu_torch.models.mgn import MGNConfig
from aero_gnn_tpu_torch.ops import hopper_fused as HF
from aero_gnn_tpu_torch.ops import hopper_node as HN

_SMALL = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
              processor_size=6, hidden_dim_processor=16,
              hidden_dim_node_encoder=16, hidden_dim_edge_encoder=16,
              hidden_dim_decoder=16, do_concat_trick=True, aggregation="add")

# tests/test_models.py::TestRematVariants::test_grads_match_no_remat's cases
_CASES = [
    dict(remat=True, remat_policy="save_fused"),
    dict(remat=True, remat_policy="full"),
    dict(remat=True, remat_group=3),
    dict(remat=True, remat_group=2, unroll=True),
    dict(remat=True, remat_group=3, remat_offload=True),
    dict(remat=True, remat_group=3, remat_group_policy="save_fused"),
    dict(remat=True, remat_group=3, remat_group_policy="save_fused:1"),
    dict(remat=False, unroll=True),
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    worker processes at once, and torch's default pool in each (one thread
    a core) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(align):
    rng = np.random.default_rng(0)
    n = 100
    s = np.arange(n, dtype=np.int32)
    r = (s + 1) % n
    g = dict(senders=np.concatenate([s, r]), receivers=np.concatenate([r, s]),
             x=rng.standard_normal((n, 6)).astype(np.float32),
             edge_attr=rng.standard_normal((2 * n, 3)).astype(np.float32),
             pos=rng.standard_normal((n, 2)).astype(np.float32),
             y=rng.standard_normal((n, 4)).astype(np.float32))
    return (JP.build_graph_batch(**g, align_edges=align),
            TP.build_graph_batch(**g, align_edges=align, device="cpu"))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_grads(jb, tree, **kw):
    cfg = JaxMGNConfig(**_SMALL, **kw)

    def loss_fn(p):
        pred = cfg.apply(p, jb)
        m = jb.node_mask[:, None]
        return jnp.sum(jnp.square(pred - jb.y) * m) / jnp.sum(m)

    with jops.use_backend("xla"):
        return _leaves(jax.grad(loss_fn)(tree))


def _port_loss(cfg, params, tb, generator=None):
    pred = cfg.apply(params, tb, generator=generator)
    m = tb.node_mask[:, None]
    return torch.sum(torch.square(pred - tb.y) * m) / torch.sum(m)


def _port_grads(tb, tree, backend, **kw):
    cfg = MGNConfig(**_SMALL, **kw)
    params = params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                             device="cpu")
    with tops.use_backend(backend):
        _port_loss(cfg, params, tb).backward()
    return _leaves(params_to_jax(params, cfg, grads=True))


@pytest.fixture(scope="module")
def ring():
    jb, tb = _ring(align=True)
    tree = JaxMGNConfig(**_SMALL).init(jax.random.PRNGKey(0))
    return jb, tb, tree


@pytest.mark.parametrize("kw", _CASES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_grads_match_no_remat(ring, kw):
    """Port backend "cuda": the fused path (K1-K5's plain versions on CPU
    tensors, where "save_fused" checkpoints nothing); "torch": the unfused
    composition, where every policy checkpoints each layer. JAX runs its
    XLA backend (an interpret-mode pallas_call cannot sit under
    jax.checkpoint)."""
    jb, tb, tree = ring
    jgrads = _jax_grads(jb, tree, **kw)
    for backend in ("cuda", "torch"):
        base = _port_grads(tb, tree, backend, remat=False)
        got = _port_grads(tb, tree, backend, **kw)
        assert got.keys() == jgrads.keys() == base.keys()
        for name, g in jgrads.items():
            np.testing.assert_array_equal(got[name], base[name],
                                          err_msg=f"{backend} {name}")
            np.testing.assert_allclose(
                got[name], g, rtol=1e-3,
                atol=1e-5 * np.abs(g).max(initial=1e-30),
                err_msg=f"{backend} {name}")


def test_remat_group_must_divide_layers(ring):
    _, tb, tree = ring
    with pytest.raises(ValueError, match="remat_group"):
        _port_grads(tb, tree, "cuda", remat=True, remat_group=4)


def test_remat_offload_requires_grouping(ring):
    _, tb, tree = ring
    with pytest.raises(ValueError, match="remat_offload"):
        _port_grads(tb, tree, "cuda", remat=True, remat_offload=True)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_encoder_dropout_replays_under_grouped_remat(ring, backend):
    """Grouped remat checkpoints the encoders, whose dropout draws from an
    explicit generator: the recompute must draw the forward's masks again
    (the same gradients as without remat, from the same seed) and leave the
    generator where the forward left it."""
    _, tb, _ = ring
    out = []
    for kw in (dict(remat=False), dict(remat=True, remat_group=3),
               dict(remat=True, remat_group=3, remat_offload=True)):
        cfg = MGNConfig(**_SMALL, dropout=0.3, **kw)
        params = cfg.init(5, device="cpu")
        gen = torch.Generator().manual_seed(11)
        with tops.use_backend(backend):
            _port_loss(cfg, params, tb, generator=gen).backward()
        out.append(({n: p.grad for n, p in params.named_parameters()},
                    gen.get_state()))
    for grads, state in out[1:]:
        assert torch.equal(state, out[0][1])
        for n, g in out[0][0].items():
            assert torch.equal(grads[n], g), n


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("kw,forwards", [
    (dict(remat=False), 6),
    (dict(remat=True, remat_policy="save_fused"), 6),
    # a per-layer checkpoint replays its layer once
    (dict(remat=True, remat_policy="full"), 12),
    # a save_fused group replays its 3 layers; a full group replays its
    # first 2 (the replay stops at the last layer's inner checkpoint,
    # whose saved inputs are the last tensors the group saved), then each
    # inner checkpoint its layer
    (dict(remat=True, remat_group=3, remat_group_policy="save_fused"), 12),
    (dict(remat=True, remat_group=3, remat_group_policy="save_fused:1"), 14),
    (dict(remat=True, remat_group=3), 16),
    (dict(remat=True, remat_group=3, remat_offload=True), 16),
    # the offload runs "save_fused:N" as full, as JAX's offload branch does
    (dict(remat=True, remat_group=3, remat_offload=True,
          remat_group_policy="save_fused:1"), 16),
    (dict(remat=True, remat_group=3, remat_offload=True,
          remat_group_policy="save_fused"), 12),
])
def test_layer_forwards_per_step(ring, monkeypatch, kw, forwards):
    """The fused edge and node layers' forwards in one training step on the
    fused path, counted through their plain versions: the launches of K1
    and K3 a step on the card under the same knobs."""
    _, tb, _ = ring
    edge = _count_calls(monkeypatch, HF, "fused_edge_layer_ref")
    node = _count_calls(monkeypatch, HN, "fused_node_layer_ref")
    cfg = MGNConfig(**_SMALL, **kw)
    params = cfg.init(0, device="cpu")
    with tops.use_backend("cuda"):
        _port_loss(cfg, params, tb).backward()
    assert (len(edge), len(node)) == (forwards, forwards)
    with torch.no_grad(), tops.use_backend("cuda"):
        cfg.apply(params, tb)
    assert (len(edge), len(node)) == (forwards + 6, forwards + 6)
