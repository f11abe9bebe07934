"""Port parity for the registry's model zoo: each kind built by both
registries from the same model dict at a small size (h = 32, 3 layers, 2
hidden layers per MLP) with JAX-initialised weights carried over by
params_from_jax, its forward against the JAX package's on the xla backend
and on the pallas backend in interpret mode, through a two-mesh Loader
batch (500 real nodes, a pad graph and the pad-sink tail); the registry's
names and errors; dropout."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aero_gnn_tpu import ops as jops
from aero_gnn_tpu.data import batching as JB
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.models import registry as JR
from aero_gnn_tpu_torch import ops as tops
from aero_gnn_tpu_torch.data import batching as TB
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data import synthetic as TS
from aero_gnn_tpu_torch.models import registry as TR
from aero_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from aero_gnn_tpu_torch.ops import hopper_gather as HG
from aero_gnn_tpu_torch.ops import hopper_segment as HS

RTOL, ATOL = 2e-4, 2e-5  # fp32 CPU bar (tests/test_torch_mgn.py)
H = 32
DIMS = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4)
_MGN = dict(hidden_dim=H, processor_size=3, num_hidden_layers_decoder=2,
            num_hidden_layers_node_encoder=2,
            num_hidden_layers_edge_encoder=2,
            num_hidden_layers_node_processor=2,
            num_hidden_layers_edge_processor=2)
_POOL = dict(name="poolMGN", **_MGN, global_dim=H,
             num_hidden_layers_global_encoder=2)
MODELS = {
    "mgn": dict(name="meshgraphnet", **_MGN, do_concat_trick=False),
    "fouriermgn": dict(name="fouriermgn", **_MGN),
    "poolmgn_mean": dict(_POOL, global_pool_method="mean"),
    "poolmgn_max": dict(_POOL, global_pool_method="max"),
    "poolmgn_add": dict(_POOL, global_pool_method="add"),
    "mgn_v2": dict(name="trial1", hidden_dim=H, num_message_passing_layers=3,
                   number_of_encoding_layers=2, number_of_decoding_layers=2),
    "mlpnet": dict(name="mlpnet", hidden_dim=H, num_hidden_layers_encoder=2,
                   num_hidden_layers_decoder=2),
}


def loader_batches():
    """One aligned Loader batch of two 250-node meshes from each package
    (bit-equal, tests/test_torch_training.py) and the real node count."""
    jsam = [JS.make_random_mesh_sample(n_nodes=250, avg_degree=6, seed=s)
            for s in (2, 3)]
    tsam = [TS.make_random_mesh_sample(n_nodes=250, avg_degree=6, seed=s)
            for s in (2, 3)]
    JD.compute_features(jsam, ["mach", "alpha"])
    TD.compute_features(tsam, ["mach", "alpha"])
    jb = next(iter(JB.Loader(jsam, 2, align_edges=True)))[0]
    tb = next(iter(TB.Loader(tsam, 2, align_edges=True, device="cpu")))[0]
    return jb, tb, 500


def build_pair(mc):
    """(JAX config, JAX tree, port config, port params) from one dict."""
    jcfg = JR.build_model(mc, DIMS)
    tree = jcfg.init(jax.random.PRNGKey(7))
    tcfg = TR.build_model(mc, DIMS)
    params = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                             device="cpu")
    return jcfg, tree, tcfg, params


@pytest.mark.parametrize("jax_backend,port_backend", [("xla", "torch"),
                                                      ("pallas", "cuda")])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_zoo_forward_matches_jax(kind, jax_backend, port_backend):
    """port_backend "cuda": the unfused layer's K6 and K5 (plain versions on
    CPU tensors, the pad sink declared); "torch": the plain composition."""
    jb, tb, n = loader_batches()
    jcfg, tree, tcfg, params = build_pair(MODELS[kind])
    with jops.use_backend(jax_backend), pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jcfg.apply(tree, jb))[:n]
    with tops.use_backend(port_backend):
        out = tcfg.apply(params, tb).detach().numpy()[:n]
    assert out.shape == ref.shape == (n, 4) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_zoo_trees_round_trip():
    """params_to_jax inverts params_from_jax for every kind: the JAX tree's
    structure and leaves come back."""
    for kind, mc in MODELS.items():
        _, tree, tcfg, params = build_pair(mc)
        back = params_to_jax(params, tcfg)
        ref = jax.tree.map(np.asarray, tree)
        assert jax.tree.structure(back) == jax.tree.structure(ref), kind
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b, err_msg=kind)


def test_registry_names_match_jax():
    names = ["MLP", "mlpnet", "MeshGraphNet", "mgn", "bsms_mgn", "BSMS",
             "bsms-mgn", "poolMGN", "fourierMGN", "fourier_mgn", "trial1",
             "mgn_v2", "MeshGraphNet_v2"]
    assert [TR.canonical_name(n) for n in names] == \
        [JR.canonical_name(n) for n in names]
    assert TR.NEEDS_HIERARCHY == JR.NEEDS_HIERARCHY
    for bad in ("gcn", "mgn2", ""):
        with pytest.raises(ValueError, match="Unknown model type"):
            TR.canonical_name(bad)
        with pytest.raises(ValueError, match="Unknown model type"):
            TR.build_model({"name": bad}, DIMS)


@pytest.mark.parametrize("mc", [
    {"name": "fouriermgn"}, {"name": "poolMGN", "remat": False},
    {"name": "bsms", "num_scales": 2, "transfer": "weighted"},
    {"name": "trial1", "dropout": 0.2}, {"name": "mlp", "activation": "gelu"},
    {"name": "meshgraphnet", "do_concat_trick": True,
     "compute_dtype": "bfloat16"}], ids=lambda mc: mc["name"])
def test_registry_configs_match_jax(mc):
    """Every field of the port's config equals the JAX config's (the JAX
    package's MGNConfig has fields the port keeps too)."""
    jcfg, tcfg = JR.build_model(mc, DIMS), TR.build_model(mc, DIMS)
    assert type(jcfg).__name__ == type(tcfg).__name__
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_pool_max_keeps_finfo_min_and_empty_zero():
    """segment_max: a segment of masked rows only gives finfo.min, an empty
    segment 0, as the JAX package's; graph_pool rejects other methods."""
    from aero_gnn_tpu.ops import scatter as JSc

    rng = np.random.default_rng(0)
    data = rng.standard_normal((6, 3)).astype(np.float32)
    ids = np.array([0, 0, 1, 1, 3, 3], np.int32)
    mask = np.array([1, 0, 0, 0, 1, 1], np.float32)
    ref = np.asarray(JSc.segment_max(data, ids, 4, mask=mask))
    got = tops.segment_max(torch.from_numpy(data), torch.from_numpy(ids), 4,
                           mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[1] == np.finfo(np.float32).min).all() and (got[2] == 0).all()
    with pytest.raises(ValueError, match="pooling method"):
        tops.graph_pool(torch.from_numpy(data), torch.from_numpy(ids), 4,
                        method="median")


@pytest.mark.parametrize("kind", ["poolmgn_mean", "mgn_v2", "mlpnet"])
def test_dropout_zero_is_identity_and_a_seed_repeats(kind):
    _, tb, _ = loader_batches()
    mc = dict(MODELS[kind], dropout=0.1)
    cfg = TR.build_model(mc, DIMS)
    params = cfg.init(0, device="cpu")
    no_drop = TR.build_model(dict(mc, dropout=0.0), DIMS)
    with torch.no_grad():
        plain = cfg.apply(params, tb)
        runs = [cfg.apply(params, tb,
                          generator=torch.Generator().manual_seed(5))
                for _ in range(2)]
        zero = no_drop.apply(params, tb,
                             generator=torch.Generator().manual_seed(5))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], plain)
    assert torch.equal(zero, plain)


def test_fp32_only_models_ignore_compute_dtype():
    """poolMGN (like MGNv2 and MLPNet, which have no compute dtype) computes
    in float32 whatever compute_dtype says, as the JAX package's: fp32
    parameters, the bf16 config's output equal to the fp32 config's."""
    _, tb, _ = loader_batches()
    mc = MODELS["poolmgn_mean"]
    f32 = TR.build_model(mc, DIMS)
    b16 = TR.build_model(dict(mc, compute_dtype="bfloat16"), DIMS)
    params = f32.init(0, device="cpu")
    for cfg in (f32, b16, TR.build_model(MODELS["mgn_v2"], DIMS),
                TR.build_model(MODELS["mlpnet"], DIMS)):
        assert cfg.params_dtype == torch.float32
    with torch.no_grad():
        assert torch.equal(b16.apply(params, tb), f32.apply(params, tb))
        half = params.to(torch.bfloat16)
        out = b16.apply(half, tb)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_unfused_model_routes_through_k6_and_k5(monkeypatch):
    """The registry's FourierMGN on an aligned graph on the cuda backend
    calls the K6 wrapper once per layer and the K5 wrapper once per layer
    forward (the aggregation, the sink declared); a step adds K6's backward
    and the sender backward on K5. The torch backend calls neither."""
    _, tb, _ = loader_batches()
    mc = dict(MODELS["fouriermgn"], remat=False)
    cfg = TR.build_model(mc, DIMS)
    params = cfg.init(0, device="cpu")
    calls = {"k6": 0, "k5": []}
    k6, k5 = HG.gather_rows, HS.segment_sum

    def count_k6(*a, **k):
        calls["k6"] += 1
        return k6(*a, **k)

    def count_k5(*a, **k):
        calls["k5"].append(k.get("pad_sink", False))
        return k5(*a, **k)

    monkeypatch.setattr(HG, "gather_rows", count_k6)
    monkeypatch.setattr(HS, "segment_sum", count_k5)
    out = cfg.apply(params, tb)
    assert calls["k6"] == 3 and calls["k5"] == [True] * 3
    out.sum().backward()
    assert calls["k6"] == 3 and calls["k5"] == [True] * 9
    calls["k6"], calls["k5"] = 0, []
    with tops.use_backend("torch"):
        cfg.apply(params, tb).sum().backward()
    assert calls["k6"] == 0 and calls["k5"] == []
