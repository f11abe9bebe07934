"""Port parity for utils/: the JAX package's tests/test_utils.py cases
(graph statistics, the diagnostic plots, the memory stats) against its
functions on the same inputs, the port's trace and annotate, and the
reference checkpoint import: a state_dict in the reference framework's key
layout, written with torch.save from a JAX parameter tree, converted by
both packages."""

import os

import jax
import numpy as np
import pytest
import torch

from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from aero_gnn_tpu.models.mlpnet import MLPNetConfig as JaxMLPNetConfig
from aero_gnn_tpu.utils import diagnostics as JDG
from aero_gnn_tpu.utils import profiling as JPR
from aero_gnn_tpu.utils import torch_import as JTI
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.models.convert import params_to_jax
from aero_gnn_tpu_torch.models.mgn import MGNConfig
from aero_gnn_tpu_torch.models.mlpnet import MLPNetConfig
from aero_gnn_tpu_torch.utils import diagnostics as TDG
from aero_gnn_tpu_torch.utils import profiling as TPR
from aero_gnn_tpu_torch.utils import torch_import as TTI


def _ring(n=20):
    i = np.arange(n)
    return (np.concatenate([i, (i + 1) % n]),
            np.concatenate([(i + 1) % n, i]))


@pytest.mark.parametrize("n,num_nodes", [(20, 20), (30, None), (7, 12)])
def test_graph_statistics(n, num_nodes):
    s, r = _ring(n)
    got = TDG.graph_statistics(s, r, num_nodes)
    assert got == JDG.graph_statistics(s, r, num_nodes)
    if num_nodes == n:
        assert got["undirected"] is True and got["avg_degree"] == 2.0


def test_plot_graph_sparsity_writes_files(tmp_path):
    s, r = _ring(30)
    out = {}
    for tag, mod in (("port", TDG), ("jax", JDG)):
        base = str(tmp_path / tag / "graph")
        os.makedirs(os.path.dirname(base))
        mod.plot_graph_sparsity(s, r, 30, save_path=base)
        for suffix in ("_adjacency.png", "_degree_dist.png"):
            assert os.path.getsize(base + suffix) > 0
        out[tag] = open(base + "_statistics.txt").read()
    assert "num_nodes: 30" in out["port"]
    assert out["port"] == out["jax"]


def test_device_memory_stats_cpu_is_none():
    assert TPR.device_memory_stats("cpu") is None
    assert TPR.device_memory_stats(torch.device("cpu")) is None
    JPR.device_memory_stats()  # may be None on CPU: it must not raise


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with TPR.trace(str(logdir)):
        with TPR.annotate("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    text = (logdir / files[0]).read_text()
    assert "matmul" in text and "traceEvents" in text


def _mlp_sd(tree, prefix):
    sd = {}
    for i, lin in enumerate(tree["linears"]):
        sd[f"{prefix}layers.{i}.weight"] = np.asarray(lin["w"]).T
        sd[f"{prefix}layers.{i}.bias"] = np.asarray(lin["b"])
    if tree["ln"] is not None:
        sd[f"{prefix}layer_norm.weight"] = np.asarray(tree["ln"]["scale"])
        sd[f"{prefix}layer_norm.bias"] = np.asarray(tree["ln"]["bias"])
    return sd


def _layer(tree, i):
    return jax.tree.map(lambda a: np.asarray(a)[i], tree)


def _reference_sd(tree):
    """A JAX MGN / MLPNet tree in the reference framework's state_dict
    layout (torch tensors, weights [out, in]); EdgeBlockSum's stack as a
    Sequential with an activation between linears and the LayerNorm last."""
    if "encoder" in tree:
        sd = {**_mlp_sd(tree["encoder"], "mlp."),
              **_mlp_sd(tree["decoder"], "decoder.")}
        return {k: torch.from_numpy(np.array(v))
                for k, v in sd.items()}
    sd = {**_mlp_sd(tree["node_encoder"], "node_encoder."),
          **_mlp_sd(tree["edge_encoder"], "edge_encoder."),
          **_mlp_sd(tree["decoder"], "decoder.")}
    n_layers = np.asarray(tree["layers"]["node"]["linears"][0]["w"]).shape[0]
    for i in range(n_layers):
        lt = _layer(tree["layers"], i)
        p = f"layers.{i}."
        sd.update(_mlp_sd(lt["node"], p + "node_block.mlp."))
        edge = lt["edge"]
        if "w_e" not in edge:
            sd.update(_mlp_sd(edge, p + "edge_block.mlp."))
            continue
        for k, name in (("w_e", "edge_lin"), ("w_s", "src_lin"),
                        ("w_d", "dst_lin")):
            sd[p + f"edge_block.{name}"] = edge[k].T
        sd[p + "edge_block.bias"] = edge["b"]
        for j, lin in enumerate(edge["stack"]):
            sd[p + f"edge_block.mlp.{2 * j}.weight"] = lin["w"].T
            sd[p + f"edge_block.mlp.{2 * j}.bias"] = lin["b"]
        last = 2 * len(edge["stack"])
        sd[p + f"edge_block.mlp.{last}.weight"] = edge["ln"]["scale"]
        sd[p + f"edge_block.mlp.{last}.bias"] = edge["ln"]["bias"]
    return {k: torch.from_numpy(np.array(v))
            for k, v in sd.items()}


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


_MGN = dict(input_node_dim=6, input_edge_dim=3, output_node_dim=4,
            processor_size=2, hidden_dim_processor=32,
            hidden_dim_node_encoder=32, hidden_dim_edge_encoder=32,
            hidden_dim_decoder=32, num_hidden_layers_node_processor=2,
            num_hidden_layers_edge_processor=2,
            num_hidden_layers_node_encoder=2,
            num_hidden_layers_edge_encoder=2, num_hidden_layers_decoder=2,
            aggregation="add")


@pytest.mark.parametrize("concat_trick", [False, True])
def test_import_reference_checkpoint_mgn(tmp_path, concat_trick):
    """The same .pt file converts to the same weights in both packages, and
    the port's model gives JAX's forward."""
    jcfg = JaxMGNConfig(**_MGN, do_concat_trick=concat_trick)
    tcfg = MGNConfig(**_MGN, do_concat_trick=concat_trick)
    path = str(tmp_path / "model_weights.pt")
    torch.save(_reference_sd(jcfg.init(jax.random.PRNGKey(3))), path)
    jtree = JTI.import_reference_checkpoint(path, "mgn")
    params = TTI.import_reference_checkpoint(path, "mgn", tcfg, device="cpu")
    got, want = _leaves(params_to_jax(params, tcfg)), _leaves(jtree)
    assert got.keys() == want.keys()
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)
    rng = np.random.default_rng(1)
    n = 40
    s = np.arange(n, dtype=np.int32)
    g = dict(senders=np.concatenate([s, (s + 1) % n]),
             receivers=np.concatenate([(s + 1) % n, s]),
             x=rng.standard_normal((n, 6)).astype(np.float32),
             edge_attr=rng.standard_normal((2 * n, 3)).astype(np.float32),
             pos=rng.standard_normal((n, 2)).astype(np.float32))
    ours = tcfg.apply(params, TP.build_graph_batch(**g, device="cpu"))
    ref = jcfg.apply(jtree, JP.build_graph_batch(**g))
    np.testing.assert_allclose(ours.detach().numpy()[:n],
                               np.asarray(ref)[:n], rtol=2e-4, atol=2e-5)


def test_import_reference_checkpoint_mlpnet(tmp_path):
    kw = dict(input_node_dim=6, output_node_dim=4, hidden_dim=16)
    jtree0 = JaxMLPNetConfig(**kw).init(jax.random.PRNGKey(4))
    path = str(tmp_path / "model_weights.pt")
    torch.save(_reference_sd(jtree0), path)
    tcfg = MLPNetConfig(**kw)
    params = TTI.import_reference_checkpoint(path, "mlpnet", tcfg,
                                             device="cpu")
    want = _leaves(JTI.import_reference_checkpoint(path, "mlpnet"))
    got = _leaves(params_to_jax(params, tcfg))
    assert got.keys() == want.keys()
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)
    with pytest.raises(ValueError, match="Unsupported model kind"):
        TTI.import_reference_checkpoint(path, "bsms", tcfg, device="cpu")
