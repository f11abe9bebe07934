"""Port parity: the port's graph builder, synthetic mesh and features give
arrays identical to the JAX package's."""

import numpy as np
import pytest

from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.graph import native
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu.ops.pallas_segment import derive_tiles as jax_derive_tiles
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data import synthetic as TS
from aero_gnn_tpu_torch.graph import padded as TP

FIELDS = ("senders", "receivers", "edge_mask", "node_mask", "x", "edge_attr")


def _aligned_graph_mesh():
    """The mesh of tests/test_pallas.py's aligned_graph fixture."""
    rng = np.random.default_rng(3)
    n, e = 300, 1500
    return dict(senders=rng.integers(0, n, e), receivers=rng.integers(0, n, e),
                x=rng.standard_normal((n, 4)).astype(np.float32),
                edge_attr=rng.standard_normal((e, 8)).astype(np.float32),
                pos=rng.standard_normal((n, 2)).astype(np.float32))


def _random_mesh():
    s = JS.make_random_mesh_sample(n_nodes=700, avg_degree=6, seed=4)
    JD.compute_features([s], ["mach", "alpha"])
    return dict(senders=s.senders, receivers=s.receivers, x=s.x,
                edge_attr=s.edge_attr, pos=s.pos, y=s.y)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("mesh", ["aligned_graph", "random_mesh"])
def test_build_graph_batch_matches_jax(mesh, align, use_native, monkeypatch):
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    g = _aligned_graph_mesh() if mesh == "aligned_graph" else _random_mesh()
    jb = JP.build_graph_batch(**g, align_edges=align)
    tb = TP.build_graph_batch(**g, align_edges=align, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tb.edges_aligned == jb.edges_aligned == align
    assert (tb.n_node, tb.n_edge) == (int(jb.n_node), int(jb.n_edge))
    if align:
        for name in ("tile_block", "tile_first"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=name)
        tile_block, tile_first = TP.derive_tiles(tb.receivers)
        np.testing.assert_array_equal(tile_block.numpy(),
                                      tb.tile_block.numpy())
        np.testing.assert_array_equal(tile_first.numpy(),
                                      tb.tile_first.numpy())
        jtb, jtf = jax_derive_tiles(jb.receivers)
        np.testing.assert_array_equal(tile_block.numpy(), np.asarray(jtb))
        np.testing.assert_array_equal(tile_first.numpy(), np.asarray(jtf))


def test_synthetic_mesh_and_features_identical():
    js = JS.make_random_mesh_sample(n_nodes=900, avg_degree=6, seed=7)
    ts = TS.make_random_mesh_sample(n_nodes=900, avg_degree=6, seed=7)
    JD.compute_features([js], ["mach", "alpha"])
    TD.compute_features([ts], ["mach", "alpha"])
    for name in ("pos", "normals", "senders", "receivers", "y", "x",
                 "edge_attr"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=name)
    assert ts.meta == js.meta


def test_bucket_size_and_pad_errors():
    for n in (0, 1, 127, 128, 1000, 65537):
        assert TP.bucket_size(n) == JP.bucket_size(n)
        assert TP.bucket_size(n, multiple=256) == JP.bucket_size(n, 256)
    g = _aligned_graph_mesh()
    with pytest.raises(ValueError, match="must exceed"):
        TP.build_graph_batch(**g, num_nodes_pad=300, device="cpu")
    with pytest.raises(ValueError, match="multiple of 256"):
        TP.build_graph_batch(**g, num_nodes_pad=384, align_edges=True,
                             device="cpu")
