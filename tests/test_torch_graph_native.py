"""The port's native host graph core (graph.native, built with g++ from
csrc/host/graphcore.cpp) against the numpy plain versions and the JAX
package's aero_gnn_tpu.graph.native, bit for bit, on random graphs with
and without edges, one node, sparse ids and a mesh; build_graph_batch's
batches equal with the graph core and with the numpy paths
(padded.sort_edges_by_receiver_ref, padded._align_edge_blocks_ref); keys
outside their bound refused; a build that fails raises."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from aero_gnn_tpu.graph import native as jnative
from aero_gnn_tpu_torch.data import dataset as D
from aero_gnn_tpu_torch.data.synthetic import make_random_mesh_sample
from aero_gnn_tpu_torch.graph import native, padded
from aero_gnn_tpu_torch.ops import _build

# name: (nodes, edges); the ids are drawn from [0, nodes)
GRAPHS = {"empty": (1, 0), "one_node": (1, 5), "random": (300, 2000),
          "sparse_ids": (5000, 120), "dense": (40, 3000)}
# (node_block, edge_tile) of the alignment: small ones, and the kernels'
ALIGN = [(4, 8), (16, 32), (padded.ALIGN_NODE_BLOCK, padded.ALIGN_EDGE_TILE)]


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's graph core, loaded (it builds native/ itself on
    first use; another test process may be building it at the same time,
    so a failed load is retried)."""
    for _ in range(100):
        if jnative.load() is not None:
            return jnative
        jnative._tried = False
        time.sleep(0.1)
    pytest.fail("the JAX package's graph core did not load")


def _edges(name, seed=0):
    n, e = GRAPHS[name]
    rng = np.random.default_rng(seed)
    return n, rng.integers(0, n, e), rng.integers(0, n, e)


def align_blocks_plain(receivers, num_nodes_pad, node_block, edge_tile):
    """numpy: each block's run of the sorted stream, padded with -1 to
    whole tiles (at least one)."""
    block = receivers // node_block
    rows, tile_block, tile_first = [], [], []
    for b in range(num_nodes_pad // node_block):
        lo, hi = np.searchsorted(block, [b, b + 1])
        tiles = max(1, -(-(hi - lo) // edge_tile))
        rows += list(range(lo, hi)) + [-1] * (tiles * edge_tile - (hi - lo))
        tile_block += [b] * tiles
        tile_first += [1] + [0] * (tiles - 1)
    return tuple(np.asarray(a, np.int32)
                 for a in (rows, tile_block, tile_first))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_sort_edges_by_receiver(jax_native, name):
    n, s, r = _edges(name)
    got = native.sort_edges_by_receiver(s, r, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.lexsort((s, r)))
    np.testing.assert_array_equal(
        got, jax_native.sort_edges_by_receiver(s, r, n))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_argsort_i32(jax_native, name):
    n, s, _ = _edges(name, seed=1)
    got = native.argsort_i32(s, n)
    np.testing.assert_array_equal(got, np.argsort(s, kind="stable"))
    np.testing.assert_array_equal(got, jax_native.argsort_i32(s, n))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_csr_offsets(jax_native, name):
    n, s, _ = _edges(name, seed=2)
    ids = np.sort(s)
    got = native.csr_offsets(ids, n)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got,
                                  np.searchsorted(ids, np.arange(n + 1)))
    np.testing.assert_array_equal(got, jax_native.csr_offsets(ids, n))


@pytest.mark.parametrize("nb,et", ALIGN)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_align_blocks(jax_native, name, nb, et):
    n, _, r = _edges(name, seed=3)
    r = np.sort(r)
    n_pad = padded._round_up(n + 1, nb)
    got = native.align_blocks(r, n_pad, nb, et)
    for a, b in zip(got, align_blocks_plain(r, n_pad, nb, et)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, jax_native.align_blocks(r, n_pad, nb, et)):
        np.testing.assert_array_equal(a, b)


def _graph(name):
    if name == "mesh":
        s = make_random_mesh_sample(n_nodes=3000, seed=5)
        D.compute_features([s], ["mach", "alpha"])
        return dict(senders=s.senders, receivers=s.receivers, x=s.x,
                    edge_attr=s.edge_attr, pos=s.pos, y=s.y)
    n, s, r = _edges(name, seed=4)
    rng = np.random.default_rng(5)
    return dict(senders=s, receivers=r,
                x=rng.standard_normal((n, 4)).astype(np.float32),
                edge_attr=rng.standard_normal((len(s), 3)).astype(np.float32),
                pos=rng.standard_normal((n, 2)).astype(np.float32))


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("name", list(GRAPHS) + ["mesh"])
def test_build_graph_batch_equal_to_numpy_path(monkeypatch, name, align):
    g = _graph(name)
    got, got_map = padded.build_graph_batch(
        **g, align_edges=align, return_align_map=True, device="cpu")
    monkeypatch.setattr(padded, "sort_edges_by_receiver",
                        padded.sort_edges_by_receiver_ref)
    monkeypatch.setattr(padded, "_align_edge_blocks",
                        padded._align_edge_blocks_ref)
    ref, ref_map = padded.build_graph_batch(
        **g, align_edges=align, return_align_map=True, device="cpu")
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    if align:
        np.testing.assert_array_equal(got_map, ref_map)


def test_keys_outside_their_bound_are_refused():
    s = np.array([0, 3, 1])
    with pytest.raises(ValueError):
        native.sort_edges_by_receiver(s, np.array([0, 1, 4]), 4)
    with pytest.raises(ValueError):
        native.sort_edges_by_receiver(np.array([0, -1, 1]), s, 4)
    with pytest.raises(ValueError):
        native.argsort_i32(s, 3)
    with pytest.raises(ValueError):
        native.align_blocks(np.sort(s), 8, 4, 0)


def test_failed_build_raises(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SRC", src)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"):
        _build.host_library("broken")
