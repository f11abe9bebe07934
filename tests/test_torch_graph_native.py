"""The port's native host graph core (graph.native, built with g++ from
csrc/host/graphcore.cpp) against the numpy plain versions and the JAX
package's aero_gnn_tpu.graph.native, bit for bit, on random graphs with
and without edges, one node, sparse ids and a mesh; build_graph_batch's
batches equal with the graph core and with the numpy paths
(padded.sort_edges_by_receiver_ref, padded._align_edge_blocks_ref); the
greedy block balance slot for slot against hierarchy's plain version and
the JAX package's; keys and sizes outside their bound refused; a build
that fails raises."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from aero_gnn_tpu.graph import hierarchy as jhierarchy
from aero_gnn_tpu.graph import native as jnative
from aero_gnn_tpu_torch.data import dataset as D
from aero_gnn_tpu_torch.data.synthetic import make_random_mesh_sample
from aero_gnn_tpu_torch.graph import hierarchy, native, padded
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


def _balance_case(name):
    """(weights, n_blocks, nb, reserve_last) of a balance case."""
    rng = np.random.default_rng(7)
    if name == "random_degrees":
        return rng.integers(1, 40, 900).astype(np.float64), 16, 64, True
    if name == "all_equal":  # every pick a tie of load and of weight
        return np.full(500, 6.0), 9, 64, True
    if name == "one_block":
        return rng.integers(0, 12, 200).astype(np.float64), 1, 256, True
    if name == "nb1_reserve_last":  # the last block has no room at all
        return rng.integers(0, 5, 11).astype(np.float64), 12, 1, True
    if name == "exactly_full":
        return rng.integers(0, 9, 8 * 32).astype(np.float64), 8, 32, False
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random_degrees", "all_equal", "one_block",
                                  "nb1_reserve_last", "exactly_full"])
def test_balance_slots(name):
    w, n_blocks, nb, reserve = _balance_case(name)
    got = native.balance_slots(w, n_blocks, nb, reserve)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, hierarchy._balance_block_slots_ref(w, n_blocks, nb, reserve))
    np.testing.assert_array_equal(
        got, jhierarchy._balance_block_slots(w, n_blocks, nb, reserve))
    assert len(np.unique(got)) == len(w)
    assert got.min(initial=0) >= 0
    assert got.max(initial=0) < n_blocks * nb - int(reserve)


def test_balance_slots_over_capacity_raises():
    with pytest.raises(ValueError, match="exceed capacity"):
        native.balance_slots(np.ones(8), 2, 4, True)
    with pytest.raises(ValueError, match="exceed capacity"):
        hierarchy._balance_block_slots_ref(np.ones(8), 2, 4, True)
    assert len(native.balance_slots(np.ones(8), 2, 4, False)) == 8


def test_balance_slots_sizes_outside_their_bound_are_refused():
    w = np.ones(3)
    for n_blocks, nb in [(-1, 4), (2, -4), (0, 4), (2, 0),
                         (2 ** 31, 1), (2 ** 16, 2 ** 16)]:
        with pytest.raises(ValueError):
            native.balance_slots(w, n_blocks, nb)
    for bad in (np.array([1.0, np.nan, 2.0]), np.array([np.inf]),
                np.ones((2, 2))):
        with pytest.raises(ValueError):
            native.balance_slots(bad, 4, 4)


def test_failed_build_raises(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SRC", src)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"):
        _build.host_library("broken")
