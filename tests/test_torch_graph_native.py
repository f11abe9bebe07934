"""The port's native host graph core (graph.native, built with g++ from
csrc/host/graphcore.cpp) against the numpy plain versions and the JAX
package's aero_gnn_tpu.graph.native, bit for bit, on random graphs with
and without edges, one node, sparse ids and a mesh; build_graph_batch's
batches, field by field with the align map, equal with the graph core's
one-pass layout and with the numpy composition (padded._edge_layout_ref,
padded.chunk_plan_ref), also for batches of uneven graphs, an unsorted
node_graph and a stream with no masked row; the aligned layout against
its plain version at the BSMS coarse levels' sizes; the greedy
block balance slot for slot against hierarchy's plain version and the JAX
package's; keys and sizes outside their bound refused; a build that fails
raises; the reused host buffers never handed out while a batch holds
them, and grown to the largest batch."""

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


def _mesh_graph(n_nodes, seed):
    s = make_random_mesh_sample(n_nodes=n_nodes, seed=seed)
    D.compute_features([s], ["mach", "alpha"])
    return dict(senders=s.senders, receivers=s.receivers, x=s.x,
                edge_attr=s.edge_attr, pos=s.pos, y=s.y)


def _batch(name, align):
    """(function, keywords) of one build: build_graph_batch on a GRAPHS
    case or the mesh, or one of the cases below."""
    rng = np.random.default_rng(6)
    if name == "three_uneven":  # through batch_graphs
        graphs = [_mesh_graph(300, 1), _mesh_graph(90, 2),
                  _mesh_graph(500, 3)]
        e = sum(len(g["senders"]) for g in graphs)
        return padded.batch_graphs, dict(graphs=graphs, num_nodes_pad=1024,
                                         num_edges_pad=padded._round_up(
                                             e + 4 * 1024, 1024))
    if name == "unsorted_node_graph":
        kw = _graph("random")
        kw.update(node_graph=rng.integers(0, 3, len(kw["x"])),
                  num_graphs_pad=4)
        return padded.build_graph_batch, kw
    if name == "no_masked_row":  # two node blocks of exactly one tile each
        n, tile = 400, padded.ALIGN_EDGE_TILE
        r = np.r_[rng.integers(0, 256, tile), rng.integers(256, n, tile)]
        return padded.build_graph_batch, dict(
            senders=rng.integers(0, n, 2 * tile), receivers=r,
            x=rng.standard_normal((n, 4)).astype(np.float32),
            edge_attr=rng.standard_normal((2 * tile, 3)).astype(np.float32),
            pos=rng.standard_normal((n, 2)).astype(np.float32),
            num_nodes_pad=512, num_edges_pad=2 * tile if align else None)
    if name == "float64":  # features and masks of 8 bytes
        return padded.build_graph_batch, dict(_graph("random"),
                                              dtype=np.float64)
    if name == "no_edges":
        n = 300
        return padded.build_graph_batch, dict(
            senders=np.zeros(0, np.int64), receivers=np.zeros(0, np.int64),
            x=rng.standard_normal((n, 4)).astype(np.float32),
            edge_attr=np.zeros((0, 3), np.float32),
            pos=rng.standard_normal((n, 2)).astype(np.float32))
    return padded.build_graph_batch, _graph(name)


BATCHES = list(GRAPHS) + ["mesh", "three_uneven", "unsorted_node_graph",
                          "no_masked_row", "no_edges", "float64"]


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("name", BATCHES)
def test_build_graph_batch_equal_to_numpy_path(monkeypatch, name, align):
    build, kw = _batch(name, align)
    got, got_map = build(**kw, align_edges=align, return_align_map=True,
                         device="cpu")
    monkeypatch.setattr(padded, "_edge_layout", padded._edge_layout_ref)
    monkeypatch.setattr(padded, "chunk_plan", padded.chunk_plan_ref)
    ref, ref_map = build(**kw, align_edges=align, return_align_map=True,
                         device="cpu")
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    if align:
        assert got_map.dtype == ref_map.dtype == np.int64
        np.testing.assert_array_equal(got_map, ref_map)
        assert got.senders_aligned == (name != "no_masked_row")
    else:
        assert got_map is None and not got.senders_aligned


# (num_nodes_pad, rows, real rows) of the benchmark BSMS mesh's two coarse
# levels at 65,536 nodes, and a stream whose every block is whole tiles
SENDER_STREAMS = {"coarse_1": (39168, 157696, 131849),
                  "coarse_2": (17664, 71680, 67470),
                  "no_masked_row": (17664, 71680, 71680)}


@pytest.mark.parametrize("name", list(SENDER_STREAMS))
def test_align_sender_stream_equal_to_plain(name):
    """A BSMS coarse level's layout (hierarchy.align_host): the aligned
    one-pass native.edge_layout, its sender stream included, equal to
    padded._edge_layout_ref on a stream whose node blocks are filled evenly
    (as the block balance fills them), without edge features."""
    n_pad, rows, real = SENDER_STREAMS[name]
    nb, et = padded.ALIGN_NODE_BLOCK, padded.ALIGN_EDGE_TILE
    rng = np.random.default_rng(8)
    per_block = np.full(n_pad // nb, real // (n_pad // nb))
    per_block[:real % len(per_block)] += 1
    if name == "no_masked_row":  # one tile a block, two in the first
        per_block[:] = et
        per_block[0] += real - per_block.sum()
    blocks = np.repeat(np.arange(len(per_block)), per_block)
    r = blocks * nb + rng.integers(0, nb, real)
    r = np.minimum(r, n_pad - 2).astype(np.int32)  # the sink holds no edge
    s = rng.integers(0, n_pad - 1, real).astype(np.int32)
    order = rng.permutation(real)
    s, r = s[order], r[order]
    ea = np.zeros((real, 0), np.float32)
    got = native.edge_layout(s, r, ea, n_pad, rows, nb, et, align_map=True)
    ref = padded._edge_layout_ref(s, r, ea, n_pad, rows, True, True)
    assert got.keys() == ref.keys()
    assert got["senders_aligned"] == ref["senders_aligned"] == (real < rows)
    for k, b in ref.items():
        if isinstance(b, np.ndarray):
            assert got[k].dtype == b.dtype, k
            np.testing.assert_array_equal(got[k], b, err_msg=k)


@pytest.mark.parametrize("case", ["runs", "one_id", "empty_ids", "tail",
                                  "no_rows"])
def test_chunk_plan_equal_to_plain(case):
    rng = np.random.default_rng(9)
    ids = {"runs": rng.integers(0, 40, 3000),
           "one_id": np.zeros(5000, np.int64),
           "empty_ids": rng.choice([1, 4, 9], 700),
           "tail": np.r_[np.repeat(np.arange(300), 3), np.full(2000, 300)],
           "no_rows": np.zeros(0, np.int64)}[case]
    n_seg = int(ids.max(initial=0)) + 3
    for a, b in zip(padded.chunk_plan(ids, n_seg),
                    padded.chunk_plan_ref(ids, n_seg)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_reused_buffers_are_not_handed_out_while_held():
    """A batch left on the CPU keeps its host arrays; the next batch's build
    must not write into them, and once dropped they are used again."""
    g1, g2 = _graph("random"), _graph("dense")
    kw = dict(num_nodes_pad=512, num_edges_pad=4096, align_edges=True,
              device="cpu")
    first = padded.build_graph_batch(**g1, **kw)
    kept = {f.name: getattr(first, f.name).clone()
            for f in dataclasses.fields(first)
            if isinstance(getattr(first, f.name), torch.Tensor)}
    second = padded.build_graph_batch(**g2, **kw)
    for name, want in kept.items():
        assert torch.equal(getattr(first, name), want), name
    assert not torch.equal(first.senders, second.senders)
    ptr = first.senders.data_ptr()
    del first
    third = padded.build_graph_batch(**g2, **kw)
    assert third.senders.data_ptr() == ptr
    assert torch.equal(third.senders, second.senders)


def test_host_buffers_grow_and_serve_smaller_batches():
    """A role's buffer serves any batch up to the largest seen (meshes of
    other sizes do not reallocate it), grows past it, and is never handed
    out while an array of it is held."""
    pool = padded._HostBuffers()
    a = pool.empty("ids", 1000, np.int32)
    ptr = a.ctypes.data
    del a
    b = pool.empty("ids", (10, 30), np.float32)
    assert b.shape == (10, 30) and b.dtype == np.float32
    assert b.ctypes.data == ptr
    c = pool.empty("ids", 5, np.int32)
    assert c.ctypes.data != ptr
    del b, c
    d = pool.empty("ids", 2000, np.int32)
    assert d.shape == (2000,)
    ptr = d.ctypes.data
    d[:] = 7
    del d
    e = pool.empty("ids", 1500, np.int32)
    assert e.ctypes.data == ptr and (e == 7).all()


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
    # the one-pass layout: ids past the node pad or negative, too few rows,
    # rows not whole tiles, a node pad not whole blocks, unequal lengths
    ea = np.zeros((3, 2), np.float32)
    for bad in (dict(senders=np.array([0, 4, 1])),
                dict(receivers=np.array([0, -1, 1])),
                dict(num_nodes_pad=2 ** 31),
                dict(num_edges_pad=2),
                dict(num_edges_pad=-1),
                dict(num_edges_pad=10, node_block=4, edge_tile=8),
                dict(num_edges_pad=0, node_block=4, edge_tile=8),
                dict(num_nodes_pad=6, node_block=4, edge_tile=8),
                dict(node_block=4, edge_tile=0),
                dict(edge_attr=np.zeros((2, 2), np.float32))):
        kw = dict(senders=s, receivers=s, edge_attr=ea, num_nodes_pad=4,
                  num_edges_pad=8)
        kw.update(bad)
        with pytest.raises(ValueError):
            native.edge_layout(**kw)
    # the chunk plan: ids past num_segments, a chunk size below one
    with pytest.raises(ValueError):
        native.chunk_plan(s, 3, 16)
    with pytest.raises(ValueError):
        native.chunk_plan(s, 4, 0)


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
