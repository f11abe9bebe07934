"""The port's host-side partitions (parallel.spatial, halo, bsms_spatial)
bit-equal to the JAX package's, its rank grid (parallel.mesh) against
JAX's layout and errors, and parallel.distributed's bring-up rules and
rank launcher."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data.synthetic import make_random_mesh_sample
from aero_gnn_tpu.parallel import bsms_spatial as JB
from aero_gnn_tpu.parallel import halo as JH
from aero_gnn_tpu.parallel import spatial as JS
from aero_gnn_tpu.parallel.mesh import make_mesh as jax_mesh
from aero_gnn_tpu_torch.parallel import bsms_spatial as TB
from aero_gnn_tpu_torch.parallel import distributed as TD
from aero_gnn_tpu_torch.parallel import halo as TH
from aero_gnn_tpu_torch.parallel import mesh as TM
from aero_gnn_tpu_torch.parallel import spatial as TS


def _sample(n=700, seed=5):
    s = make_random_mesh_sample(n_nodes=n, seed=seed)
    JD.compute_features([s], ["mach", "alpha"])
    return s


def _kw(s, **kw):
    return dict(senders=s.senders, receivers=s.receivers, x=s.x,
                edge_attr=s.edge_attr, pos=s.pos, y=s.y, **kw)


# the port's own host-built sorts (the order of its sums on the card), with
# no JAX counterpart: tests/test_torch_determinism.py holds each to the
# stable sort of its table
PORT_ORDERS = {"send_perm", "send_sorted", "sender_perm_bnd",
               "senders_bnd_sorted", "f2c_order", "e2c_order",
               "coarse_sender_sort", "coarse_f2c_sort", "coarse_e2c_sort",
               "node_slot_order", "node_recv_order", "edge_slot_int_order",
               "edge_slot_bnd_order", "edge_recv_order", "up_send_order",
               "up_fetch_order"}


def assert_bit_equal(port, ref, path="graph"):
    """Every field of a port partition equals the JAX one's bit for bit
    (same dtype, shape and values); nested partitions and tuples too. The
    port's own sorts (PORT_ORDERS) have no JAX field."""
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            if f.name in PORT_ORDERS:
                assert not hasattr(ref, f.name), f"{path}.{f.name}"
                continue
            assert_bit_equal(getattr(port, f.name), getattr(ref, f.name),
                             f"{path}.{f.name}")
    elif isinstance(port, (tuple, list)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_bit_equal(a, b, f"{path}[{i}]")
    elif isinstance(port, np.ndarray):
        b = np.asarray(ref)
        assert port.dtype == b.dtype and port.shape == b.shape, path
        np.testing.assert_array_equal(port, b, err_msg=path)
    else:
        assert port == ref, path


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("align", [False, True])
def test_partition_graph_bit_equal(parts, align):
    s = _sample()
    assert_bit_equal(
        TS.partition_graph(**_kw(s, num_parts=parts, align_interior=align)),
        JS.partition_graph(**_kw(s, num_parts=parts, align_interior=align)))


@pytest.mark.parametrize("parts", [2, 4])
def test_partition_graph_halo_bit_equal(parts):
    s = _sample()
    assert_bit_equal(TH.partition_graph_halo(**_kw(s, num_parts=parts)),
                     JH.partition_graph_halo(**_kw(s, num_parts=parts)))


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("extra", [{}, {"halo_rows": 64,
                                        "edges_bnd_rows": 512}])
def test_partition_graph_halo_split_bit_equal(align, extra):
    s = _sample()
    kw = _kw(s, num_parts=2, align_interior=align, **extra)
    assert_bit_equal(TH.partition_graph_halo_split(**kw),
                     JH.partition_graph_halo_split(**kw))


def test_partition_graph_halo_split_edge_aux_bit_equal():
    s = _sample()
    aux = np.random.default_rng(0).standard_normal((len(s.senders), 3))
    kw = _kw(s, num_parts=3, align_interior=True, edge_aux=aux)
    assert_bit_equal(TH.partition_graph_halo_split(**kw),
                     JH.partition_graph_halo_split(**kw))


def test_partition_overrides_refused_like_jax():
    s = _sample()
    for kw in ({"halo_rows": 1}, {"edges_int_rows": 8},
               {"edges_int_rows": 1000, "align_interior": True}):
        with pytest.raises(ValueError):
            JH.partition_graph_halo_split(**_kw(s, num_parts=2, **kw))
        with pytest.raises(ValueError):
            TH.partition_graph_halo_split(**_kw(s, num_parts=2, **kw))


def test_halo_plan_bit_equal_and_complete():
    """_halo_plan against JAX's and a brute-force reckoning: every remote
    sender of every receiving shard has one slot whose send_idx row is
    that sender's local row on its owner."""
    s = _sample()
    order, new_of_old, n_local = TH._assign_parts(s.pos, s.num_nodes, 4)
    s_new, r_new = new_of_old[s.senders], new_of_old[s.receivers]
    args = (s_new, s_new // n_local, r_new // n_local, n_local, 4, 8)
    port, ref = TH._halo_plan(*args), JH._halo_plan(*args)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    send_idx, h, slot = port
    remote = args[1] != args[2]
    owner = slot[remote] // h
    np.testing.assert_array_equal(owner, args[1][remote])
    rows = send_idx[owner, args[2][remote], slot[remote] % h]
    np.testing.assert_array_equal(rows, s_new[remote] - owner * n_local)


@pytest.mark.parametrize("mode", ["stride", "bistride"])
def test_partition_bsms_bit_equal(mode):
    s = _sample(480, 9)
    kw = _kw(s, num_parts=2, num_scales=3, mode=mode, stride=2)
    assert_bit_equal(TB.partition_bsms(**kw), JB.partition_bsms(**kw))


@pytest.mark.parametrize("mode,align", [("stride", False),
                                        ("bistride", False),
                                        ("bistride", True)])
def test_partition_bsms_halo_and_transfer_plans_bit_equal(mode, align):
    """Every level (its split halo shard, provenance, WEC operators) and
    every level boundary's TransferPlan."""
    s = _sample(480, 9)
    kw = _kw(s, num_parts=3, num_scales=3, mode=mode, stride=2,
             align_interior=align)
    kw.update(senders=np.asarray(s.senders, np.int64),
              receivers=np.asarray(s.receivers, np.int64))
    port, ref = TB.partition_bsms_halo(**kw), JB.partition_bsms_halo(**kw)
    assert all(lv.plan is not None for lv in port.levels[:-1])
    assert_bit_equal(port, ref)


def test_unshard_fine_follows_the_provenance():
    """The fine level's rows back in node order by its node_rows: shard
    row (p, i) holds node node_rows[p, i]."""
    s = _sample(480, 9)
    bg = TB.partition_bsms_halo(**_kw(s, num_parts=3, num_scales=3))
    rows = bg.levels[0].node_rows
    got = TB.unshard_fine(bg, rows[..., None].astype(np.float64))
    np.testing.assert_array_equal(got[:, 0], np.arange(s.num_nodes))
    x = TB.unshard_fine(bg, bg.fine.x)
    np.testing.assert_array_equal(x, s.x)


def test_owner_and_fetch_routes_bit_equal():
    rng = np.random.default_rng(1)
    n_dst, parts = 50, 3
    tgt = rng.integers(0, n_dst + 4, (parts, 40))
    owner = np.concatenate([rng.integers(0, parts, n_dst),
                            -np.ones(4, np.int64)])
    slot = rng.integers(0, 20, n_dst + 4)
    args = (tgt, owner, slot, np.arange(parts), 20, parts)
    for fp, fj in ((TB._owner_route, JB._owner_route),
                   (TB._fetch_route, JB._fetch_route)):
        for a, b in zip(fp(*args), fj(*args)):
            np.testing.assert_array_equal(a, b)


def test_shard_strips_the_leading_axis():
    s = _sample()
    sg = TH.partition_graph_halo_split(**_kw(s, num_parts=2))
    sh = sg.shard(1, "cpu")
    assert sh.x.shape == sg.x.shape[1:] and sh.send_idx.dtype == torch.int32
    np.testing.assert_array_equal(sh.senders_bnd.numpy(), sg.senders_bnd[1])
    bg = TB.partition_bsms_halo(**_kw(s, num_parts=2, num_scales=3))
    lv = bg.shard(0, "cpu").levels[1]
    assert lv.pos_of_node.shape == bg.levels[1].pos_of_node.shape
    assert lv.plan.up_fetch.shape == bg.levels[1].plan.up_fetch.shape[1:]


def test_make_mesh_layout_and_errors_match_jax():
    """The grid's layout is JAX's over the same count, and the same shapes
    are refused with the same messages."""
    assert TM.make_mesh().shape == (1, 1)
    ranks = list(range(8))
    for data, graph in ((2, 4), (-1, 2), (8, 1)):
        m = TM.make_mesh(data=data, graph=graph, ranks=ranks)
        j = jax_mesh(data=data, graph=graph)
        np.testing.assert_array_equal(
            m.ranks, np.vectorize(lambda d: d.id)(j.devices))
    for data, graph in ((3, 2), (2, 3), (1, 0)):
        with pytest.raises(ValueError) as port_err:
            TM.make_mesh(data=data, graph=graph, ranks=ranks)
        with pytest.raises(ValueError) as jax_err:
            jax_mesh(data=data, graph=graph)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(RuntimeError, match="not initialised"):
        TM.make_mesh(data=2, graph=4, ranks=ranks).group("graph")


def test_make_mesh_dcn_rows_stay_on_one_host():
    """Hosts faked by local_world_size, as tests/test_parallel.py:301
    fakes slices: each row (a graph group) lies on one host, the data axis
    spans both, and a graph group across hosts is refused."""
    shuffled = [3, 7, 0, 4, 1, 5, 2, 6]
    m = TM.make_mesh_dcn(data=4, graph=2, ranks=shuffled,
                         local_world_size=4)
    assert m.shape == (4, 2)
    for row in m.ranks:
        assert len({r // 4 for r in row}) == 1
    assert {row[0] // 4 for row in m.ranks} == {0, 1}
    np.testing.assert_array_equal(
        TM.make_mesh_dcn(data=2, graph=4, ranks=shuffled).ranks,
        TM.make_mesh(data=2, graph=4, ranks=range(8)).ranks)
    with pytest.raises(ValueError, match="straddle"):
        TM.make_mesh_dcn(data=1, graph=8, ranks=shuffled,
                         local_world_size=4)
    with pytest.raises(ValueError, match="uneven hosts"):
        TM.make_mesh_dcn(data=3, graph=1, ranks=[0, 1, 2],
                         local_world_size=2)


def test_initialize_without_a_cluster_is_a_noop(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    TD.initialize(device="cpu")
    TD.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert TD.is_primary() and TD.global_device_count() == 1
    with pytest.raises(ValueError, match="explicit cluster spec"):
        TD.initialize("localhost:1234", device="cpu")


def test_backend_choice(monkeypatch):
    """gloo on the CPU and when ranks share a card, nccl when each rank has
    its own; a rank asked for the card without one raises."""
    assert TD.choose_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TD.choose_backend(1) == "nccl"
    assert TD.choose_backend(2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert TD.choose_backend(4) == "nccl"
    monkeypatch.setenv("LOCAL_RANK", "5")
    assert TD.rank_device() == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.rank_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.choose_backend(1)
    assert TD.rank_device("cpu") == torch.device("cpu")


def test_spawn_reports_a_failing_rank(tmp_path):
    """A rank that raises fails the launch with its traceback, and the rank
    left waiting in a collective is killed rather than waited for."""
    with pytest.raises(RuntimeError, match="rank 1 gave up") as err:
        R.run_ranks(R.failing_program, 2, tmp_path, None)
    assert "job 0 rank 0" in str(err.value)
