"""Port parity for the BSMS hierarchies: every array of the port's
graph.hierarchy builder and collation, of align_hierarchy and of the
Loader's batches is bit-equal (np.array_equal, same int32 / float32 dtypes)
to the JAX package's, for the stride and bistride modes and one and two
samples; the Loader's aligned levels on the native graph core equal the
plain path's (numpy sorts, the Python block balance, collation's own
permutations) at 8,192 nodes, the realigned batch too; and the pad-tail
invariant the kernels rely on holds on every stream."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from aero_gnn_tpu.data import batching as JB
from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.graph import hierarchy as JH
from aero_gnn_tpu.graph import padded as JP
from aero_gnn_tpu_torch.data import batching as TB
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data import synthetic as TS
from aero_gnn_tpu_torch.graph import hierarchy as TH
from aero_gnn_tpu_torch.graph import padded as TP
from aero_gnn_tpu_torch.utils import profiling

SIZES = (600, 850)


def _samples(n_samples, jax_side):
    make = JS.make_random_mesh_sample if jax_side else \
        TS.make_random_mesh_sample
    out = [make(n_nodes=SIZES[i], seed=i + 4) for i in range(n_samples)]
    (JD if jax_side else TD).compute_features(out, ["mach", "alpha"])
    return out


def _real(s, mode, num_scales=3):
    return dict(senders=s.senders, receivers=s.receivers,
                node_graph=np.zeros(s.num_nodes, np.int64),
                num_nodes=s.num_nodes, pos=s.pos.astype(np.float64),
                num_scales=num_scales, mode=mode)


def assert_level_equal(t, j, tag=""):
    """Every field of a port HierarchyLevel against the JAX one."""
    for f in dataclasses.fields(j):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if jv is None:
            assert tv is None, (tag, f.name)
            continue
        if isinstance(tv, int):
            assert tv == int(jv), (tag, f.name)
            continue
        assert tv.device.type == "cpu"
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                      err_msg=f"{tag} {f.name}")
        assert str(tv.dtype).rsplit(".", 1)[-1] == str(jv.dtype), \
            (tag, f.name, tv.dtype, jv.dtype)


def assert_levels_equal(ts, js, tag=""):
    assert len(ts) == len(js)
    for s, (t, j) in enumerate(zip(ts, js)):
        assert_level_equal(t, j, f"{tag} level {s}")


def _assert_real_equal(tl, jl):
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert t.keys() == j.keys()
        for k, v in j.items():
            if v is None or np.isscalar(v):
                assert t[k] == v, k
            else:
                np.testing.assert_array_equal(t[k], v, err_msg=k)


@pytest.mark.parametrize("n_samples", [1, 2])
@pytest.mark.parametrize("mode", ["stride", "bistride"])
def test_real_collate_and_realign_match_jax(mode, n_samples):
    js, ts = _samples(n_samples, True), _samples(n_samples, False)
    jreal = [JH.build_hierarchy_real(**_real(s, mode)) for s in js]
    treal = [TH.build_hierarchy_real(**_real(s, mode)) for s in ts]
    for t, j in zip(treal, jreal):
        _assert_real_equal(t, j)
    dicts = [JB.sample_to_dict(s) for s in js]
    jg, jmap = JP.batch_graphs(dicts, num_nodes_pad=2048, align_edges=True,
                               num_edges_pad=16 * 1024,
                               return_align_map=True)
    tg, tmap = TP.batch_graphs(dicts, num_nodes_pad=2048, align_edges=True,
                               num_edges_pad=16 * 1024,
                               return_align_map=True, device="cpu")
    np.testing.assert_array_equal(tmap, jmap)
    plan = [(JP.bucket_size(sum(r[s]["num_nodes"] for r in jreal) + 1),
             JP.bucket_size(sum(r[s]["num_edges"] for r in jreal)))
            for s in range(2)]
    kw = dict(num_fine_nodes_pad=tg.num_nodes_pad,
              num_fine_edges_pad=tg.num_edges_pad, pad_plan=plan)
    jlv = JH.collate_hierarchies(jreal, **kw)
    tlv = TH.collate_hierarchies(treal, **kw, device="cpu")
    assert_levels_equal(tlv, jlv, "collate")


@pytest.mark.parametrize("mode", ["stride", "bistride"])
def test_build_hierarchy_matches_jax(mode):
    """The port's one builder (the real levels, collated) against the JAX
    package's padded builder, and without positions against its real
    builder, collated."""
    (js,), (ts,) = _samples(1, True), _samples(1, False)
    kw = _real(js, mode)
    jlv = JH.build_hierarchy(**kw, num_fine_nodes_pad=1024,
                             num_fine_edges_pad=4096)
    ckw = dict(num_fine_nodes_pad=1024, num_fine_edges_pad=4096,
               pad_plan=[(lv.num_coarse_nodes_pad, lv.num_coarse_edges_pad)
                         for lv in jlv])
    tlv = TH.collate_hierarchies([TH.build_hierarchy_real(**_real(ts, mode))],
                                 **ckw, device="cpu")
    assert_levels_equal(tlv, jlv, "build_hierarchy")
    # no positions: the stride sort keeps node order, uniform weights
    kw.pop("pos")
    jreal, treal = JH.build_hierarchy_real(**kw), TH.build_hierarchy_real(**kw)
    _assert_real_equal(treal, jreal)
    ckw["pad_plan"] = [(JP.bucket_size(lv["num_nodes"] + 1),
                        JP.bucket_size(lv["num_edges"])) for lv in jreal]
    assert_levels_equal(TH.collate_hierarchies([treal], **ckw, device="cpu"),
                        JH.collate_hierarchies([jreal], **ckw), "no pos")


@pytest.mark.parametrize("targets", [False, True])
@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("mode", ["stride", "bistride"])
def test_align_hierarchy_matches_jax(mode, balance, targets):
    js, ts = _samples(2, True), _samples(2, False)
    jreal = [JH.build_hierarchy_real(**_real(s, mode)) for s in js]
    treal = [TH.build_hierarchy_real(**_real(s, mode)) for s in ts]
    spec = JB.compute_pad_spec(js, 2, hierarchy_levels=jreal,
                               align_edges=True)
    dicts = [JB.sample_to_dict(s) for s in js]
    kw = dict(num_nodes_pad=spec.num_nodes_pad,
              num_edges_pad=spec.num_edges_pad, align_edges=True,
              return_align_map=True)
    jg, jmap = JP.batch_graphs(dicts, **kw)
    tg, tmap = TP.batch_graphs(dicts, **kw, device="cpu")
    ckw = dict(num_fine_nodes_pad=spec.num_nodes_pad,
               num_fine_edges_pad=spec.num_edges_pad,
               pad_plan=spec.hierarchy_pad_plan)
    jlv = JH.collate_hierarchies(jreal, **ckw)
    tlv = TH.collate_hierarchies(treal, **ckw, device="cpu")
    akw = dict(balance_blocks=balance)
    if targets:
        free = JH.align_hierarchy(jlv, jmap, balance_blocks=balance)
        akw["edge_pad_targets"] = [lv.num_coarse_edges_pad + 2048
                                   for lv in free]
    jal = JH.align_hierarchy(jlv, jmap, **akw)
    tal = TH.align_hierarchy(tlv, tmap, **akw, device="cpu")
    assert_levels_equal(tal, jal, f"align {mode} {akw}")
    assert all(lv.edges_aligned for lv in tal)
    with pytest.raises(ValueError, match="edge_pad_targets"):
        TH.align_hierarchy(tlv, tmap, edge_pad_targets=[1024, 1024],
                           device="cpu")


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("mode", ["stride", "bistride"])
def test_loader_hierarchy_matches_jax(mode, align):
    js, ts = _samples(2, True), _samples(2, False)
    for bs in (1, 2):
        jl = JB.Loader(js, bs, num_scales=3, hierarchy_mode=mode,
                       align_edges=align)
        tl = TB.Loader(ts, bs, num_scales=3, hierarchy_mode=mode,
                       align_edges=align, device="cpu")
        assert dataclasses.asdict(tl.pad_spec) == \
            dataclasses.asdict(jl.pad_spec)
        for (jg, jaux), (tg, taux) in zip(jl, tl):
            for name in ("senders", "receivers", "sender_perm",
                         "senders_sorted", "edge_mask", "node_mask"):
                np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                              np.asarray(getattr(jg, name)))
            assert_levels_equal(taux["hierarchy"], jaux["hierarchy"],
                                f"loader {mode} align={align} bs={bs}")


def _plain_levels(self, idx, amap):
    """The Loader's aligned hierarchy the plain way: collated with the
    collation's own sorted-pool permutations (which the alignment then
    builds anew), aligned through the public align_hierarchy."""
    spec = self.pad_spec
    levels = TH.collate_hierarchies(
        [self._hier[i] for i in idx], num_fine_nodes_pad=spec.num_nodes_pad,
        num_fine_edges_pad=spec.num_edges_pad,
        pad_plan=spec.hierarchy_pad_plan, device="cpu")
    try:
        return TH.align_hierarchy(
            levels, amap, edge_pad_targets=spec.hierarchy_aligned_edges,
            device="cpu")
    except ValueError:
        warnings.warn("hierarchy aligned-edge budget exceeded; realigning")
        return TH.align_hierarchy(levels, amap, device="cpu")


def _aligned_batches(samples, bs, pad_spec=None):
    """(every batch's hierarchy, counters of the pass) of an aligned
    bistride Loader."""
    loader = TB.Loader(samples, bs, num_scales=3, hierarchy_mode="bistride",
                       align_edges=True, pad_spec=pad_spec, device="cpu")
    profiling.reset_counters()
    out = [aux["hierarchy"] for _, aux in loader]
    return out, {k: v for k, v in profiling.counters().items()
                 if k.startswith("hierarchy.")}


def _over_budget(samples):
    """A PadSpec whose level-0 aligned coarse-edge budget is one tile, so
    every batch takes the realign path."""
    spec = TB.Loader(samples, 1, num_scales=3, hierarchy_mode="bistride",
                     align_edges=True, device="cpu").pad_spec
    return dataclasses.replace(spec, hierarchy_aligned_edges=[
        TP.ALIGN_EDGE_TILE] + spec.hierarchy_aligned_edges[1:])


def test_loader_native_alignment_equals_plain(monkeypatch):
    samples = [TS.make_random_mesh_sample(n_nodes=8192, seed=21 + i)
               for i in range(2)]
    TD.compute_features(samples, ["mach", "alpha"])
    over = _over_budget(samples[:1])
    runs = {}
    for plain in (False, True):
        with monkeypatch.context() as m:
            if plain:
                m.setattr(TH.native, "balance_slots",
                          TH._balance_block_slots_ref)
                m.setattr(TH.native, "sort_edges_by_receiver",
                          lambda s, r, n: np.lexsort((s, r)))
                m.setattr(TH.native, "argsort_i32",
                          lambda k, n: np.argsort(k, kind="stable")
                          .astype(np.int32))
                m.setattr(TB.Loader, "_levels", _plain_levels)
            bs1 = _aligned_batches(samples, 1)
            bs2 = _aligned_batches(samples, 2)
            with pytest.warns(UserWarning, match="budget exceeded"):
                realign = _aligned_batches(samples[:1], 1, over)
            runs[plain] = dict(bs1=bs1, bs2=bs2, realign=realign)
    for case, (levels, counts) in runs[False].items():
        plain_levels, _ = runs[True][case]
        assert len(levels) == len(plain_levels) >= 1, case
        for b, (got, ref) in enumerate(zip(levels, plain_levels)):
            assert len(got) == len(ref) == 2
            for s, (g, r) in enumerate(zip(got, ref)):
                tag = f"{case} batch {b} level {s}"
                assert g.edges_aligned, tag
                for f in dataclasses.fields(r):
                    a, e = getattr(g, f.name), getattr(r, f.name)
                    if isinstance(e, torch.Tensor):
                        assert a.dtype == e.dtype and torch.equal(a, e), \
                            (tag, f.name)
                    else:
                        assert a == e, (tag, f.name)
    # several node blocks a level, so the balance has blocks to choose
    lv = runs[False]["bs2"][0][0]
    assert all(v.num_coarse_nodes_pad // TP.ALIGN_NODE_BLOCK >= 4
               for v in lv)
    # each batch balances its 2 levels; the realigned batch balanced level
    # 0 once before its budget failed, then both levels again
    assert runs[False]["bs1"][1] == {"hierarchy.levels_balanced": 4}
    assert runs[False]["bs2"][1] == {"hierarchy.levels_balanced": 2}
    assert runs[False]["realign"][1] == {"hierarchy.levels_balanced": 3,
                                         "hierarchy.realigned": 1}


def _check_tail(senders_sorted, sender_perm, receivers, edge_mask, sink,
                aligned, tag):
    """Every row keyed by the pad sink is a masked row and those rows are
    the stream's tail (the kernels' pad_sink skips them). On an aligned
    stream a tile whose first row is masked holds masked rows only, and in
    each node block such pad tiles come after the tiles with a real first
    row (K1 / K2 walk only the latter). Returns the rows before the tail."""
    r = receivers.numpy()
    m = edge_mask.numpy()
    assert np.all(m[r == sink] == 0), tag
    live = int(np.searchsorted(r, sink))
    assert np.all(r[live:] == sink) and np.all(r[:live] != sink), tag
    k = senders_sorted.numpy()
    assert np.all(m[sender_perm.numpy()[k == sink]] == 0), tag
    assert np.all(k[int(np.searchsorted(k, sink)):] == sink), tag
    if aligned:
        et = TP.ALIGN_EDGE_TILE
        assert live % et == 0, tag
        tiles = m.reshape(-1, et)
        pad = tiles[:, 0] == 0
        assert np.all(tiles[pad] == 0), tag
        block = r[::et] // TP.ALIGN_NODE_BLOCK
        for b in np.unique(block):
            assert np.all(np.diff(pad[block == b].astype(int)) >= 0), tag
    return live


@pytest.mark.parametrize("align", [False, True])
def test_pad_tail_invariant(align):
    """The kernels skip a stream's pad-sink tail and its pad tiles (the
    same layout on every aligned level): every row there must be a masked
    pad row."""
    ts = _samples(2, False)
    for mode in ("stride", "bistride"):
        loader = TB.Loader(ts, 2, num_scales=3, hierarchy_mode=mode,
                           align_edges=align, device="cpu")
        for g, aux in loader:
            live = _check_tail(g.senders_sorted, g.sender_perm, g.receivers,
                               g.edge_mask, g.num_nodes_pad - 1, align,
                               f"graph {mode} {align}")
            assert live < g.num_edges_pad
            for s, lv in enumerate(aux["hierarchy"]):
                _check_tail(lv.senders_sorted, lv.sender_perm, lv.receivers,
                            lv.edge_mask, lv.num_coarse_nodes_pad - 1,
                            align, f"level {s} {mode} {align}")
                if align:
                    assert lv.num_coarse_nodes_pad % TP.ALIGN_NODE_BLOCK == 0
    g = TP.build_graph_batch(**{k: v for k, v in
                                JB.sample_to_dict(ts[0]).items()},
                             align_edges=True, device="cpu")
    _check_tail(g.senders_sorted, g.sender_perm, g.receivers, g.edge_mask,
                g.num_nodes_pad - 1, True, "tight graph")
    moved = aux["hierarchy"][0].to("cpu")
    assert torch.equal(moved.receivers, aux["hierarchy"][0].receivers)
