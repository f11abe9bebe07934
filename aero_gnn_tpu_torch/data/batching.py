"""Batching: MeshSample lists -> fixed-shape GraphBatch streams (the port's
own copy of aero_gnn_tpu.data.batching).

Every batch of one loader shares one padded shape. Samples are joined by
``graph.padded.batch_graphs`` and the batches land on the loader's device
(CUDA unless ``"cpu"``). For BSMS models (``num_scales > 1``) each
sample's hierarchy is built once and cached, then collated per batch with
coarse-id offsets (``graph.hierarchy.collate_host``) and, with the
aligned layout, block-aligned at every level (``align_host``, which copies
each level to the device once).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from aero_gnn_tpu_torch.data.dataset import MeshSample
from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.graph import hierarchy as H
from aero_gnn_tpu_torch.graph.padded import (
    ALIGN_EDGE_TILE,
    ALIGN_NODE_BLOCK,
    GraphBatch,
    _round_up,
    batch_graphs,
    bucket_size,
)
from aero_gnn_tpu_torch.utils.profiling import annotate, count


def sample_to_dict(s: MeshSample) -> Dict[str, np.ndarray]:
    """A sample's arrays, uncopied (``batch_graphs`` offsets the ids into
    int32 itself)."""
    return {
        "senders": s.senders,
        "receivers": s.receivers,
        "x": s.x,
        "edge_attr": s.edge_attr,
        "pos": s.pos,
        "y": s.y,
    }


@dataclasses.dataclass
class PadSpec:
    num_nodes_pad: int
    num_edges_pad: int
    num_graphs_pad: int
    hierarchy_pad_plan: Optional[List[Tuple[int, int]]] = None
    # fixed aligned coarse-edge counts per level (align_edges loaders), so
    # every batch has one shape
    hierarchy_aligned_edges: Optional[List[int]] = None


def compute_pad_spec(samples: List[MeshSample], batch_size: int, *,
                     hierarchy_levels: Optional[List[List[dict]]] = None,
                     align_edges: bool = False) -> PadSpec:
    """One shared padded shape for every batch of up to ``batch_size``
    samples: bucket the worst-case sum of the largest graphs. With
    ``align_edges`` the edge budget covers the worst-case block-alignment
    overhead (up to one tile per node block); with hierarchies, a pad plan
    per level and (aligned) a coarse edge budget per level."""
    ns = sorted((s.num_nodes for s in samples), reverse=True)
    es = sorted((s.num_edges for s in samples), reverse=True)
    worst_n = sum(ns[:batch_size])
    worst_e = sum(es[:batch_size])
    if align_edges:
        nodes_pad = bucket_size(worst_n + 1, multiple=ALIGN_NODE_BLOCK)
        n_blocks = nodes_pad // ALIGN_NODE_BLOCK
        edges_pad = _round_up(worst_e + n_blocks * ALIGN_EDGE_TILE,
                              ALIGN_EDGE_TILE)
    else:
        nodes_pad = bucket_size(worst_n + 1)
        edges_pad = bucket_size(worst_e)
    spec = PadSpec(num_nodes_pad=nodes_pad, num_edges_pad=edges_pad,
                   num_graphs_pad=batch_size + 1)
    if hierarchy_levels is not None:
        plan, aligned_plan = [], []
        for s_idx in range(len(hierarchy_levels[0])):
            cns = sorted((lv[s_idx]["num_nodes"] for lv in hierarchy_levels),
                         reverse=True)
            ces = sorted((lv[s_idx]["num_edges"] for lv in hierarchy_levels),
                         reverse=True)
            nc_pad = bucket_size(sum(cns[:batch_size]) + 1)
            ec_pad = bucket_size(sum(ces[:batch_size]))
            plan.append((nc_pad, ec_pad))
            if align_edges:
                nc2 = max(_round_up(nc_pad, ALIGN_NODE_BLOCK),
                          ALIGN_NODE_BLOCK)
                n_blocks = nc2 // ALIGN_NODE_BLOCK
                worst_ce = sum(ces[:batch_size])
                # naive worst case: one extra tile per coarse node block
                naive = _round_up(
                    worst_ce + n_blocks * ALIGN_EDGE_TILE, ALIGN_EDGE_TILE)
                # align_hierarchy balances per-block degree sums (greedy
                # min-load: max block load <= ceil(E/B) + max item weight)
                dmax = 0
                for lv in hierarchy_levels:
                    lvl = lv[s_idx]
                    if lvl["num_nodes"]:
                        deg = (np.bincount(lvl["receivers"],
                                           minlength=lvl["num_nodes"])
                               + np.bincount(lvl["senders"],
                                             minlength=lvl["num_nodes"]))
                        dmax = max(dmax, int(deg.max()))
                per_block = -(-worst_ce // n_blocks) + dmax
                balanced = (n_blocks * (-(-per_block // ALIGN_EDGE_TILE))
                            + 1) * ALIGN_EDGE_TILE
                aligned_plan.append(min(naive, balanced))
        spec.hierarchy_pad_plan = plan
        spec.hierarchy_aligned_edges = aligned_plan if align_edges else None
    return spec


class Loader:
    """Shuffling mini-batch loader with one padded shape. Yields
    (GraphBatch, aux) with aux["samples"] the batch's samples in order and,
    with ``num_scales > 1``, aux["hierarchy"] a tuple of HierarchyLevel on
    the loader's device. ``align_edges=None`` means the block-aligned
    layout on the cuda backend (the fused kernels' layout), the plain one
    on the torch backend."""

    def __init__(self, samples: List[MeshSample], batch_size: int, *,
                 shuffle: bool = False, seed: int = 0,
                 num_scales: Optional[int] = None,
                 hierarchy_mode: str = "stride", stride: int = 2,
                 pad_spec: Optional[PadSpec] = None,
                 align_edges: Optional[bool] = None,
                 drop_remainder: bool = False, device: DeviceLike = None):
        if not samples:
            raise ValueError("Loader needs at least one sample")
        self.device = resolve_device(device)
        self.samples = samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0
        if align_edges is None:
            from aero_gnn_tpu_torch import ops

            align_edges = ops.backend() == "cuda"
        self.align_edges = align_edges
        self._hier: Optional[List[List[dict]]] = None
        if num_scales is not None and num_scales > 1:
            self._hier = [
                H.build_hierarchy_real(
                    senders=s.senders, receivers=s.receivers,
                    node_graph=np.zeros(s.num_nodes, np.int64),
                    num_nodes=s.num_nodes, pos=s.pos.astype(np.float64),
                    num_scales=num_scales, mode=hierarchy_mode,
                    stride=stride)
                for s in samples]
        self.pad_spec = pad_spec or compute_pad_spec(
            samples, batch_size, hierarchy_levels=self._hier,
            align_edges=align_edges)

    def __len__(self) -> int:
        n = len(self.samples)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[GraphBatch, dict]]:
        order = np.arange(len(self.samples))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        for b in range(len(self)):
            with annotate("aero.loader.batch"):
                idx = order[b * bs:(b + 1) * bs]
                batch_samples = [self.samples[i] for i in idx]
                # the align map only where a hierarchy is re-indexed by it
                need_map = self._hier is not None
                with annotate("aero.graph.build"):
                    built = batch_graphs(
                        [sample_to_dict(s) for s in batch_samples],
                        num_nodes_pad=self.pad_spec.num_nodes_pad,
                        num_edges_pad=self.pad_spec.num_edges_pad,
                        num_graphs_pad=self.pad_spec.num_graphs_pad,
                        align_edges=self.align_edges,
                        return_align_map=need_map,
                        device=self.device)
                gb, amap = built if need_map else (built, None)
                aux: dict = {"samples": batch_samples}
                if need_map:
                    with annotate("aero.loader.hierarchy"):
                        aux["hierarchy"] = tuple(self._levels(idx, amap))
            yield gb, aux

    def _levels(self, idx, amap) -> List[H.HierarchyLevel]:
        """The batch's hierarchy: collated, then (aligned layout) aligned at
        every level on the host and copied to the device once; a batch
        beyond the PadSpec's balanced coarse-edge budget is realigned with
        per-batch sizes, with a warning (counter ``hierarchy.realigned``)."""
        spec = self.pad_spec
        collate_kw = dict(num_fine_nodes_pad=spec.num_nodes_pad,
                          num_fine_edges_pad=spec.num_edges_pad,
                          pad_plan=spec.hierarchy_pad_plan)
        per_sample = [self._hier[i] for i in idx]
        if amap is None:
            with annotate("aero.hierarchy.collate"):
                levels = H.collate_hierarchies(per_sample, **collate_kw,
                                               device="cpu")
            with annotate("aero.hierarchy.to_device"):
                return [lv.to(self.device) for lv in levels]
        with annotate("aero.hierarchy.collate"):
            host = H.collate_host(per_sample, **collate_kw)
        with annotate("aero.hierarchy.align"):
            try:
                return H.align_host(
                    host, amap,
                    edge_pad_targets=spec.hierarchy_aligned_edges,
                    device=self.device)
            except ValueError:
                warnings.warn("hierarchy aligned-edge budget exceeded; "
                              "realigning this batch with per-batch sizes")
                count("hierarchy.realigned")
                return H.align_host(host, amap, device=self.device)
