"""Batching: MeshSample lists -> fixed-shape GraphBatch streams (the port's
own copy of aero_gnn_tpu.data.batching, without the BSMS hierarchies).

Every batch of one loader shares one padded shape. Samples are joined by
``graph.padded.batch_graphs`` and the batches land on the loader's device
(CUDA unless ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from aero_gnn_tpu_torch.data.dataset import MeshSample
from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.graph.padded import (
    ALIGN_EDGE_TILE,
    ALIGN_NODE_BLOCK,
    GraphBatch,
    _round_up,
    batch_graphs,
    bucket_size,
)


def sample_to_dict(s: MeshSample) -> Dict[str, np.ndarray]:
    return {
        "senders": s.senders.astype(np.int64),
        "receivers": s.receivers.astype(np.int64),
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


def compute_pad_spec(samples: List[MeshSample], batch_size: int, *,
                     align_edges: bool = False) -> PadSpec:
    """One shared padded shape for every batch of up to ``batch_size``
    samples: bucket the worst-case sum of the largest graphs. With
    ``align_edges`` the edge budget covers the worst-case block-alignment
    overhead (up to one tile per node block)."""
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
    return PadSpec(num_nodes_pad=nodes_pad, num_edges_pad=edges_pad,
                   num_graphs_pad=batch_size + 1)


class Loader:
    """Shuffling mini-batch loader with one padded shape. Yields
    (GraphBatch, aux) with aux["samples"] the batch's samples in order.
    ``align_edges=None`` means the block-aligned layout on the cuda backend
    (the fused kernels' layout), the plain one on the torch backend."""

    def __init__(self, samples: List[MeshSample], batch_size: int, *,
                 shuffle: bool = False, seed: int = 0,
                 num_scales: Optional[int] = None,
                 pad_spec: Optional[PadSpec] = None,
                 align_edges: Optional[bool] = None,
                 drop_remainder: bool = False, device: DeviceLike = None):
        if not samples:
            raise ValueError("Loader needs at least one sample")
        if num_scales is not None and num_scales > 1:
            raise NotImplementedError(
                "multi-scale (BSMS) hierarchies are not ported yet: they "
                "belong to the BSMS slice (ROADMAP queue 1 item 7)")
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
        self.pad_spec = pad_spec or compute_pad_spec(
            samples, batch_size, align_edges=align_edges)

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
            batch_samples = [self.samples[i] for i in order[b * bs:
                                                            (b + 1) * bs]]
            gb = batch_graphs(
                [sample_to_dict(s) for s in batch_samples],
                num_nodes_pad=self.pad_spec.num_nodes_pad,
                num_edges_pad=self.pad_spec.num_edges_pad,
                num_graphs_pad=self.pad_spec.num_graphs_pad,
                align_edges=self.align_edges, device=self.device)
            yield gb, {"samples": batch_samples}
