"""The (data, graph) rank grid (counterpart of aero_gnn_tpu.parallel.mesh,
mesh.py:22-100).

  * ``data``  — many small meshes, batch-parallel (one gradient all-reduce
    per step);
  * ``graph`` — one large mesh, node-partitioned with a halo exchange per
    layer.

``make_mesh`` lays the world's ranks out as a [data, graph] grid and, when
``torch.distributed`` is initialised, builds one process group per row
(this rank's ``graph`` group) and per column (its ``data`` group). Every
rank must call it, with the same arguments: each group is made by all
ranks together. ``make_mesh_dcn`` groups ranks by host where JAX groups
devices by ``slice_index``: a host holds ``local_world_size`` consecutive
ranks (``LOCAL_WORLD_SIZE``), and a graph group, which carries the
per-layer exchanges, never straddles two hosts. ``local_device_count`` is
the devices this process can place a rank on.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from aero_gnn_tpu_torch.parallel import collectives as C

AXES = ("data", "graph")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``ranks`` [data, graph]; ``groups`` this rank's Group per axis
    (``"data"``, ``"graph"``) and over the whole grid (``"world"``), None
    when the layout was made without ``torch.distributed``."""

    ranks: np.ndarray
    groups: Optional[dict] = None

    @property
    def shape(self):
        return self.ranks.shape

    def group(self, axis: str) -> C.Group:
        if self.groups is None:
            if self.ranks.size == 1:
                return C.make_group(None)
            raise RuntimeError("this mesh spans several ranks and "
                               "torch.distributed is not initialised")
        return self.groups[axis]

    def coords(self, rank: Optional[int] = None):
        """(data index, graph index) of ``rank`` (this rank by default)."""
        rank = dist.get_rank() if rank is None else rank
        d, g = np.argwhere(self.ranks == rank)[0]
        return int(d), int(g)


def _check_shape(n: int, data: int, graph: int) -> int:
    if graph < 1 or n % graph:
        raise ValueError(f"graph axis {graph} must divide device count {n}")
    if data == -1:
        data = n // graph
    if data * graph != n:
        raise ValueError(f"mesh {data}x{graph} != {n} devices")
    return data


def _world_ranks(ranks: Optional[Sequence[int]]) -> list:
    if ranks is not None:
        return [int(r) for r in ranks]
    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def _build(arr: np.ndarray) -> Mesh:
    """The Mesh of layout ``arr``, with its process groups when
    torch.distributed is initialised (every rank builds every group, rows
    first, in the same order)."""
    if not dist.is_initialized():
        return Mesh(arr)
    me = dist.get_rank()
    groups = {}
    for axis, lines in (("graph", arr), ("data", arr.T)):
        for line in lines:
            pg = dist.new_group([int(r) for r in line])
            if me in line:
                groups[axis] = C.make_group(pg)
    groups["world"] = C.make_group(dist.group.WORLD)
    return Mesh(arr, groups)


def make_mesh(*, data: int = -1, graph: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A (data, graph) grid of ``ranks`` (the world's by default) in their
    order. ``data=-1`` uses all remaining ranks."""
    rs = _world_ranks(ranks)
    data = _check_shape(len(rs), data, graph)
    return _build(np.asarray(rs).reshape(data, graph))


def make_mesh_dcn(*, data: int = -1, graph: int = 1,
                  ranks: Optional[Sequence[int]] = None,
                  local_world_size: Optional[int] = None) -> Mesh:
    """Host-aware (data, graph) grid: ranks grouped by host (rank //
    ``local_world_size``, default ``LOCAL_WORLD_SIZE``, else one host),
    host-major and in rank order within a host, so every row (a graph
    group) lies on one host and only the data axis crosses hosts. ValueError
    on uneven hosts or a graph axis that does not divide a host's ranks."""
    rs = _world_ranks(ranks)
    n = len(rs)
    data = _check_shape(n, data, graph)
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    hosts = sorted({r // local_world_size for r in rs})
    if len(hosts) > 1:
        per = n // len(hosts)
        groups = []
        for h in hosts:
            g = sorted(r for r in rs if r // local_world_size == h)
            if len(g) != per:
                raise ValueError(f"uneven hosts: host {h} has {len(g)} "
                                 f"ranks, expected {per}")
            groups.append(g)
        if per % graph:
            raise ValueError(
                f"graph axis {graph} does not divide the per-host rank "
                f"count {per}; a graph group must not straddle hosts")
        arr = np.asarray([r for g in groups for r in g]).reshape(data, graph)
    else:
        arr = np.asarray(sorted(rs)).reshape(data, graph)
    return _build(arr)


def local_device_count() -> int:
    """The devices this process can place a rank on: the CUDA cards it
    sees (``torch.cuda.device_count()``, as ``parallel.distributed``
    counts them), or 1 without a card, the CPU (as JAX counts its one CPU
    device)."""
    return torch.cuda.device_count() or 1
