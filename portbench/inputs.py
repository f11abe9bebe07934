"""The benchmark's frozen inputs: the random planar benchmark mesh and its
features, copied from the port's ``data.synthetic.make_random_mesh_sample``,
``graph.order.morton_order`` and ``data.dataset.compute_features`` so that
a later change to the port's data code cannot move the yardstick.

A ``Mesh`` holds numpy arrays only; ``run.py`` hands the port its own
``MeshSample`` built from them, and the reference reads them directly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
from scipy.spatial import cKDTree


@dataclasses.dataclass
class Mesh:
    pos: np.ndarray  # f32[N, 2]
    normals: np.ndarray  # f32[N, 2]
    senders: np.ndarray  # i64[E], directed, both directions present
    receivers: np.ndarray  # i64[E]
    y: np.ndarray  # f32[N, 4]
    meta: Dict[str, float]
    x: np.ndarray = None  # f32[N, 6] = [pos, normals, mach, alpha]
    edge_attr: np.ndarray = None  # f32[E, 3] = [dpos, |dpos|]

    @property
    def num_nodes(self) -> int:
        return self.pos.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]


def sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed derived from the run's seed and a path of indices."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1)[0])


def morton_order(pos: np.ndarray, bits: int = 16) -> np.ndarray:
    p = pos - pos.min(axis=0)
    denom = np.maximum(p.max(axis=0), 1e-12)
    q = np.minimum(((p / denom) * (2**bits - 1)).astype(np.uint64),
                   2**bits - 1)
    code = np.zeros(len(pos), dtype=np.uint64)
    for b in range(bits):
        for d in range(min(pos.shape[1], 2)):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                2 * b + d)
    return np.argsort(code, kind="stable")


def random_mesh(n_nodes: int, avg_degree: int, seed: int) -> Mesh:
    """k-NN graph over uniform random points in the unit square, Morton
    sorted, symmetrised and de-duplicated (244,350 edges at 65,536 nodes);
    targets sin(3x) cos(2y) on each of 4 fields."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n_nodes, 2))
    pos = pos[morton_order(pos)]
    k = max(2, avg_degree // 2)
    _, nbr = cKDTree(pos).query(pos, k=k + 1, workers=-1)
    send = np.repeat(np.arange(n_nodes, dtype=np.int64), k)
    recv = nbr[:, 1:].reshape(-1).astype(np.int64)
    senders = np.concatenate([send, recv])
    receivers = np.concatenate([recv, send])
    _, uniq = np.unique(senders * n_nodes + receivers, return_index=True)
    senders, receivers = senders[uniq], receivers[uniq]
    normals = rng.standard_normal((n_nodes, 2))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    y = np.sin(3 * pos[:, :1]) * np.cos(2 * pos[:, 1:2]) * np.ones((1, 4))
    return Mesh(pos=pos.astype(np.float32),
                normals=normals.astype(np.float32), senders=senders,
                receivers=receivers, y=y.astype(np.float32),
                meta={"mach": 0.5, "alpha": 0.0})


def compute_features(mesh: Mesh) -> None:
    """x = [pos, normals, mach, alpha]; edge_attr = [dpos, |dpos|]."""
    n = mesh.num_nodes
    flow = np.array([mesh.meta["mach"], mesh.meta["alpha"]], np.float64)
    mesh.x = np.concatenate(
        [mesh.pos, mesh.normals, np.broadcast_to(flow[None, :], (n, 2))],
        axis=1).astype(np.float32)
    vec = mesh.pos[mesh.receivers] - mesh.pos[mesh.senders]
    mesh.edge_attr = np.concatenate(
        [vec, np.linalg.norm(vec, axis=1, keepdims=True)], axis=1)
