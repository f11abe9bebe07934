"""Synthetic benchmark mesh (subset of aero_gnn_tpu.data.synthetic).

Makes the same numpy RNG calls in the same order as the JAX package's
generator, so one seed gives the same mesh in both packages.
"""

from __future__ import annotations

import numpy as np

from aero_gnn_tpu_torch.data.dataset import MeshSample
from aero_gnn_tpu_torch.graph.order import morton_order


def make_random_mesh_sample(*, n_nodes: int, avg_degree: int = 6,
                            seed: int = 0, dy: int = 4,
                            spatial_sort: bool = True,
                            dtype=np.float32) -> MeshSample:
    """Irregular random planar mesh: k-NN graph over random points,
    symmetrized and de-duplicated. ``spatial_sort`` orders node ids by
    Morton code (the id locality real mesh files have)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n_nodes, 2))
    if spatial_sort:
        pos = pos[morton_order(pos)]
    k = max(2, avg_degree // 2)
    try:
        from scipy.spatial import cKDTree

        _, nbr = cKDTree(pos).query(pos, k=k + 1)
        nbr = nbr[:, 1:]  # drop self
        send = np.repeat(np.arange(n_nodes, dtype=np.int64), k)
        recv = nbr.reshape(-1).astype(np.int64)
    except ImportError:  # grid-hash fallback, O(N k) python
        send, recv = _knn_grid(pos, k)
    senders = np.concatenate([send, recv])
    receivers = np.concatenate([recv, send])
    keys = senders * n_nodes + receivers
    _, uniq = np.unique(keys, return_index=True)
    senders, receivers = senders[uniq], receivers[uniq]
    normals = rng.standard_normal((n_nodes, 2))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    y = np.sin(3 * pos[:, :1]) * np.cos(2 * pos[:, 1:2]) * np.ones((1, dy))
    return MeshSample(
        pos=pos.astype(dtype), normals=normals.astype(dtype),
        senders=senders, receivers=receivers, y=y.astype(dtype),
        meta={"mach": 0.5, "alpha": 0.0, "airfoil": f"rand{seed}"},
    )


def _knn_grid(pos: np.ndarray, k: int):
    n_nodes = pos.shape[0]
    cell = 1.0 / max(1, int(np.sqrt(n_nodes / 4)))
    grid = {}
    ij = np.floor(pos / cell).astype(np.int64)
    for i, key in enumerate(map(tuple, ij)):
        grid.setdefault(key, []).append(i)
    send_l, recv_l = [], []
    for i in range(n_nodes):
        ci, cj = ij[i]
        cand = []
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                cand.extend(grid.get((ci + di, cj + dj), ()))
        cand = np.asarray([c for c in cand if c != i])
        if len(cand) == 0:
            cand = np.asarray([(i + 1) % n_nodes])
        d = np.linalg.norm(pos[cand] - pos[i], axis=1)
        for j in cand[np.argsort(d)[:k]]:
            send_l.append(i)
            recv_l.append(int(j))
    return (np.asarray(send_l, dtype=np.int64),
            np.asarray(recv_l, dtype=np.int64))
