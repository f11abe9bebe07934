"""Synthetic meshes (the port's own copy of aero_gnn_tpu.data.synthetic).

  * the airfoil family: closed NACA-4-digit-like contours with analytic
    pressure / shear / temperature fields parameterised by (mach, alpha),
    so the whole pipeline (features -> normalise -> train -> infer ->
    coefficients) runs without mesh files (the CLI's synthetic_airfoil);
  * the random benchmark mesh (``make_random_mesh_sample``).

Both make the same numpy RNG calls in the same order as the JAX package's
generators, so one seed gives the same samples in both packages.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from aero_gnn_tpu_torch.data.dataset import MeshSample
from aero_gnn_tpu_torch.graph.order import morton_order


def naca_profile(n_points: int, thickness: float = 0.12,
                 camber: float = 0.02, camber_pos: float = 0.4) -> np.ndarray:
    """Closed airfoil contour [N, 2], counter-clockwise from trailing edge."""
    # cosine-spaced chordwise stations, upper then lower surface
    k = n_points // 2
    beta = np.linspace(0.0, np.pi, k)
    xc = 0.5 * (1 - np.cos(beta))  # 0 -> 1
    yt = 5 * thickness * (0.2969 * np.sqrt(xc) - 0.1260 * xc
                          - 0.3516 * xc**2 + 0.2843 * xc**3
                          - 0.1036 * xc**4)
    yc = np.where(
        xc < camber_pos,
        camber / camber_pos**2 * (2 * camber_pos * xc - xc**2),
        camber / (1 - camber_pos)**2
        * ((1 - 2 * camber_pos) + 2 * camber_pos * xc - xc**2),
    )
    upper = np.stack([xc, yc + yt], axis=1)
    lower = np.stack([xc, yc - yt], axis=1)
    # closed loop: TE -> LE along upper (reversed), LE -> TE along lower
    contour = np.concatenate([upper[::-1], lower[1:-1]], axis=0)
    return contour.astype(np.float64)


def surface_fields(pos: np.ndarray, normals: np.ndarray, mach: float,
                   alpha_deg: float) -> np.ndarray:
    """Analytic [P, tau_x, tau_y, T] per node (airfoil_2d target layout)."""
    alpha = np.deg2rad(alpha_deg)
    p_inf, t_inf = 101325.0, 288.0
    q = 0.5 * 1.4 * p_inf * mach**2
    xc = pos[:, 0]
    flow = np.array([np.cos(alpha), np.sin(alpha)])
    # crude cp: stagnation near LE, suction peak scaled by alpha and camber
    cp = (1 - 4.0 * (np.maximum(1e-3, xc)) * (1 - xc)
          * (1 + 2.0 * alpha * np.sign(pos[:, 1]))) * (1 + 0.3 * mach**2)
    pressure = p_inf + q * cp
    # wall shear along local tangent, decaying with sqrt(x) boundary layer
    tangent = np.stack([-normals[:, 1], normals[:, 0]], axis=1)
    sgn = np.sign(tangent @ flow)[:, None]
    cf = 0.06 / np.sqrt(np.maximum(xc, 5e-3)) * (1 + 0.1 * mach)
    tau = cf[:, None] * q * tangent * sgn * 1e-3
    temperature = t_inf * (1 + 0.2 * mach**2 * (1 - 0.5 * np.abs(cp)))
    return np.concatenate(
        [pressure[:, None], tau, temperature[:, None]], axis=1)


def contour_graph(pos2d: np.ndarray):
    """Ring connectivity (undirected -> both directions) + outward normals."""
    n = pos2d.shape[0]
    idx = np.arange(n)
    nxt = (idx + 1) % n
    senders = np.concatenate([idx, nxt]).astype(np.int64)
    receivers = np.concatenate([nxt, idx]).astype(np.int64)
    # outward normal = rotate tangent (central difference) by -90deg
    tang = pos2d[nxt] - pos2d[(idx - 1) % n]
    tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-12)
    normals = np.stack([tang[:, 1], -tang[:, 0]], axis=1)
    return senders, receivers, normals


def make_airfoil_sample(*, n_points: int = 256, mach: float = 0.5,
                        alpha: float = 2.0, airfoil: str = "naca2412",
                        thickness: float = 0.12, camber: float = 0.02,
                        noise: float = 0.0,
                        rng: Optional[np.random.Generator] = None,
                        dtype=np.float32) -> MeshSample:
    pos = naca_profile(n_points, thickness=thickness, camber=camber)
    senders, receivers, normals = contour_graph(pos)
    y = surface_fields(pos, normals, mach, alpha)
    if noise > 0.0 and rng is not None:
        y = y * (1 + noise * rng.standard_normal(y.shape))
    return MeshSample(
        pos=pos.astype(dtype), normals=normals.astype(dtype),
        senders=senders, receivers=receivers, y=y.astype(dtype),
        meta={"mach": mach, "alpha": alpha, "airfoil": airfoil},
    )


def make_airfoil_dataset(*, n_cases: int = 24, n_points: int = 256,
                         seed: int = 0, dtype=np.float32) -> List[MeshSample]:
    """A family of airfoils x flow conditions, grouped by airfoil name so the
    by-name split strategy is exercised."""
    rng = np.random.default_rng(seed)
    samples = []
    n_airfoils = max(3, n_cases // 4)
    for i in range(n_cases):
        a = i % n_airfoils
        thickness = 0.08 + 0.08 * (a / max(n_airfoils - 1, 1))
        camber = 0.00 + 0.04 * ((a * 7 % n_airfoils) / max(n_airfoils - 1, 1))
        mach = float(rng.uniform(0.3, 0.9))
        alpha = float(rng.uniform(-8.0, 8.0))
        samples.append(make_airfoil_sample(
            n_points=n_points, mach=mach, alpha=alpha,
            airfoil=f"naca{a:02d}", thickness=thickness, camber=camber,
            noise=0.01, rng=rng, dtype=dtype))
    return samples


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
