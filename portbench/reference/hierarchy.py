"""The benchmark's frozen copy of the bistride hierarchy (Cao et al.,
arXiv:2210.02573) as the port's ``graph.hierarchy.build_hierarchy_real``
builds it for one graph: per level a BFS 2-colouring from the min-degree,
lowest-index seed of each component, the even-frontier nodes kept, each
dropped node attached to its lowest-index kept neighbour; coarse edges are
the de-duplicated (c_s, c_r) pairs with self-loops kept; coarse positions
are member means; node mass is half the incident edge length, edge weight
the edge length; the WeightedEdgeConv weights are receiver-normalised.

Real (unpadded) numpy arrays only; edge order is this module's own, since
no result here depends on it.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _csr(senders: np.ndarray, receivers: np.ndarray, n: int):
    order = np.argsort(senders, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, senders + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, receivers[order]


def _neighbours(front: np.ndarray, indptr: np.ndarray, nbr: np.ndarray):
    deg = indptr[front + 1] - indptr[front]
    total = int(deg.sum())
    if total == 0:
        return np.empty(0, np.int64), deg
    base = np.repeat(indptr[front] - (np.cumsum(deg) - deg), deg)
    return nbr[base + np.arange(total)], deg


def bistride_assign(senders: np.ndarray, receivers: np.ndarray, n: int):
    """(fine_to_coarse, kept mask) of one connected-or-not graph."""
    indptr, nbr = _csr(senders, receivers, n)
    deg = np.diff(indptr)
    color = np.full(n, -1, dtype=np.int64)  # 0 kept, 1 dropped
    remaining = np.arange(n)
    while len(remaining):
        dmin = deg[remaining].min()
        seed = int(remaining[deg[remaining] == dmin].min())
        color[seed] = 0
        frontier = np.array([seed], dtype=np.int64)
        parity = 0
        while len(frontier):
            cand, _ = _neighbours(frontier, indptr, nbr)
            cand = cand[color[cand] == -1]
            if not len(cand):
                break
            frontier = np.unique(cand)
            parity ^= 1
            color[frontier] = parity
        remaining = remaining[color[remaining] == -1]
    kept = np.nonzero(color == 0)[0]
    coarse_id = np.full(n, -1, dtype=np.int64)
    coarse_id[kept] = np.arange(len(kept))
    f2c = coarse_id.copy()
    dropped = np.nonzero(color != 0)[0]
    if len(dropped):
        cand, cnt = _neighbours(dropped, indptr, nbr)
        val = np.where(color[cand] == 0, cand, n)
        best = np.full(len(dropped), n, dtype=np.int64)
        nz = cnt > 0
        if len(val):
            best[nz] = np.minimum.reduceat(val, (np.cumsum(cnt) - cnt)[nz])
        has = best < n
        f2c[dropped[has]] = coarse_id[best[has]]
        f2c[dropped[~has]] = 0  # isolated: the graph's first coarse node
    return f2c, color == 0


def geometric_weights(senders, receivers, pos, n):
    el = np.maximum(np.linalg.norm(
        pos[senders].astype(np.float64) - pos[receivers], axis=1), 1e-12)
    nw = np.zeros(n, dtype=np.float64)
    np.add.at(nw, receivers, el / 2.0)
    return np.maximum(nw, 1e-12), el


def conv_weights(senders, receivers, nw):
    denom = nw.copy()
    np.add.at(denom, receivers, nw[senders])
    denom = np.maximum(denom, 1e-12)
    return nw / denom, nw[senders] / denom[receivers]


def build(senders: np.ndarray, receivers: np.ndarray, pos: np.ndarray,
          num_scales: int) -> List[dict]:
    """One dict a level: the fine stream's transfer data (f2c, e2c, rep,
    conv_self, conv_edge, edge_w) and the coarse graph (senders,
    receivers, num_nodes)."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    p = np.asarray(pos, np.float64)
    n = p.shape[0]
    levels = []
    for _ in range(num_scales - 1):
        f2c, kept = bistride_assign(s, r, n)
        nc = int(kept.sum())
        keys = f2c[s] * max(nc, 1) + f2c[r]
        ukeys, e2c = np.unique(keys, return_inverse=True)
        cs, cr = ukeys // max(nc, 1), ukeys % max(nc, 1)
        cpos = np.zeros((nc, p.shape[1]))
        cnt = np.zeros(nc)
        np.add.at(cpos, f2c, p)
        np.add.at(cnt, f2c, 1.0)
        cpos /= np.maximum(cnt, 1.0)[:, None]
        nw, ew = geometric_weights(s, r, p, n)
        cself, cedge = conv_weights(s, r, nw)
        levels.append({"f2c": f2c, "e2c": e2c.reshape(-1),
                       "rep": kept.astype(np.float64), "conv_self": cself,
                       "conv_edge": cedge, "edge_w": ew,
                       "senders": cs, "receivers": cr, "num_nodes": nc,
                       "num_fine_nodes": n, "num_fine_edges": len(s)})
        s, r, p, n = cs, cr, cpos, nc
    return levels
