"""Spatial node ordering (counterpart of aero_gnn_tpu.graph.order)."""

import numpy as np


def morton_order(pos: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting points by Morton (Z-order) code over the first
    two coordinates, so spatially close nodes get close indices."""
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
