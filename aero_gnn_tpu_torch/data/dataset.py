"""Host-side mesh samples and features (subset of aero_gnn_tpu.data.dataset).

  * node features  x = [pos, normals, broadcast per-case globals]
  * edge features  edge_attr = [target_pos - source_pos, ||.||]
  * the inverse of the z-score normalisation of the targets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class MeshSample:
    """One mesh case on host (numpy). Edges are directed pairs."""

    pos: np.ndarray  # [N, dim]
    normals: np.ndarray  # [N, dim]
    senders: np.ndarray  # [E]
    receivers: np.ndarray  # [E]
    y: np.ndarray  # [N, Dy]
    meta: Dict  # mach/alpha/airfoil/...

    x: Optional[np.ndarray] = None  # filled by compute_features
    edge_attr: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return self.pos.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]


def compute_edge_attr(sample: MeshSample) -> np.ndarray:
    vec = sample.pos[sample.receivers] - sample.pos[sample.senders]
    length = np.linalg.norm(vec, axis=1, keepdims=True)
    return np.concatenate([vec, length], axis=1)


def compute_node_features(sample: MeshSample,
                          var_keys: Sequence[str]) -> np.ndarray:
    feats = [sample.pos, sample.normals]
    for key in var_keys:
        if key in sample.meta:
            val = np.atleast_1d(np.asarray(sample.meta[key], dtype=np.float64))
            feats.append(np.broadcast_to(
                val[None, :], (sample.num_nodes, val.shape[0])))
    return np.concatenate(feats, axis=1).astype(sample.pos.dtype)


def compute_features(samples: List[MeshSample],
                     var_keys: Sequence[str]) -> None:
    for s in samples:
        s.x = compute_node_features(s, var_keys)
        s.edge_attr = compute_edge_attr(s)


def denormalize_predictions(pred: np.ndarray,
                            stats: Dict[str, np.ndarray]) -> np.ndarray:
    return pred * stats["target_std"] + stats["target_mean"]
