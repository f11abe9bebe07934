"""Host-side mesh samples, features, normalisation and splits (the port's
own copy of aero_gnn_tpu.data.dataset; numpy only).

  * node features  x = [pos, normals, broadcast per-case globals]
  * edge features  edge_attr = [target_pos - source_pos, ||.||]
  * z-score normalisation with statistics from the TRAIN split only, std
    clamped to >= 1e-8 and unbiased (ddof=1), applied to x / edge_attr / y
  * split strategies: by group name (airfoil), generic random, pre-split,
    shuffled by python's ``random`` seeded as in the JAX package, so one
    seed gives the same splits in both packages.
"""

from __future__ import annotations

import dataclasses
import random as pyrandom
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

STD_EPS = 1e-8  # the std clamp


def compute_normalization_stats(samples: List[MeshSample]) -> Dict[str, np.ndarray]:
    x = np.concatenate([s.x for s in samples], axis=0)
    e = np.concatenate([s.edge_attr for s in samples], axis=0)
    y = np.concatenate([s.y for s in samples], axis=0)

    def std_mean(a):
        # unbiased std, torch.std_mean parity
        return a.std(axis=0, ddof=1), a.mean(axis=0)

    x_std, x_mean = std_mean(x)
    e_std, e_mean = std_mean(e)
    y_std, y_mean = std_mean(y)
    return {
        "node_mean": x_mean.astype(np.float32),
        "node_std": np.maximum(x_std, STD_EPS).astype(np.float32),
        "edge_mean": e_mean.astype(np.float32),
        "edge_std": np.maximum(e_std, STD_EPS).astype(np.float32),
        "target_mean": y_mean.astype(np.float32),
        "target_std": np.maximum(y_std, STD_EPS).astype(np.float32),
    }


def normalize_samples(samples: List[MeshSample],
                      stats: Dict[str, np.ndarray]) -> None:
    for s in samples:
        s.x = (s.x - stats["node_mean"]) / stats["node_std"]
        s.edge_attr = (s.edge_attr - stats["edge_mean"]) / stats["edge_std"]
        s.y = (s.y - stats["target_mean"]) / stats["target_std"]


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------

def split_by_group(samples: List[MeshSample], group_key: str,
                   train_ratio: float, val_ratio: float, test_ratio: float,
                   random_seed: int = 42) -> Tuple[list, list, list]:
    """Split whole groups (e.g. airfoil names) between splits so no geometry
    leaks across them."""
    if abs(train_ratio + val_ratio + test_ratio - 1.0) > 1e-6:
        raise ValueError("Split ratios must sum to 1.0")
    groups = defaultdict(list)
    for s in samples:
        groups[s.meta.get(group_key, "<none>")].append(s)
    names = list(groups.keys())
    pyrandom.seed(random_seed)
    pyrandom.shuffle(names)
    n_train = int(len(names) * train_ratio)
    n_val = int(len(names) * val_ratio)
    picks = (names[:n_train], names[n_train:n_train + n_val],
             names[n_train + n_val:])
    out = []
    for chunk in picks:
        flat: List[MeshSample] = []
        for name in chunk:
            flat.extend(groups[name])
        out.append(flat)
    return tuple(out)


def split_generic(samples: List[MeshSample], train_ratio: float,
                  val_ratio: float, test_ratio: float,
                  random_seed: int = 42) -> Tuple[list, list, list]:
    if abs(train_ratio + val_ratio + test_ratio - 1.0) > 1e-6:
        raise ValueError("Split ratios must sum to 1.0")
    data = list(samples)
    pyrandom.seed(random_seed)
    pyrandom.shuffle(data)
    n_train = int(len(data) * train_ratio)
    n_val = int(len(data) * val_ratio)
    return (data[:n_train], data[n_train:n_train + n_val],
            data[n_train + n_val:])


def split_presplit(samples: List[MeshSample]) -> Tuple[list, list, list]:
    train, val, test = [], [], []
    for s in samples:
        split = s.meta.get("split", "train")
        if split == "train":
            train.append(s)
        elif split == "validation":
            val.append(s)
        elif split == "test":
            test.append(s)
        else:
            train.append(s)
    return train, val, test


# ---------------------------------------------------------------------------
# top level: create_datasets equivalent
# ---------------------------------------------------------------------------

def create_datasets(
    samples: List[MeshSample],
    *,
    dataset_type: str,
    params: Dict,
) -> Tuple[list, list, list, Dict[str, np.ndarray]]:
    """Feature-build, split, and normalize (stats from train only) over
    already-loaded samples (loading lives in data.mesh_io / data.synthetic).
    """
    var_keys = params.get("dataset", {}).get("var_keys", []) or []
    compute_features(samples, var_keys)

    training = params.get("training", {})
    val_ratio = training.get("validation_split", 0.1)
    test_ratio = training.get("test_split", 0.1)
    train_ratio = 1.0 - val_ratio - test_ratio
    seed = training.get("random_seed", 42)

    if dataset_type == "airfoil_2d":
        train, val, test = split_by_group(
            samples, "airfoil", train_ratio, val_ratio, test_ratio, seed)
    elif dataset_type == "ahmed_body":
        train, val, test = split_presplit(samples)
    else:
        train, val, test = split_generic(
            samples, train_ratio, val_ratio, test_ratio, seed)

    stats = compute_normalization_stats(train)
    normalize_samples(train, stats)
    normalize_samples(val, stats)
    normalize_samples(test, stats)
    return train, val, test, stats
