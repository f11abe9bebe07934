"""Error metrics matching the reference definitions (counterpart of
aero_gnn_tpu.inference.metrics).

RRMSE%: per-feature RMSE divided by per-feature mean |target| (zero where
mean |target| <= 1e-8), averaged over features, x100.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def compute_rrmse_percent(pred: np.ndarray, target: np.ndarray) -> float:
    feature_rmse = np.sqrt(np.mean((pred - target) ** 2, axis=0))
    feature_mean_abs = np.mean(np.abs(target), axis=0)
    feature_rrmse = np.where(feature_mean_abs > 1e-8,
                             feature_rmse / np.maximum(feature_mean_abs, 1e-30),
                             0.0)
    return float(np.mean(feature_rrmse)) * 100.0


def featurewise_mae_mse(pred: np.ndarray, target: np.ndarray,
                        feature_names) -> Dict[str, Dict[str, float]]:
    out = {}
    for j, name in enumerate(feature_names):
        out[name] = {
            "mae": float(np.mean(np.abs(pred[:, j] - target[:, j]))),
            "mse": float(np.mean((pred[:, j] - target[:, j]) ** 2)),
        }
    return out
