"""Error metrics matching the reference definitions (counterpart of
aero_gnn_tpu.inference.metrics).

RRMSE%: per-feature RMSE divided by per-feature mean |target| (zero where
mean |target| <= 1e-8), averaged over features, x100. ``compute_errors``:
mae / mse / rmse and their relative variants over the entries with
|target| > 1e-8.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def compute_errors(pred: np.ndarray, target: np.ndarray) -> Dict[str, float]:
    """mae, mse, rmse, and relative_mae / relative_rmse of (pred - target) /
    target over the entries with |target| > 1e-8 (nan when there are
    none)."""
    mae = float(np.mean(np.abs(pred - target)))
    mse = float(np.mean((pred - target) ** 2))
    rmse = float(np.sqrt(mse))
    nz = np.abs(target) > 1e-8
    if nz.any():
        rel = (pred[nz] - target[nz]) / target[nz]
        relative_mae = float(np.mean(np.abs(rel)))
        relative_rmse = float(np.sqrt(np.mean(rel ** 2)))
    else:
        relative_mae = relative_rmse = float("nan")
    return {"mae": mae, "mse": mse, "rmse": rmse,
            "relative_mae": relative_mae, "relative_rmse": relative_rmse}


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
