"""Training artifact saving (the port's own copy of
aero_gnn_tpu.training.artifacts, with the same file names).

A run directory ``training_runs/DD-MM-YYYY/HH-MM-<model>-<dataset>/`` holds
the model weights (``model_weights.pkl``, in the JAX package's tree layout:
``training.checkpoint.save_params``), the normalisation statistics (npz),
the experiment params JSON, the loss-history JSON, a log-scale loss plot and
a human-readable summary, so either package's ``infer`` reads a run
directory written by the other.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from aero_gnn_tpu_torch.training import checkpoint as C

WEIGHTS_FILE = "model_weights.pkl"
NORM_STATS_FILE = "normalization_stats.npz"
PARAMS_FILE = "experiment_params.json"
LOSSES_FILE = "training_losses.json"
PLOT_FILE = "training_loss_plot.png"
SUMMARY_FILE = "training_summary.txt"


def make_run_dir(model_name: str, dataset_name: str,
                 base_dir: str = "training_runs",
                 now: Optional[datetime.datetime] = None) -> str:
    now = now or datetime.datetime.now()
    run = f"{now.strftime('%H-%M')}-{model_name}-{dataset_name}"
    path = os.path.join(base_dir, now.strftime("%d-%m-%Y"), run)
    os.makedirs(path, exist_ok=True)
    return path


def find_latest_training_run(base_dir: str = "training_runs") -> str:
    """Most recent run dir by mtime."""
    if not os.path.exists(base_dir):
        raise FileNotFoundError(
            f"Training runs directory not found: {base_dir}")
    dirs = []
    for day in os.listdir(base_dir):
        day_path = os.path.join(base_dir, day)
        if os.path.isdir(day_path):
            for run in os.listdir(day_path):
                p = os.path.join(day_path, run)
                if os.path.isdir(p):
                    dirs.append(p)
    if not dirs:
        raise FileNotFoundError(f"No training runs found in {base_dir}")
    dirs.sort(key=os.path.getmtime, reverse=True)
    return dirs[0]


def _json_safe(obj: Any) -> Any:
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return str(obj)


def save_run_artifacts(
    save_dir: str,
    *,
    params,
    model_cfg,
    norm_stats: Dict[str, np.ndarray],
    exp_params: Dict[str, Any],
    train_losses: List[float],
    val_losses: List[float],
    summary_extra: Optional[Dict[str, Any]] = None,
) -> None:
    C.save_params(os.path.join(save_dir, WEIGHTS_FILE), params,
                  model_cfg)
    C.save_norm_stats(os.path.join(save_dir, NORM_STATS_FILE), norm_stats)

    with open(os.path.join(save_dir, PARAMS_FILE), "w") as f:
        json.dump({k: _json_safe(v) for k, v in exp_params.items()}, f,
                  indent=2)

    loss_data = {
        "final_train_loss": train_losses[-1] if train_losses else 0.0,
        "final_val_loss": val_losses[-1] if val_losses else 0.0,
        "best_val_loss": min(val_losses) if val_losses else 0.0,
        "total_epochs": len(train_losses),
        "train_losses": train_losses,
        "val_losses": val_losses,
    }
    with open(os.path.join(save_dir, LOSSES_FILE), "w") as f:
        json.dump(loss_data, f, indent=2)

    _save_loss_plot(save_dir, train_losses, val_losses,
                    exp_params.get("model", {}).get("name", "model"))
    _save_summary(save_dir, exp_params, norm_stats, train_losses,
                  val_losses, summary_extra or {})


def _save_loss_plot(save_dir, train_losses, val_losses, model_name) -> None:
    if not train_losses:
        return
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plt.figure(figsize=(12, 8))
    plt.plot(train_losses, label="Training Loss", linewidth=2, color="blue")
    plt.plot(val_losses, label="Validation Loss", linewidth=2, color="red")
    plt.xlabel("Epoch")
    plt.ylabel("Loss (MSE)")
    plt.title(f"Training Progress - {model_name}")
    plt.legend()
    plt.grid(True, alpha=0.3)
    plt.yscale("log")
    plt.tight_layout()
    plt.savefig(os.path.join(save_dir, PLOT_FILE), dpi=150,
                bbox_inches="tight")
    plt.close()


def _save_summary(save_dir, exp_params, norm_stats, train_losses,
                  val_losses, extra) -> None:
    model_conf = exp_params.get("model", {})
    training_conf = exp_params.get("training", {})
    with open(os.path.join(save_dir, SUMMARY_FILE), "w") as f:
        f.write(f"Training Summary - "
                f"{datetime.datetime.now().strftime('%d-%m-%Y %H-%M')}\n")
        f.write("=" * 50 + "\n\n")
        f.write(f"Experiment: {exp_params.get('experiment_name', 'Unknown')}\n")
        f.write(f"Model: {model_conf.get('name')}\n")
        f.write(f"Dataset: {exp_params.get('dataset', {}).get('name')}\n")
        for k, v in extra.items():
            f.write(f"{k}: {v}\n")
        f.write("\nModel Configuration:\n")
        f.write(f"  Hidden Dim: {model_conf.get('hidden_dim')}\n")
        f.write(f"  Processor Size: {model_conf.get('processor_size')}\n")
        f.write("\nNormalization Statistics:\n")
        for k, v in norm_stats.items():
            f.write(f"  {k}: {np.asarray(v).tolist()}\n")
        f.write("\nTraining Configuration:\n")
        f.write(f"  Learning Rate: {training_conf.get('learning_rate')}\n")
        f.write(f"  Weight Decay: {training_conf.get('weight_decay')}\n")
        f.write(f"  Batch Size: {training_conf.get('batch_size')}\n")
        f.write(f"  Early Stopping: {training_conf.get('early_stopping')}\n")
        f.write("\nTraining Results:\n")
        f.write(f"  Total Epochs: {len(train_losses)}\n")
        if train_losses:
            f.write(f"  Final Training Loss: {train_losses[-1]:.6f}\n")
            f.write(f"  Final Validation Loss: {val_losses[-1]:.6f}\n")
            best = min(val_losses)
            f.write(f"  Best Validation Loss: {best:.6f} "
                    f"(Epoch {val_losses.index(best)})\n")
