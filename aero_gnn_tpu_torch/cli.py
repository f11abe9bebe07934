"""The port's command line (counterpart of aero_gnn_tpu.cli):

    python -m aero_gnn_tpu_torch.cli train --exp <name> [--config path.yaml]
                                           [--output_dir DIR] [--device cpu]
    python -m aero_gnn_tpu_torch.cli infer [--training_dir DIR] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; without a card and
without it, the CLI raises ``RuntimeError``. A run directory holds the same
files as the JAX package's (``model_weights.pkl`` in its tree layout), so
either package's ``infer`` serves a directory trained by the other.

Precision ("single" | "bf16" | "fp16"): process-wide matmul precision of
the plain fp32 matmuls (``torch.set_float32_matmul_precision``); "fp16"
maps to bf16. The model's compute dtype comes from its ``compute_dtype``
key, as in the JAX package. "double" is refused: the port has no float64
path.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

import torch

DEFAULT_CONFIG = os.path.join(os.path.dirname(__file__), "config",
                              "default.yaml")


def load_samples(exp_params: Dict[str, Any]):
    """Dataset dispatch: synthetic generator or VTU/VTP ingestion."""
    ds = exp_params["dataset"]
    name = ds.get("name")
    if ds.get("synthetic") or name == "synthetic_airfoil":
        from aero_gnn_tpu_torch.data.synthetic import make_airfoil_dataset
        return make_airfoil_dataset(
            n_cases=int(ds.get("n_cases", 24)),
            n_points=int(ds.get("n_points", 256)),
            seed=int(exp_params.get("training", {}).get("random_seed", 42)))
    from aero_gnn_tpu_torch.data import mesh_io
    return mesh_io.load_dataset(ds, exp_params)


def setup_precision(exp_params: Dict[str, Any]) -> None:
    precision = str(exp_params.get("training", {})
                    .get("precision", "single")).lower()
    if precision in ("double", "float64"):
        raise ValueError("Unsupported precision 'double': the port computes "
                         "in float32 or bfloat16 and has no float64 path")
    if precision in ("float", "float32", "single"):
        torch.set_float32_matmul_precision("highest")
        print("Using single precision (float32)")
    elif precision in ("bf16", "bfloat16"):
        torch.set_float32_matmul_precision("medium")
        print("Using bfloat16 matmul precision")
    elif precision in ("fp16", "float16", "half"):
        # fp16's 5-bit exponent needs loss scaling; bf16 has the same
        # memory/throughput class and fp32's range, so fp16 maps onto it
        torch.set_float32_matmul_precision("medium")
        print("Requested fp16: the port has no fp16 compute path — using "
              "bfloat16 matmul precision (same speed/memory class, "
              "fp32-range, no loss scaling needed)")
    else:
        raise ValueError(f"Unknown precision type: {precision}. Supported: "
                         "'float32', 'bfloat16', 'float16' (mapped to "
                         "bfloat16), 'single'")


def infer_dims(samples) -> Dict[str, int]:
    return {
        "input_node_dim": samples[0].x.shape[1],
        "input_edge_dim": samples[0].edge_attr.shape[1],
        "output_node_dim": samples[0].y.shape[1],
    }


def _bsms_opts(model_conf: Dict[str, Any]) -> Dict[str, Any]:
    return dict(num_scales=int(model_conf.get("num_scales", 3)),
                hierarchy_mode=model_conf.get("hierarchy_mode", "stride"),
                stride=int(model_conf.get("stride", 2)))


def train_main(args: argparse.Namespace) -> str:
    from aero_gnn_tpu_torch.config.config import resolve_experiment
    from aero_gnn_tpu_torch.data.batching import Loader
    from aero_gnn_tpu_torch.data.dataset import create_datasets
    from aero_gnn_tpu_torch.device import resolve_device
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.models.registry import (
        NEEDS_HIERARCHY,
        build_model,
        canonical_name,
    )
    from aero_gnn_tpu_torch.training import artifacts
    from aero_gnn_tpu_torch.training.loop import fit

    dev = resolve_device(args.device)
    exp_params = resolve_experiment(args.config, args.experiment)
    setup_precision(exp_params)

    samples = load_samples(exp_params)
    train_set, val_set, test_set, norm_stats = create_datasets(
        samples, dataset_type=exp_params["dataset"]["name"],
        params=exp_params)
    print(f"Split: {len(train_set)} train / {len(val_set)} val / "
          f"{len(test_set)} test")

    dims = infer_dims(train_set)
    model_conf = exp_params["model"]
    model_cfg = build_model(model_conf, dims)
    kind = canonical_name(model_conf["name"])
    needs_h = kind in NEEDS_HIERARCHY

    training_conf = exp_params["training"]
    bs = int(training_conf.get("batch_size", 1))
    seed = int(training_conf.get("random_seed", 42))
    loader_kw = _bsms_opts(model_conf) if needs_h else {}
    train_loader = Loader(train_set, bs, shuffle=True, seed=seed, device=dev,
                          **loader_kw)
    val_loader = Loader(val_set, max(1, min(bs, len(val_set))), device=dev,
                        **loader_kw)

    params = model_cfg.init(seed, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"Model: {kind}  total parameters: {n_params:,}  device: {dev}")

    save_dir = args.output_dir or artifacts.make_run_dir(
        model_conf["name"], exp_params["dataset"]["name"])
    os.makedirs(save_dir, exist_ok=True)
    ckpt_dir = os.path.join(save_dir, "checkpoints")

    result = fit(model_cfg=model_cfg, params=params,
                 train_loader=train_loader, val_loader=val_loader,
                 training_config=training_conf, needs_hierarchy=needs_h,
                 seed=seed, checkpoint_dir=ckpt_dir, device=dev)

    artifacts.save_run_artifacts(
        save_dir, params=result.params, model_cfg=model_cfg,
        norm_stats=norm_stats, exp_params=exp_params,
        train_losses=result.train_losses, val_losses=result.val_losses,
        summary_extra={"Total Parameters": f"{n_params:,}",
                       "Wall time (s)": f"{result.wall_time_s:.1f}"})
    print(f"All outputs saved to: {save_dir}")

    # inference on the test set; a failure here keeps the training
    # artifacts and is reported, as in the JAX package
    if test_set:
        try:
            engine = AeroInference(
                model_cfg, result.params, norm_stats, exp_params,
                device=dev, needs_hierarchy=needs_h, **(
                    _bsms_opts(model_conf) if needs_h else {}))
            inference_dir = engine.run_inference(test_set, save_dir)
            print(f"Inference results saved to {inference_dir}")
        except Exception as e:  # noqa: BLE001 — keep training artifacts
            print(f"Error during inference: {e}")
            print("Continuing without inference...")
    return save_dir


def infer_main(args: argparse.Namespace) -> str:
    from aero_gnn_tpu_torch.data.dataset import create_datasets
    from aero_gnn_tpu_torch.device import resolve_device
    from aero_gnn_tpu_torch.inference.engine import AeroInference
    from aero_gnn_tpu_torch.models.registry import (
        NEEDS_HIERARCHY,
        build_model,
        canonical_name,
    )
    from aero_gnn_tpu_torch.training import artifacts, checkpoint as C

    dev = resolve_device(args.device)
    training_dir = args.training_dir
    if training_dir is None:
        print("No training directory specified, looking for latest run...")
        training_dir = artifacts.find_latest_training_run()
        print(f"Found latest training run: {training_dir}")
    for fname in (artifacts.WEIGHTS_FILE, artifacts.NORM_STATS_FILE,
                  artifacts.PARAMS_FILE):
        path = os.path.join(training_dir, fname)
        if not os.path.exists(path):
            raise FileNotFoundError(f"Required file not found: {path}")

    with open(os.path.join(training_dir, artifacts.PARAMS_FILE)) as f:
        exp_params = json.load(f)
    norm_stats = C.load_norm_stats(
        os.path.join(training_dir, artifacts.NORM_STATS_FILE))
    setup_precision(exp_params)

    samples = load_samples(exp_params)
    _, _, test_set, _ = create_datasets(
        samples, dataset_type=exp_params["dataset"]["name"],
        params=exp_params)
    print(f"Test set contains {len(test_set)} samples")

    dims = infer_dims(test_set)
    model_conf = exp_params["model"]
    model_cfg = build_model(model_conf, dims)
    params = C.load_params(os.path.join(training_dir, artifacts.WEIGHTS_FILE),
                           model_cfg, device=dev)
    needs_h = canonical_name(model_conf["name"]) in NEEDS_HIERARCHY

    engine = AeroInference(model_cfg, params, norm_stats, exp_params,
                           device=dev, needs_hierarchy=needs_h,
                           **(_bsms_opts(model_conf) if needs_h else {}))
    return engine.run_inference(test_set, training_dir)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="aero_gnn_tpu_torch",
        description="PyTorch / CUDA mesh-GNN framework CLI")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a model from an experiment")
    p_train.add_argument("--exp", "--experiment", dest="experiment",
                         type=str, required=True,
                         help="Experiment name defined in the config YAML")
    p_train.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    p_train.add_argument("--output_dir", type=str, default=None)

    p_infer = sub.add_parser("infer", help="run inference from a training dir")
    p_infer.add_argument("--training_dir", type=str, default=None)
    p_infer.add_argument("--config", type=str, default=DEFAULT_CONFIG)

    for p in (p_train, p_infer):
        p.add_argument("--device", type=str, default=None,
                       help="'cpu' to run on the CPU (default: the CUDA "
                            "card)")

    args = parser.parse_args(argv)
    if args.command == "train":
        train_main(args)
    elif args.command == "infer":
        infer_main(args)


if __name__ == "__main__":
    main()
