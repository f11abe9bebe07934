"""Experiment/config system (the port's own copy of
aero_gnn_tpu.config.config).

A YAML with base sections ``dataset:``, ``model:``, ``training:`` and named
``experiments:``. An experiment names one entry of each base section; any
other experiment key overrides the matching key in whichever base section
defines it (dataset first, then model, then training); leftovers land in
``extras``. An optional ``mesh:`` section carries the device-mesh settings
of the JAX package's parallel paths.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import yaml


def get_experiment_config(exp_params: Dict[str, Any],
                          configs: Dict[str, Any]) -> Dict[str, Any]:
    """Merge an experiment's overrides into its base sections."""
    params = copy.deepcopy(exp_params)

    dataset_name = params.pop("dataset")
    model_name = params.pop("model")
    training_name = params.pop("training")

    dataset_conf = copy.deepcopy(configs["dataset"][dataset_name])
    model_conf = copy.deepcopy(configs["model"][model_name])
    training_conf = copy.deepcopy(configs["training"][training_name])

    def take_overrides(base_conf: Dict[str, Any]) -> Dict[str, Any]:
        overrides = {}
        for key in list(params.keys()):
            if key in base_conf:
                overrides[key] = params.pop(key)
        return overrides

    dataset_conf.update(take_overrides(dataset_conf))
    dataset_conf["name"] = dataset_name
    model_conf.update(take_overrides(model_conf))
    model_conf["name"] = model_name
    training_conf.update(take_overrides(training_conf))
    training_conf["name"] = training_name

    result = {
        "dataset": dataset_conf,
        "model": model_conf,
        "training": training_conf,
    }
    if "mesh" in configs:
        result["mesh"] = copy.deepcopy(configs["mesh"])
        for key in list(params.keys()):
            if key in result["mesh"]:
                result["mesh"][key] = params.pop(key)
    if params:
        result["extras"] = params
    return result


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def resolve_experiment(path: str, experiment: str) -> Dict[str, Any]:
    configs = load_config(path)
    experiments = configs.get("experiments", {})
    if experiment not in experiments:
        available = ", ".join(sorted(experiments.keys())) or "<none>"
        raise ValueError(
            f"Experiment '{experiment}' not found in configuration. "
            f"Available: {available}")
    params = get_experiment_config(experiments[experiment], configs)
    params["experiment_name"] = experiment
    return params
