"""Inference engine: prediction and denormalisation (subset of
aero_gnn_tpu.inference.engine).

``AeroInference`` serves one model on one device (CUDA unless the caller
passes ``device="cpu"``). The parameters are copied to that device once, at
construction, in the model's ``params_dtype`` (the compute dtype; float32
for BSMS, which computes in float32 as the JAX package's does); requests
run under ``torch.inference_mode()``. Models that need a graph hierarchy
(``needs_hierarchy``, BSMS) take it from the Loader's ``aux["hierarchy"]``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch

from aero_gnn_tpu_torch.data.dataset import denormalize_predictions
from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.models.mgn import apply_model


class AeroInference:
    def __init__(self, model_cfg, params, norm_stats: Dict[str, np.ndarray],
                 exp_params: Optional[Dict[str, Any]] = None, *,
                 device: DeviceLike = None, needs_hierarchy: bool = False):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.params = copy.deepcopy(params).to(
            device=self.device, dtype=model_cfg.params_dtype)
        self.params.requires_grad_(False)
        self.norm_stats = norm_stats
        self.exp_params = exp_params or {}
        self.needs_hierarchy = needs_hierarchy

    def predict(self, graph, hierarchy=None):
        """Normalised predictions over the padded graph, on the device."""
        with torch.inference_mode():
            return apply_model(self.model_cfg, self.params, graph, hierarchy,
                               self.needs_hierarchy, self.device)

    def predict_single(self, graph, aux=None, n_nodes: Optional[int] = None):
        """(pred_phys, target_phys, pred_norm, target_norm) as numpy arrays
        over the REAL nodes."""
        n_nodes = graph.n_node if n_nodes is None else n_nodes
        pred_norm = self.predict(graph, (aux or {}).get("hierarchy"))[
            :n_nodes].cpu().numpy()
        target_norm = graph.y[:n_nodes].cpu().numpy()
        return (denormalize_predictions(pred_norm, self.norm_stats),
                denormalize_predictions(target_norm, self.norm_stats),
                pred_norm, target_norm)

    def predict_batch(self, graph, aux):
        """One device pass over a multi-sample batch; per-sample
        (pred_phys, target_phys, pred_norm, target_norm) tuples, the samples
        (``aux["samples"]``) being contiguous row ranges in order."""
        pred = self.predict(graph, aux.get("hierarchy")).cpu().numpy()
        target = graph.y.cpu().numpy()
        outs = []
        off = 0
        for s in aux["samples"]:
            pn = pred[off:off + s.num_nodes]
            tn = target[off:off + s.num_nodes]
            outs.append((denormalize_predictions(pn, self.norm_stats),
                         denormalize_predictions(tn, self.norm_stats),
                         pn, tn))
            off += s.num_nodes
        return outs
