"""Inference engine: prediction and denormalisation (subset of
aero_gnn_tpu.inference.engine).

``AeroInference`` serves one model on one device (CUDA unless the caller
passes ``device="cpu"``). The parameters are moved to that device and cast
to the model's compute dtype once, at construction.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from aero_gnn_tpu_torch.data.dataset import denormalize_predictions
from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.models.mgn import cast_params


class AeroInference:
    def __init__(self, model_cfg, params, norm_stats: Dict[str, np.ndarray],
                 exp_params: Optional[Dict[str, Any]] = None, *,
                 device: DeviceLike = None, needs_hierarchy: bool = False):
        if needs_hierarchy:
            raise NotImplementedError(
                "models that need a graph hierarchy (BSMS) are not ported yet")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.params = cast_params(params.to(self.device),
                                  model_cfg.compute_dtype)
        self.norm_stats = norm_stats
        self.exp_params = exp_params or {}

    def predict(self, graph):
        """Normalised predictions over the padded graph, on the device."""
        if graph.device != self.device:
            graph = graph.to(self.device)
        return self.model_cfg.apply(self.params, graph)

    def predict_single(self, graph, aux=None, n_nodes: Optional[int] = None):
        """(pred_phys, target_phys, pred_norm, target_norm) as numpy arrays
        over the REAL nodes."""
        n_nodes = graph.n_node if n_nodes is None else n_nodes
        pred_norm = self.predict(graph)[:n_nodes].cpu().numpy()
        target_norm = graph.y[:n_nodes].cpu().numpy()
        return (denormalize_predictions(pred_norm, self.norm_stats),
                denormalize_predictions(target_norm, self.norm_stats),
                pred_norm, target_norm)

    def predict_batch(self, graph, aux):
        """One device pass over a multi-sample batch; per-sample
        (pred_phys, target_phys, pred_norm, target_norm) tuples, the samples
        (``aux["samples"]``) being contiguous row ranges in order."""
        pred = self.predict(graph).cpu().numpy()
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
