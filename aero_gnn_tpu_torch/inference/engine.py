"""Inference engine: prediction, denormalisation, metrics and reports
(counterpart of aero_gnn_tpu.inference.engine).

``AeroInference`` serves one model on one device (CUDA unless the caller
passes ``device="cpu"``). The parameters are copied to that device once, at
construction, in the model's ``params_dtype`` (the compute dtype; float32
for BSMS, which computes in float32 as the JAX package's does); requests
run under ``torch.inference_mode()``. Models that need a graph hierarchy
(``needs_hierarchy``, BSMS) take it from the Loader's ``aux["hierarchy"]``;
``run_inference`` builds its Loader with ``num_scales`` / ``hierarchy_mode``
/ ``stride`` for them. ``run_inference`` writes the JAX package's report:
the fixed-width errors.txt (TEST_MEAN header + one line per case, so the
two packages' reports diff line by line), aero coefficients, 2D plots and
VTU exports.
"""

from __future__ import annotations

import copy
import datetime
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from aero_gnn_tpu_torch.data.batching import Loader
from aero_gnn_tpu_torch.data.dataset import MeshSample, denormalize_predictions
from aero_gnn_tpu_torch.device import DeviceLike, resolve_device
from aero_gnn_tpu_torch.inference.aero_coeffs import (
    airfoil_dynamic_pressure,
    calculate_aero_coefficients_2d,
)
from aero_gnn_tpu_torch.inference.metrics import (
    compute_rrmse_percent,
    featurewise_mae_mse,
)
from aero_gnn_tpu_torch.models.mgn import apply_model


def plot_2d_predictions(pos, pred, target, feature_names, save_path,
                        case_name=""):
    """Per-feature ground-truth vs prediction scatter over x-coordinate
    (nothing when matplotlib is not installed)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    n_features = len(feature_names)
    x = pos[:, 0]
    fig = plt.figure(figsize=(12, 4 * n_features))
    for i, name in enumerate(feature_names):
        ax = plt.subplot(n_features, 1, i + 1)
        ax.scatter(x, target[:, i], c="b", alpha=0.7, s=20,
                   label="Ground Truth", marker="o")
        ax.scatter(x, pred[:, i], c="g", alpha=0.7, s=20,
                   label="Prediction", marker="^")
        ax.set_xlabel("X Coordinate")
        ax.set_ylabel(name)
        ax.legend()
        ax.grid(True, alpha=0.3)
    plt.suptitle(f"Predictions Comparison - {case_name}")
    plt.tight_layout()
    base = save_path.rsplit(".", 1)[0]
    plt.savefig(f"{base}_predictions.png", dpi=120, bbox_inches="tight")
    plt.close(fig)


class AeroInference:
    def __init__(self, model_cfg, params, norm_stats: Dict[str, np.ndarray],
                 exp_params: Optional[Dict[str, Any]] = None, *,
                 device: DeviceLike = None, needs_hierarchy: bool = False,
                 num_scales: Optional[int] = None,
                 hierarchy_mode: str = "stride", stride: int = 2):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.params = copy.deepcopy(params).to(
            device=self.device, dtype=model_cfg.params_dtype)
        self.params.requires_grad_(False)
        self.norm_stats = norm_stats
        self.exp_params = exp_params or {}
        self.needs_hierarchy = needs_hierarchy
        self.num_scales = num_scales
        self.hierarchy_mode = hierarchy_mode
        self.stride = stride

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

    def run_inference(self, test_samples: List[MeshSample],
                      output_dir: str,
                      *, log_fn=print,
                      timestamp: Optional[str] = None) -> str:
        ds_conf = self.exp_params.get("dataset", {})
        dataset_name = ds_conf.get("name", "dataset")
        target_features = ds_conf.get(
            "output_features",
            [f"feature_{i}" for i in range(test_samples[0].y.shape[1])])

        stamp = timestamp or datetime.datetime.now().strftime("%d-%m_%H-%M")
        inference_dir = os.path.join(output_dir, f"inference_results_{stamp}")
        plots_dir = os.path.join(inference_dir, "plots")
        vtu_dir = os.path.join(inference_dir, "vtu_exports")
        os.makedirs(plots_dir, exist_ok=True)
        os.makedirs(vtu_dir, exist_ok=True)
        make_plots = self.exp_params.get("make_plots", True)

        # batch_size > 1 amortizes device passes over several cases (one
        # padded shape, one executable); per-case reporting is unchanged —
        # predict_batch slices per-sample rows back out.
        batch_size = int(self.exp_params.get("inference_batch_size", 1))
        loader = Loader(test_samples, batch_size=batch_size,
                        num_scales=self.num_scales if self.needs_hierarchy
                        else None,
                        hierarchy_mode=self.hierarchy_mode, stride=self.stride,
                        device=self.device)

        def _cases():
            for graph, aux in loader:
                for sample, p4 in zip(aux["samples"],
                                      self.predict_batch(graph, aux)):
                    yield sample, p4

        all_case: List[dict] = []
        cat_pp, cat_tp, cat_pn, cat_tn = [], [], [], []
        for i, (sample, (pp, tp, pn, tn)) in enumerate(_cases()):
            cat_pp.append(pp), cat_tp.append(tp)
            cat_pn.append(pn), cat_tn.append(tn)
            rrmse = compute_rrmse_percent(pp, tp)

            coeff_str = ""
            if dataset_name in ("airfoil_2d", "synthetic_airfoil"):
                mach = float(sample.meta.get("mach", 0.5))
                q = airfoil_dynamic_pressure(mach)
                kw = dict(pos=sample.pos.astype(np.float64),
                          normals=sample.normals.astype(np.float64),
                          senders=sample.senders, receivers=sample.receivers,
                          reference_area=1e-2, reference_length=1.0,
                          dynamic_pressure=q)
                true_c = calculate_aero_coefficients_2d(
                    pressure=tp[:, 0:1], shear_stress=tp[:, 1:3], **kw)
                pred_c = calculate_aero_coefficients_2d(
                    pressure=pp[:, 0:1], shear_stress=pp[:, 1:3], **kw)
                coeff_str = (
                    f" | CA:{pred_c['CA']:7.4f} ({true_c['CA']:7.4f}) "
                    f"| CN:{pred_c['CN']:7.4f} ({true_c['CN']:7.4f}) "
                    f"| Cm:{pred_c['Cm']:7.4f} ({true_c['Cm']:7.4f})")
                log_fn(f"Error in case{i:03d}: {rrmse:7.4f}%{coeff_str}")
            elif dataset_name == "ahmed_body":
                coeffs = self._ahmed_coefficients(sample, pp, tp)
                if coeffs is not None:
                    coeff_str = (
                        f" | CA:{coeffs['CA_pred']:7.4f} "
                        f"({coeffs['CA_true']:7.4f}) "
                        f"| CN:{coeffs['CN_pred']:7.4f} "
                        f"({coeffs['CN_true']:7.4f}) "
                        f"| CY:{coeffs['CY_pred']:7.4f} "
                        f"({coeffs['CY_true']:7.4f})")
                    log_fn(f"Error in case{i:03d}: {rrmse:7.4f}%{coeff_str}")

            case = {
                "case_id": i,
                "rrmse_percent": rrmse,
                "errors_physical": featurewise_mae_mse(pp, tp, target_features),
                "errors_normalized": featurewise_mae_mse(pn, tn, target_features),
                "coeff_str": coeff_str,
            }
            for key in ("airfoil", "mach", "alpha", "case_no"):
                if key in sample.meta:
                    case[key] = sample.meta[key]
            all_case.append(case)

            # per-case artifacts: 2D scatter plots or 3D VTU export with
            # predicted/true/error arrays
            if make_plots:
                if sample.pos.shape[1] == 2:
                    case_name = f"Case {i:03d}"
                    if "airfoil" in sample.meta:
                        case_name += f" - {sample.meta['airfoil']}"
                    if "mach" in sample.meta and "alpha" in sample.meta:
                        case_name += (f" (M={sample.meta['mach']:.2f}, "
                                      f"a={sample.meta['alpha']:.1f})")
                    plot_2d_predictions(
                        sample.pos, pp, tp, target_features,
                        os.path.join(plots_dir,
                                     f"prediction_case_{i:03d}.png"),
                        case_name)
                else:
                    name = sample.meta.get("case_no", f"case_{i:03d}")
                    out_path = os.path.join(vtu_dir,
                                            f"{name}_predictions.vtu")
                    if not self._export_on_source_mesh(
                            sample, pp, tp, target_features, out_path):
                        from aero_gnn_tpu_torch.data.vtk_writer import (
                            export_predictions_vtu)
                        export_predictions_vtu(
                            out_path, points=sample.pos,
                            senders=sample.senders,
                            receivers=sample.receivers,
                            feature_names=target_features, pred=pp,
                            target=tp)

        pp_all = np.concatenate(cat_pp)
        tp_all = np.concatenate(cat_tp)
        pn_all = np.concatenate(cat_pn)
        tn_all = np.concatenate(cat_tn)
        mean_phys = featurewise_mae_mse(pp_all, tp_all, target_features)
        mean_norm = featurewise_mae_mse(pn_all, tn_all, target_features)

        self._write_errors_txt(
            os.path.join(inference_dir, "errors.txt"),
            all_case, mean_phys, mean_norm, target_features, dataset_name)
        log_fn(f"Inference complete! Results saved to: {inference_dir}")
        return inference_dir

    def _export_on_source_mesh(self, sample: MeshSample, pred, target,
                               feature_names, out_path: str) -> bool:
        """Attach predicted_/true_/error_ point arrays to the ORIGINAL
        surface mesh when the source file is known; False -> caller falls
        back to the line-graph export."""
        data_dir = self.exp_params.get("dataset", {}).get("data_dir")
        split = sample.meta.get("split")
        case_no = sample.meta.get("case_no")
        if None in (data_dir, split, case_no):
            return False
        src = os.path.join(str(data_dir), str(split), f"{case_no}.vtp")
        if not os.path.exists(src):
            return False
        from aero_gnn_tpu_torch.data.vtk_core import read_any
        from aero_gnn_tpu_torch.data.vtk_geometry import extract_surface
        from aero_gnn_tpu_torch.data.vtk_writer import write_vtu

        mesh = extract_surface(read_any(src))
        if mesh.num_points != pred.shape[0]:
            return False
        pdata = {}
        for j, name in enumerate(feature_names):
            pdata[f"predicted_{name}"] = pred[:, j]
            pdata[f"true_{name}"] = target[:, j]
            pdata[f"error_{name}"] = pred[:, j] - target[:, j]
        mesh.point_data = pdata
        write_vtu(out_path, mesh)
        return True

    def _ahmed_coefficients(self, sample: MeshSample, pred_phys, target_phys
                            ) -> Optional[Dict[str, float]]:
        """Re-read the case's surface mesh, integrate on cell data (the
        ahmed_body coefficient pipeline)."""
        data_dir = self.exp_params.get("dataset", {}).get("data_dir")
        split = sample.meta.get("split")
        case_no = sample.meta.get("case_no")
        velocity = sample.meta.get("Velocity")
        height = sample.meta.get("Height")
        width = sample.meta.get("Width")
        if None in (data_dir, split, case_no, velocity, height, width):
            return None
        path = os.path.join(str(data_dir), str(split), f"{case_no}.vtp")
        if not os.path.exists(path):
            return None
        from aero_gnn_tpu_torch.data.vtk_core import read_any
        from aero_gnn_tpu_torch.data.vtk_geometry import (
            compute_cell_normals_areas,
            extract_surface,
            point_data_to_cell_data,
        )
        from aero_gnn_tpu_torch.inference.aero_coeffs import (
            ahmed_dynamic_pressure,
            calculate_aero_coefficients_3d,
        )

        mesh = extract_surface(read_any(path))
        normals, areas = compute_cell_normals_areas(mesh)
        mesh.point_data = {
            "p_true": target_phys[:, 0],
            "tau_true": target_phys[:, 1:4],
            "p_pred": pred_phys[:, 0],
            "tau_pred": pred_phys[:, 1:4],
        }
        cell = point_data_to_cell_data(mesh)
        return calculate_aero_coefficients_3d(
            cell_areas=areas, cell_normals=normals,
            pressure_true=cell["p_true"], shear_true=cell["tau_true"],
            pressure_pred=cell["p_pred"], shear_pred=cell["tau_pred"],
            reference_area=float(height) * float(width) * 1e-6 / 2,
            dynamic_pressure=ahmed_dynamic_pressure(float(velocity)))

    @staticmethod
    def _write_errors_txt(path: str, all_case: List[dict],
                          mean_phys, mean_norm, target_features,
                          dataset_name: str) -> None:
        """Fixed-width errors.txt, the JAX package's format."""
        with open(path, "w") as f:
            t_nmae = np.mean([mean_norm[x]["mae"] for x in target_features])
            t_nmse = np.mean([mean_norm[x]["mse"] for x in target_features])
            t_mae = np.mean([mean_phys[x]["mae"] for x in target_features])
            t_mse = np.mean([mean_phys[x]["mse"] for x in target_features])
            t_rrmse = np.mean([c["rrmse_percent"] for c in all_case])
            f.write(f"TEST_MEAN | rrmse:{t_rrmse:6.2f} | nmae:{t_nmae:8.6f} "
                    f"| nmse:{t_nmse:8.6f} | mae:{t_mae:7.2f} "
                    f"| mse:{t_mse:12.2f}\n\n")
            for c in all_case:
                nmae = np.mean([c["errors_normalized"][x]["mae"]
                                for x in target_features])
                nmse = np.mean([c["errors_normalized"][x]["mse"]
                                for x in target_features])
                mae = np.mean([c["errors_physical"][x]["mae"]
                               for x in target_features])
                mse = np.mean([c["errors_physical"][x]["mse"]
                               for x in target_features])
                base = (f"case_{c['case_id']:03d} "
                        f"| rrmse:{c['rrmse_percent']:6.2f} "
                        f"| nmae:{nmae:8.6f} | nmse:{nmse:8.6f} "
                        f"| mae:{mae:7.2f} | mse:{mse:12.2f}"
                        f"{c.get('coeff_str', '')}")
                if dataset_name in ("airfoil_2d", "synthetic_airfoil"):
                    airfoil = c.get("airfoil", "N/A")
                    mach = c.get("mach", "N/A")
                    alpha = c.get("alpha", "N/A")
                    if isinstance(mach, (int, float)):
                        mach = f"{mach:.2f}"
                    if isinstance(alpha, (int, float)):
                        alpha = f"{alpha:.2f}"
                    base += f" | {airfoil:8s} | {str(mach):4s} | {str(alpha):5s}"
                elif dataset_name == "ahmed_body":
                    base += f" | {str(c.get('case_no', 'N/A')):5s}"
                f.write(base + "\n")
