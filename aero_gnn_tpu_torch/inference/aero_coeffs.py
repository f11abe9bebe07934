"""Integrated aerodynamic coefficients.

The port's own copy of aero_gnn_tpu.inference.aero_coeffs (float64 numpy).

2D: per-node "panel areas" from half
edge-lengths x 1e-2, pressure force p*n*dA, shear force -tau*dA, moment
r x F about the origin -> CA (axial), CN (normal), Cm (pitching moment),
normalized by reference area / length / dynamic pressure.

3D: cell-data based on a surface with
per-cell areas + normals -> CA/CN/CY for true and predicted fields.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def node_panel_areas_2d(pos: np.ndarray, senders: np.ndarray,
                        receivers: np.ndarray) -> np.ndarray:
    """Half of each incident edge length, scaled by 1e-2
    (utils.py:516-521; note only the edge's SOURCE node accumulates)."""
    areas = np.zeros(pos.shape[0])
    lengths = np.linalg.norm(pos[receivers] - pos[senders], axis=1)
    np.add.at(areas, senders, lengths / 2.0 * 1e-2)
    return areas


def calculate_aero_coefficients_2d(
    *,
    pos: np.ndarray,
    normals: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    pressure: np.ndarray,
    shear_stress: np.ndarray,
    reference_area: float = 1.0,
    reference_length: float = 1.0,
    moment_center: Optional[np.ndarray] = None,
    dynamic_pressure: float = 1.0,
) -> Dict[str, float]:
    pressure = np.asarray(pressure).reshape(-1)
    shear_stress = np.asarray(shear_stress)
    if moment_center is None:
        moment_center = np.zeros(pos.shape[1])

    areas = node_panel_areas_2d(pos, senders, receivers)
    pressure_force = pressure[:, None] * normals * areas[:, None]
    shear_force = -shear_stress * areas[:, None]
    total_force = pressure_force + shear_force

    total = total_force.sum(axis=0)
    r = pos - moment_center
    moment = float(np.sum(r[:, 0] * total_force[:, 1]
                          - r[:, 1] * total_force[:, 0]))

    flow_dir = np.array([1.0, 0.0])
    normal_dir = np.array([0.0, 1.0])
    CA = float(total @ flow_dir) / reference_area / dynamic_pressure
    CN = float(total @ normal_dir) / reference_area / dynamic_pressure
    Cm = moment / (reference_area * reference_length) / dynamic_pressure
    return {"CA": CA, "CN": CN, "Cm": Cm}


def calculate_aero_coefficients_3d(
    *,
    cell_areas: np.ndarray,
    cell_normals: np.ndarray,
    pressure_true: np.ndarray,
    shear_true: np.ndarray,
    pressure_pred: np.ndarray,
    shear_pred: np.ndarray,
    reference_area: float = 1.0,
    dynamic_pressure: float = 1.0,
) -> Dict[str, float]:
    def forces(p, tau):
        f = (p[:, None] * cell_normals * cell_areas[:, None]
             - tau * cell_areas[:, None])
        return f.sum(axis=0)

    axes = {"CA": np.array([1.0, 0, 0]), "CN": np.array([0, 1.0, 0]),
            "CY": np.array([0, 0, 1.0])}
    out = {}
    f_true = forces(np.asarray(pressure_true).reshape(-1), shear_true)
    f_pred = forces(np.asarray(pressure_pred).reshape(-1), shear_pred)
    for name, ax in axes.items():
        out[f"{name}_true"] = float(f_true @ ax) / reference_area / dynamic_pressure
        out[f"{name}_pred"] = float(f_pred @ ax) / reference_area / dynamic_pressure
    return out


def airfoil_dynamic_pressure(mach: float) -> float:
    """q = 0.5 * gamma * p_inf * M^2 (inference.py:278)."""
    return 0.5 * 1.4 * 101325.0 * mach * mach


def ahmed_dynamic_pressure(velocity: float) -> float:
    """q = 0.5 * rho * V^2 (inference.py:326)."""
    return 0.5 * 1.225 * velocity * velocity
