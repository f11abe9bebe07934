"""Mesh file ingestion (VTU/VTP) — loader dispatch.

The port's own copy of aero_gnn_tpu.data.mesh_io, built on the
self-contained VTK XML parser in ``aero_gnn_tpu_torch.data.vtk_reader`` (no
pyvista dependency).

Dataset layouts supported (matching the reference):
  * airfoil_2d:  <data_dir>/<airfoil>/<prefix>_<mach>_<alpha>/walls_Surf64.vtu
                 fields: tau [N,>=2], P [N], t [N]; z=0 slice of an extruded
                 surface; y = [P, tau_x, tau_y, T]
  * missile_3d:  <data_dir>/**/*.vtu with mach_alpha[_beta] in the filename;
                 fields tau [N,3], P, T; y = [P, tau(3), T]
  * ahmed_body:  <data_dir>/{train,validation,test}/*.vtp +
                 {split}_info/<case>_info.txt metadata;
                 fields wallShearStress [N,3], p; y = [p, tau(3)]
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Any, Dict, List

from aero_gnn_tpu_torch.data.dataset import MeshSample


def _in_range(value: float, rng) -> bool:
    """Reference range semantics (dataset.py:122-137): 1-element = exact
    match (1e-6 tol), 2-element = [min, max] inclusive."""
    if rng is None:
        return True
    if len(rng) == 1:
        return abs(value - rng[0]) <= 1e-6
    if len(rng) == 2:
        return rng[0] <= value <= rng[1]
    return True


def load_dataset(ds_conf: Dict[str, Any],
                 exp_params: Dict[str, Any]) -> List[MeshSample]:
    name = ds_conf.get("name")
    data_dir = ds_conf.get("data_dir")
    if not data_dir or not os.path.isdir(str(data_dir)):
        raise FileNotFoundError(
            f"dataset '{name}' needs an existing data_dir "
            f"(got {data_dir!r}); use a synthetic_* dataset for file-free "
            "runs")
    if name == "airfoil_2d":
        return load_airfoil_2d(data_dir, ds_conf)
    if name == "missile_3d":
        return load_missile_3d(data_dir, ds_conf)
    if name == "ahmed_body":
        return load_ahmed_body(data_dir, exp_params)
    raise ValueError(f"Unknown dataset type: {name}")


def load_airfoil_2d(data_dir: str, ds_conf: Dict[str, Any]
                    ) -> List[MeshSample]:
    from aero_gnn_tpu_torch.data.vtk_reader import read_2d_mesh
    files = glob.glob(os.path.join(data_dir, "*/*/walls_Surf64.vtu"))
    print(f"Found {len(files)} airfoil 2D files")
    mach_range = ds_conf.get("mach")
    alpha_range = ds_conf.get("alpha")
    samples = []
    for file in files:
        mach_s, alpha_s = Path(file).parts[-2].split("_")[-2:]
        mach, alpha = float(mach_s), float(alpha_s)
        if not (_in_range(mach, mach_range) and _in_range(alpha, alpha_range)):
            continue
        airfoil = Path(file).parts[-3]
        sample = read_2d_mesh(file)
        sample.meta.update({"mach": mach, "alpha": alpha, "airfoil": airfoil})
        samples.append(sample)
    print(f"Filtered to {len(samples)} files based on parameters")
    return samples


def load_missile_3d(data_dir: str, ds_conf: Dict[str, Any]
                    ) -> List[MeshSample]:
    from aero_gnn_tpu_torch.data.vtk_reader import read_3d_mesh
    files = glob.glob(os.path.join(data_dir, "**", "*.vtu"), recursive=True)
    print(f"Found {len(files)} missile 3D files")
    mach_range = ds_conf.get("mach")
    alpha_range = ds_conf.get("alpha")
    beta_range = ds_conf.get("beta")
    samples = []
    for file in files:
        stem = Path(file).stem
        nums = []
        for part in stem.split("_"):
            try:
                nums.append(float(part))
            except ValueError:
                continue
        if len(nums) < 2:
            continue
        mach, alpha = nums[0], nums[1]
        beta = nums[2] if len(nums) > 2 else 0.0
        if not (_in_range(mach, mach_range) and _in_range(alpha, alpha_range)
                and _in_range(beta, beta_range)):
            continue
        sample = read_3d_mesh(file)
        sample.meta.update({"mach": mach, "alpha": alpha, "beta": beta})
        samples.append(sample)
    print(f"Filtered to {len(samples)} files based on parameters")
    return samples


def load_ahmed_body(data_dir: str, exp_params: Dict[str, Any]
                    ) -> List[MeshSample]:
    from aero_gnn_tpu_torch.data.vtk_reader import read_ahmed_body
    training = exp_params.get("training", {})
    limits = {"train": training.get("train_num_samples"),
              "validation": training.get("val_num_samples"),
              "test": training.get("test_num_samples")}
    samples = []
    for split in ("train", "validation", "test"):
        split_dir = os.path.join(data_dir, split)
        if not os.path.isdir(split_dir):
            print(f"Warning: Split directory not found: {split_dir}")
            continue
        files = sorted(glob.glob(os.path.join(split_dir, "*.vtp")))
        print(f"Found {len(files)} files in {split} split")
        count = 0
        for file in files:
            limit = limits.get(split)
            if limit is not None and count >= int(limit):
                break
            case_no = Path(file).name.split(".")[0]
            info_path = os.path.join(data_dir, f"{split}_info",
                                     f"{case_no}_info.txt")
            try:
                info = parse_info_file(info_path)
                sample = read_ahmed_body(file)
                sample.meta.update(info)
                sample.meta.update({"split": split, "case_no": case_no})
                samples.append(sample)
                count += 1
            except (KeyError, ValueError, FileNotFoundError) as e:
                print(f"Warning: Failed to load {file}: {e}")
    return samples


def parse_info_file(path: str) -> Dict[str, float]:
    """`Key : value` lines -> float dict (dataset.py:309-317)."""
    info: Dict[str, float] = {}
    with open(path, "r") as f:
        for line in f:
            if ":" in line:
                key, value = line.split(":", 1)
                info[key.strip()] = float(value.strip())
    return info
