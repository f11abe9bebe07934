"""Mesh readers: VTU/VTP files -> MeshSample.

The port's own copy of aero_gnn_tpu.data.vtk_reader, on the
self-contained parser + geometry ops (no pyvista):

  read_2d_mesh:   extract_surface -> flipped point normals -> slice z=0 ->
                  edges; y = [P, tau_x, tau_y, T] (field "t" lowercase in
                  sliced data, utils.py:47); pos/normals truncated to 2D
  read_3d_mesh:   same minus slice; y = [P, tau(3), T]
  read_ahmed_body: fields p / wallShearStress; y = [p, tau(3)]
"""

from __future__ import annotations

import numpy as np

from aero_gnn_tpu_torch.data.dataset import MeshSample
from aero_gnn_tpu_torch.data.vtk_core import read_any
from aero_gnn_tpu_torch.data.vtk_geometry import (
    compute_point_normals,
    extract_all_edges,
    extract_surface,
    slice_z,
)


def read_2d_mesh(path: str, dtype=np.float32) -> MeshSample:
    mesh = read_any(path)
    surface = extract_surface(mesh)
    normals3 = compute_point_normals(surface, flip=True)
    surface.point_data = dict(surface.point_data)
    surface.point_data["__normals__"] = normals3
    slc = slice_z(surface, 0.0)
    senders, receivers = extract_all_edges(slc)

    pos = slc.points[:, :2]
    normals = slc.point_data["__normals__"][:, :2]
    tau = np.asarray(slc.point_data["tau"])[:, :2]
    pressure = np.asarray(slc.point_data["P"]).reshape(-1, 1)
    temperature = np.asarray(slc.point_data["t"]).reshape(-1, 1)
    y = np.concatenate([pressure, tau, temperature], axis=1)
    return MeshSample(
        pos=pos.astype(dtype),
        normals=normals.astype(dtype),
        senders=senders, receivers=receivers,
        y=y.astype(dtype), meta={})


def read_3d_mesh(path: str, dtype=np.float32) -> MeshSample:
    mesh = read_any(path)
    surface = extract_surface(mesh)
    normals = compute_point_normals(surface, flip=True)
    senders, receivers = extract_all_edges(surface)
    tau = np.asarray(surface.point_data["tau"])
    pressure = np.asarray(surface.point_data["P"]).reshape(-1, 1)
    temperature = np.asarray(surface.point_data["T"]).reshape(-1, 1)
    y = np.concatenate([pressure, tau, temperature], axis=1)
    return MeshSample(
        pos=surface.points.astype(dtype),
        normals=normals.astype(dtype),
        senders=senders, receivers=receivers,
        y=y.astype(dtype), meta={})


def read_ahmed_body(path: str, dtype=np.float32) -> MeshSample:
    mesh = read_any(path)
    surface = extract_surface(mesh)
    normals = compute_point_normals(surface, flip=True)
    senders, receivers = extract_all_edges(surface)
    tau = np.asarray(surface.point_data["wallShearStress"])
    pressure = np.asarray(surface.point_data["p"]).reshape(-1, 1)
    y = np.concatenate([pressure, tau], axis=1)
    return MeshSample(
        pos=surface.points.astype(dtype),
        normals=normals.astype(dtype),
        senders=senders, receivers=receivers,
        y=y.astype(dtype), meta={})
