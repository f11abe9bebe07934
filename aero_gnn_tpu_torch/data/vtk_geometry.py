"""Mesh geometry operations on VtkMesh — the pyvista pipeline, re-owned.

The port's own copy of aero_gnn_tpu.data.vtk_geometry: the operation
chain extract_surface -> point normals (flipped) -> slice(z=0) with
cell->point data -> extract_all_edges, plus the cell-data quantities (areas,
normals) the 3D coefficient path needs. All numpy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from aero_gnn_tpu_torch.data.vtk_core import (
    VTK_LINE,
    VTK_POLY_LINE,
    VTK_TRIANGLE,
    _CELL_FACES,
    _SURFACE_TYPES,
    VtkMesh,
)


def extract_surface(mesh: VtkMesh) -> VtkMesh:
    """Boundary surface of a volume mesh (faces referenced exactly once);
    pass-through (minus lines) when cells are already 2D. Point data is
    carried; points are NOT renumbered (pyvista keeps original ids when
    use_all_points-style extraction is used downstream)."""
    has_volume = any(int(t) in _CELL_FACES for t in np.unique(mesh.cell_types))
    if not has_volume:
        return mesh

    face_count: Dict[Tuple[int, ...], List[int]] = {}
    for ctype, verts in mesh.cells():
        faces = _CELL_FACES.get(ctype)
        if faces is None:
            continue
        for f in faces:
            fv = tuple(int(verts[i]) for i in f)
            key = tuple(sorted(fv))
            face_count.setdefault(key, []).append(fv)
    conn, offs, types = [], [], []
    off = 0
    for key, occurrences in face_count.items():
        if len(occurrences) == 1:  # boundary face
            fv = occurrences[0]
            conn.extend(fv)
            off += len(fv)
            offs.append(off)
            types.append(VTK_TRIANGLE if len(fv) == 3 else 9)
    return VtkMesh(
        points=mesh.points,
        connectivity=np.asarray(conn, np.int64),
        offsets=np.asarray(offs, np.int64),
        cell_types=np.asarray(types, np.int64),
        point_data=dict(mesh.point_data),
        cell_data={},
    )


def _face_normals_areas(mesh: VtkMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell normals (unit) and areas via the Newell/shoelace fan."""
    n_cells = mesh.num_cells
    normals = np.zeros((n_cells, 3))
    for c, (ctype, verts) in enumerate(mesh.cells()):
        if ctype not in _SURFACE_TYPES or len(verts) < 3:
            continue
        pts = mesh.points[verts]
        v = np.zeros(3)
        for i in range(1, len(pts) - 1):
            v += np.cross(pts[i] - pts[0], pts[i + 1] - pts[0])
        normals[c] = 0.5 * v
    areas = np.linalg.norm(normals, axis=1)
    unit = normals / np.maximum(areas, 1e-30)[:, None]
    return unit, areas


def compute_point_normals(mesh: VtkMesh, *, flip: bool = True) -> np.ndarray:
    """Area-weighted average of incident face normals per point, normalized.
    ``flip`` mirrors the reference's flip_normals=True (utils.py:28)."""
    unit, areas = _face_normals_areas(mesh)
    acc = np.zeros((mesh.num_points, 3))
    for c, (ctype, verts) in enumerate(mesh.cells()):
        if ctype not in _SURFACE_TYPES:
            continue
        acc[verts] += unit[c] * areas[c]
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    out = acc / np.maximum(norm, 1e-30)
    return -out if flip else out


def compute_cell_normals_areas(mesh: VtkMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell (unit normals, areas) — the `compute_normals(cell_normals=
    True)` + `compute_cell_sizes(area=True)` pair (inference.py:311-315)."""
    return _face_normals_areas(mesh)


def point_data_to_cell_data(mesh: VtkMesh) -> Dict[str, np.ndarray]:
    """Average point fields onto cells (inference.py:320)."""
    out = {}
    sizes = np.diff(np.concatenate([[0], mesh.offsets]))
    for name, arr in mesh.point_data.items():
        vals = arr[mesh.connectivity]
        if vals.ndim == 1:
            vals = vals[:, None]
        cell_vals = np.add.reduceat(
            vals, np.concatenate([[0], mesh.offsets[:-1]]), axis=0)
        cell_vals = cell_vals / np.maximum(sizes, 1)[:, None]
        out[name] = cell_vals if arr.ndim > 1 else cell_vals[:, 0]
    return out


def slice_z(mesh: VtkMesh, z: float = 0.0, *, tol_frac: float = 1e-9
            ) -> VtkMesh:
    """Plane slice at z=const of a triangulated surface -> polyline mesh
    with linearly interpolated point data (pyvista .slice parity for the
    airfoil pipeline, utils.py:31-32).

    Each cut triangle contributes one line segment; intersection points on
    shared edges are deduplicated so the polyline is a connected graph.
    """
    pts = mesh.points
    edge_points: Dict[Tuple[int, int, int], int] = {}
    new_pts: List[np.ndarray] = []
    new_data: Dict[str, List[np.ndarray]] = {k: [] for k in mesh.point_data}
    segments: List[Tuple[int, int]] = []

    span = float(pts[:, 2].max() - pts[:, 2].min()) or 1.0
    tol = span * tol_frac

    def intersect(a: int, b: int) -> int:
        za, zb = pts[a, 2] - z, pts[b, 2] - z
        key = (min(a, b), max(a, b), 0)
        if key in edge_points:
            return edge_points[key]
        t = za / (za - zb)
        p = pts[a] + t * (pts[b] - pts[a])
        idx = len(new_pts)
        new_pts.append(p)
        for name, arr in mesh.point_data.items():
            new_data[name].append(arr[a] + t * (arr[b] - arr[a]))
        edge_points[key] = idx
        return idx

    def on_plane_point(a: int) -> int:
        key = (a, a, 1)
        if key in edge_points:
            return edge_points[key]
        idx = len(new_pts)
        new_pts.append(pts[a].copy())
        for name, arr in mesh.point_data.items():
            new_data[name].append(np.asarray(arr[a]))
        edge_points[key] = idx
        return idx

    for ctype, verts in mesh.cells():
        if ctype not in _SURFACE_TYPES:
            continue
        # walk the polygon boundary; crossings appear in boundary order and
        # pair up as (entry, exit) — a cut convex polygon yields exactly one
        # segment (no fan-triangulation artifacts on quads).
        zz = pts[verts, 2] - z
        if (zz < -tol).all() or (zz > tol).all():
            continue
        crossings: List[int] = []
        k = len(verts)
        for i in range(k):
            a, b = int(verts[i]), int(verts[(i + 1) % k])
            za, zb = pts[a, 2] - z, pts[b, 2] - z
            if abs(za) <= tol:
                p = on_plane_point(a)
                if not crossings or crossings[-1] != p:
                    crossings.append(p)
            elif (za < -tol and zb > tol) or (za > tol and zb < -tol):
                crossings.append(intersect(a, b))
        if len(crossings) >= 2 and crossings[0] == crossings[-1]:
            crossings = crossings[:-1]
        for i in range(0, len(crossings) - 1, 2):
            a, b = crossings[i], crossings[i + 1]
            if a != b:
                segments.append((a, b))

    if not new_pts:
        return VtkMesh(points=np.zeros((0, 3)),
                       connectivity=np.zeros(0, np.int64),
                       offsets=np.zeros(0, np.int64),
                       cell_types=np.zeros(0, np.int64),
                       point_data={k: np.zeros((0,) + v.shape[1:])
                                   for k, v in mesh.point_data.items()},
                       cell_data={})
    conn = np.asarray(segments, np.int64).ravel()
    offs = np.arange(1, len(segments) + 1, dtype=np.int64) * 2
    return VtkMesh(
        points=np.asarray(new_pts),
        connectivity=conn, offsets=offs,
        cell_types=np.full(len(segments), VTK_LINE, np.int64),
        point_data={k: np.asarray(v) for k, v in new_data.items()},
        cell_data={},
    )


def extract_all_edges(mesh: VtkMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Unique undirected edges of all cells -> (senders, receivers) with
    BOTH directions (the to_undirected form the readers need,
    utils.py:34-40). Point ids are preserved (use_all_points=True parity).
    """
    pairs = set()
    for ctype, verts in mesh.cells():
        v = [int(x) for x in verts]
        if ctype in (VTK_LINE, VTK_POLY_LINE):
            for i in range(len(v) - 1):
                pairs.add((min(v[i], v[i + 1]), max(v[i], v[i + 1])))
        elif ctype in _SURFACE_TYPES:
            for i in range(len(v)):
                a, b = v[i], v[(i + 1) % len(v)]
                pairs.add((min(a, b), max(a, b)))
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    arr = np.asarray(sorted(pairs), np.int64)
    senders = np.concatenate([arr[:, 0], arr[:, 1]])
    receivers = np.concatenate([arr[:, 1], arr[:, 0]])
    return senders, receivers
