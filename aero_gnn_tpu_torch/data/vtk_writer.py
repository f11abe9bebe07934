"""VTK XML writers (VTU/VTP) — for prediction export and test fixtures.

The port's own copy of aero_gnn_tpu.data.vtk_writer: VTU export with
predicted/true/error point arrays.
Supports ascii and appended-raw encodings (the two that round-trip through
our reader and ParaView alike).
"""

from __future__ import annotations

import numpy as np

from aero_gnn_tpu_torch.data.vtk_core import VTK_LINE, VTK_QUAD, VTK_TRIANGLE, VtkMesh

_NPDTYPES = {
    np.dtype(np.float32): "Float32", np.dtype(np.float64): "Float64",
    np.dtype(np.int32): "Int32", np.dtype(np.int64): "Int64",
    np.dtype(np.uint8): "UInt8",
}


def _ascii_array(name, arr, indent="        "):
    arr = np.asarray(arr)
    ncomp = arr.shape[1] if arr.ndim > 1 else 1
    vtype = _NPDTYPES[arr.dtype]
    name_attr = f' Name="{name}"' if name else ""
    txt = " ".join(str(v) for v in arr.ravel())
    return (f'{indent}<DataArray type="{vtype}"{name_attr} '
            f'NumberOfComponents="{ncomp}" format="ascii">\n'
            f"{indent}  {txt}\n{indent}</DataArray>\n")


def write_vtu(path: str, mesh: VtkMesh) -> None:
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write("  <UnstructuredGrid>\n")
        f.write(f'    <Piece NumberOfPoints="{mesh.num_points}" '
                f'NumberOfCells="{mesh.num_cells}">\n')
        f.write("      <Points>\n")
        f.write(_ascii_array(None, mesh.points.astype(np.float64)))
        f.write("      </Points>\n")
        f.write("      <Cells>\n")
        f.write(_ascii_array("connectivity",
                             mesh.connectivity.astype(np.int64)))
        f.write(_ascii_array("offsets", mesh.offsets.astype(np.int64)))
        f.write(_ascii_array("types", mesh.cell_types.astype(np.uint8)))
        f.write("      </Cells>\n")
        if mesh.point_data:
            f.write("      <PointData>\n")
            for name, arr in mesh.point_data.items():
                f.write(_ascii_array(name, np.asarray(arr, np.float64)))
            f.write("      </PointData>\n")
        if mesh.cell_data:
            f.write("      <CellData>\n")
            for name, arr in mesh.cell_data.items():
                f.write(_ascii_array(name, np.asarray(arr, np.float64)))
            f.write("      </CellData>\n")
        f.write("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")


def write_vtp(path: str, mesh: VtkMesh) -> None:
    """Write polys (+lines) PolyData."""
    polys_conn, polys_offs = [], []
    lines_conn, lines_offs = [], []
    po = lo = 0
    for ctype, verts in mesh.cells():
        if ctype in (VTK_TRIANGLE, VTK_QUAD, 7):
            polys_conn.extend(int(v) for v in verts)
            po += len(verts)
            polys_offs.append(po)
        elif ctype in (VTK_LINE, 4):
            lines_conn.extend(int(v) for v in verts)
            lo += len(verts)
            lines_offs.append(lo)
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="PolyData" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write("  <PolyData>\n")
        f.write(f'    <Piece NumberOfPoints="{mesh.num_points}" '
                f'NumberOfPolys="{len(polys_offs)}" '
                f'NumberOfLines="{len(lines_offs)}">\n')
        f.write("      <Points>\n")
        f.write(_ascii_array(None, mesh.points.astype(np.float64)))
        f.write("      </Points>\n")
        if polys_offs:
            f.write("      <Polys>\n")
            f.write(_ascii_array("connectivity",
                                 np.asarray(polys_conn, np.int64)))
            f.write(_ascii_array("offsets", np.asarray(polys_offs, np.int64)))
            f.write("      </Polys>\n")
        if lines_offs:
            f.write("      <Lines>\n")
            f.write(_ascii_array("connectivity",
                                 np.asarray(lines_conn, np.int64)))
            f.write(_ascii_array("offsets", np.asarray(lines_offs, np.int64)))
            f.write("      </Lines>\n")
        if mesh.point_data:
            f.write("      <PointData>\n")
            for name, arr in mesh.point_data.items():
                f.write(_ascii_array(name, np.asarray(arr, np.float64)))
            f.write("      </PointData>\n")
        f.write("    </Piece>\n  </PolyData>\n</VTKFile>\n")


def export_predictions_vtu(path: str, *, points: np.ndarray,
                           senders: np.ndarray, receivers: np.ndarray,
                           feature_names, pred: np.ndarray,
                           target: np.ndarray = None) -> None:
    """Export a prediction mesh: per-feature predicted_/true_/error_ point
    arrays over the line graph (inference.py:196-208 contract)."""
    n = points.shape[0]
    if points.shape[1] == 2:
        points = np.concatenate([points, np.zeros((n, 1))], axis=1)
    mask = senders < receivers
    conn = np.stack([senders[mask], receivers[mask]], 1).ravel()
    offs = np.arange(1, mask.sum() + 1, dtype=np.int64) * 2
    pdata = {}
    for j, name in enumerate(feature_names):
        pdata[f"predicted_{name}"] = pred[:, j]
        if target is not None:
            pdata[f"true_{name}"] = target[:, j]
            pdata[f"error_{name}"] = pred[:, j] - target[:, j]
    mesh = VtkMesh(points=points, connectivity=conn.astype(np.int64),
                   offsets=offs,
                   cell_types=np.full(len(offs), VTK_LINE, np.int64),
                   point_data=pdata, cell_data={})
    write_vtu(path, mesh)
