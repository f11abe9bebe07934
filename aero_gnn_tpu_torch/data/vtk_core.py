"""Self-contained VTK XML file parsing (VTU/VTP) — no pyvista/VTK dependency.

Parses the serial XML formats (.vtu UnstructuredGrid, .vtp PolyData) with
ascii, inline-base64, and appended (base64 or raw) data arrays, with
optional zlib compression. The port's own copy of
aero_gnn_tpu.data.vtk_core (numpy and XML only).

Returned ``VtkMesh``: points [N,3], cell connectivity/offsets/types, and
point/cell data dicts of numpy arrays.
"""

from __future__ import annotations

import base64
import dataclasses
import re
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import xml.etree.ElementTree as ET

_DTYPES = {
    "Int8": np.int8, "UInt8": np.uint8,
    "Int16": np.int16, "UInt16": np.uint16,
    "Int32": np.int32, "UInt32": np.uint32,
    "Int64": np.int64, "UInt64": np.uint64,
    "Float32": np.float32, "Float64": np.float64,
}

# VTK cell types we understand
VTK_VERTEX = 1
VTK_LINE = 3
VTK_POLY_LINE = 4
VTK_TRIANGLE = 5
VTK_POLYGON = 7
VTK_QUAD = 9
VTK_TETRA = 10
VTK_HEXAHEDRON = 12
VTK_WEDGE = 13
VTK_PYRAMID = 14

# faces of 3D cells (local vertex indices), for surface extraction
_CELL_FACES = {
    VTK_TETRA: [(0, 1, 2), (0, 1, 3), (1, 2, 3), (0, 2, 3)],
    VTK_HEXAHEDRON: [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
                     (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7)],
    VTK_WEDGE: [(0, 1, 2), (3, 4, 5), (0, 1, 4, 3), (1, 2, 5, 4),
                (2, 0, 3, 5)],
    VTK_PYRAMID: [(0, 1, 2, 3), (0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4)],
}

_SURFACE_TYPES = (VTK_TRIANGLE, VTK_QUAD, VTK_POLYGON)


@dataclasses.dataclass
class VtkMesh:
    points: np.ndarray  # [N, 3]
    connectivity: np.ndarray  # flat cell vertex list
    offsets: np.ndarray  # [C] end offset per cell
    cell_types: np.ndarray  # [C] VTK cell type ids
    point_data: Dict[str, np.ndarray]
    cell_data: Dict[str, np.ndarray]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_cells(self) -> int:
        return self.offsets.shape[0]

    def cells(self):
        """Yield per-cell (type, vertex index array)."""
        start = 0
        for c in range(self.num_cells):
            end = int(self.offsets[c])
            yield int(self.cell_types[c]), self.connectivity[start:end]
            start = end


def _split_appended(raw: bytes) -> Tuple[bytes, Optional[bytes]]:
    """Separate the XML part from <AppendedData encoding="raw"> payload
    (whose bytes are not valid XML)."""
    m = re.search(rb'<AppendedData[^>]*encoding="raw"[^>]*>', raw)
    if not m:
        return raw, None
    start = raw.index(b"_", m.end()) + 1
    end = raw.rindex(b"</AppendedData>")
    payload = raw[start:end].rstrip(b"\n\r\t ")
    xml_part = raw[:m.end()] + b"</AppendedData>" + raw[end + len(b"</AppendedData>"):]
    return xml_part, payload


def _decode_block(data: bytes, header_dtype, compressed: bool) -> bytes:
    """Decode one VTK binary block: [nblocks, blocksize, lastsize,
    sizes...] header + payload (compressed) or [nbytes] header (raw)."""
    hsize = np.dtype(header_dtype).itemsize
    if not compressed:
        n = int(np.frombuffer(data[:hsize], header_dtype)[0])
        return data[hsize:hsize + n]
    head = np.frombuffer(data[: 3 * hsize], header_dtype)
    nblocks = int(head[0])
    sizes = np.frombuffer(data[3 * hsize: (3 + nblocks) * hsize],
                          header_dtype)
    payload = data[(3 + nblocks) * hsize:]
    out, off = [], 0
    for s in sizes:
        out.append(zlib.decompress(payload[off:off + int(s)]))
        off += int(s)
    return b"".join(out)


def _b64_len(nbytes: int) -> int:
    """Base64 characters used to encode ``nbytes`` (padded stream)."""
    return 4 * ((nbytes + 2) // 3)


def _decode_compressed_b64(text: str, header_dtype) -> bytes:
    """VTK compressed base64: the [nblocks, blocksize, lastsize, sizes...]
    header and the payload are SEPARATE base64 streams, concatenated."""
    hsize = np.dtype(header_dtype).itemsize
    head0 = base64.b64decode(text[:_b64_len(3 * hsize)])[: 3 * hsize]
    nblocks = int(np.frombuffer(head0, header_dtype)[0])
    nhead = (3 + nblocks) * hsize
    header = base64.b64decode(text[:_b64_len(nhead)])[:nhead]
    sizes = np.frombuffer(header, header_dtype)[3:]
    payload = base64.b64decode(text[_b64_len(nhead):])
    out, off = [], 0
    for s in sizes:
        out.append(zlib.decompress(payload[off:off + int(s)]))
        off += int(s)
    return b"".join(out)


class _Reader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        xml_part, self.appended_raw = _split_appended(raw)
        self.root = ET.fromstring(xml_part)
        self.byte_order = self.root.get("byte_order", "LittleEndian")
        self.header_dtype = _DTYPES[self.root.get("header_type", "UInt32")]
        self.compressed = self.root.get("compressor") is not None
        app = self.root.find(".//AppendedData")
        if app is not None and self.appended_raw is None:
            text = (app.text or "").strip()
            if text.startswith("_"):
                text = text[1:]
            self.appended_b64 = text
        else:
            self.appended_b64 = None

    def _appended_bytes(self, offset: int) -> bytes:
        if self.appended_raw is not None:
            return self.appended_raw[offset:]
        if self.appended_b64 is not None:
            # base64-appended: decode from each array's character offset
            return base64.b64decode(self.appended_b64[offset:] + "===")
        raise ValueError("DataArray references appended data but none found")

    def read_data_array(self, node: ET.Element) -> np.ndarray:
        dtype = _DTYPES[node.get("type")]
        ncomp = int(node.get("NumberOfComponents", "1"))
        fmt = node.get("format", "ascii")
        if fmt == "ascii":
            arr = np.array((node.text or "").split(), dtype=dtype)
        elif fmt == "binary":
            text = (node.text or "").strip()
            if self.compressed:
                raw = _decode_compressed_b64(text, self.header_dtype)
            else:
                raw = _decode_block(base64.b64decode(text),
                                    self.header_dtype, False)
            arr = np.frombuffer(raw, dtype=dtype).copy()
        elif fmt == "appended":
            offset = int(node.get("offset", "0"))
            if self.appended_raw is None and self.compressed:
                raw = _decode_compressed_b64(
                    self.appended_b64[offset:], self.header_dtype)
            else:
                raw = _decode_block(self._appended_bytes(offset),
                                    self.header_dtype, self.compressed)
            arr = np.frombuffer(raw, dtype=dtype).copy()
        else:
            raise ValueError(f"Unknown DataArray format: {fmt}")
        if self.byte_order == "BigEndian":
            arr = arr.byteswap()
        if ncomp > 1:
            arr = arr.reshape(-1, ncomp)
        return arr

    def _read_fields(self, parent: Optional[ET.Element]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        if parent is None:
            return out
        for da in parent.findall("DataArray"):
            name = da.get("Name")
            if name:
                out[name] = self.read_data_array(da)
        return out


def read_vtu(path: str) -> VtkMesh:
    """Read a serial .vtu (UnstructuredGrid)."""
    r = _Reader(path)
    piece = r.root.find(".//UnstructuredGrid/Piece")
    if piece is None:
        raise ValueError(f"{path}: no UnstructuredGrid Piece")
    pts_node = piece.find("Points/DataArray")
    points = r.read_data_array(pts_node).astype(np.float64).reshape(-1, 3)
    cells = piece.find("Cells")
    conn = offs = types = None
    for da in cells.findall("DataArray"):
        name = da.get("Name")
        if name == "connectivity":
            conn = r.read_data_array(da).astype(np.int64).ravel()
        elif name == "offsets":
            offs = r.read_data_array(da).astype(np.int64).ravel()
        elif name == "types":
            types = r.read_data_array(da).astype(np.int64).ravel()
    return VtkMesh(points=points, connectivity=conn, offsets=offs,
                   cell_types=types,
                   point_data=r._read_fields(piece.find("PointData")),
                   cell_data=r._read_fields(piece.find("CellData")))


def read_vtp(path: str) -> VtkMesh:
    """Read a serial .vtp (PolyData): Polys + Lines become cells."""
    r = _Reader(path)
    piece = r.root.find(".//PolyData/Piece")
    if piece is None:
        raise ValueError(f"{path}: no PolyData Piece")
    pts_node = piece.find("Points/DataArray")
    points = r.read_data_array(pts_node).astype(np.float64).reshape(-1, 3)

    conn_list, offs_list, type_list = [], [], []
    base = 0

    def add_block(node, kind):
        nonlocal base
        if node is None:
            return
        conn = offs = None
        for da in node.findall("DataArray"):
            if da.get("Name") == "connectivity":
                conn = r.read_data_array(da).astype(np.int64).ravel()
            elif da.get("Name") == "offsets":
                offs = r.read_data_array(da).astype(np.int64).ravel()
        if conn is None or offs is None or len(offs) == 0:
            return
        conn_list.append(conn)
        offs_list.append(offs + base)
        sizes = np.diff(np.concatenate([[0], offs]))
        if kind == "polys":
            t = np.where(sizes == 3, VTK_TRIANGLE,
                         np.where(sizes == 4, VTK_QUAD, VTK_POLYGON))
        else:
            t = np.where(sizes == 2, VTK_LINE, VTK_POLY_LINE)
        type_list.append(t.astype(np.int64))
        base += conn.shape[0]

    add_block(piece.find("Polys"), "polys")
    add_block(piece.find("Lines"), "lines")
    if not conn_list:
        conn = np.zeros(0, np.int64)
        offs = np.zeros(0, np.int64)
        types = np.zeros(0, np.int64)
    else:
        conn = np.concatenate(conn_list)
        offs = np.concatenate(offs_list)
        types = np.concatenate(type_list)
    return VtkMesh(points=points, connectivity=conn, offsets=offs,
                   cell_types=types,
                   point_data=r._read_fields(piece.find("PointData")),
                   cell_data=r._read_fields(piece.find("CellData")))


def read_any(path: str) -> VtkMesh:
    if path.endswith(".vtp"):
        return read_vtp(path)
    return read_vtu(path)
