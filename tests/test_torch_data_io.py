"""Port parity for data ingestion: the synthetic airfoil family, splits and
normalisation (create_datasets), and the VTU/VTP parser, geometry, readers,
writers and mesh_io loaders, each against the JAX package's on the same
inputs: bit-equal arrays, byte-equal files."""

import base64
import os
import struct
import zlib

import numpy as np
import pytest

from aero_gnn_tpu.data import dataset as JD
from aero_gnn_tpu.data import mesh_io as JIO
from aero_gnn_tpu.data import synthetic as JS
from aero_gnn_tpu.data import vtk_core as JVC
from aero_gnn_tpu.data import vtk_geometry as JVG
from aero_gnn_tpu.data import vtk_reader as JVR
from aero_gnn_tpu.data import vtk_writer as JVW
from aero_gnn_tpu_torch.data import dataset as TD
from aero_gnn_tpu_torch.data import mesh_io as TIO
from aero_gnn_tpu_torch.data import synthetic as TS
from aero_gnn_tpu_torch.data import vtk_core as TVC
from aero_gnn_tpu_torch.data import vtk_geometry as TVG
from aero_gnn_tpu_torch.data import vtk_reader as TVR
from aero_gnn_tpu_torch.data import vtk_writer as TVW

SAMPLE_ARRAYS = ("pos", "normals", "senders", "receivers", "y", "x",
                 "edge_attr")


def assert_samples_equal(ts, js):
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        assert t.meta == j.meta
        for name in SAMPLE_ARRAYS:
            a, b = getattr(t, name), getattr(j, name)
            if b is None:
                assert a is None, name
                continue
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_airfoil_dataset_bit_equal():
    ts = TS.make_airfoil_dataset(n_cases=10, n_points=48, seed=3)
    js = JS.make_airfoil_dataset(n_cases=10, n_points=48, seed=3)
    assert_samples_equal(ts, js)
    # the pieces it is made of, with and without noise
    np.testing.assert_array_equal(TS.naca_profile(40, 0.1, 0.03, 0.5),
                                  JS.naca_profile(40, 0.1, 0.03, 0.5))
    one = [m.make_airfoil_sample(n_points=32, mach=0.7, alpha=-3.0,
                                 noise=0.02, rng=np.random.default_rng(5))
           for m in (TS, JS)]
    assert_samples_equal(one[:1], one[1:])


def _presplit(mod, seed):
    samples = mod.make_airfoil_dataset(n_cases=12, n_points=40, seed=seed)
    for i, s in enumerate(samples):
        s.meta["split"] = ("train", "validation", "test", "other")[i % 4]
    return samples


SPLIT_PARAMS = {"dataset": {"var_keys": ["mach", "alpha"]},
                "training": {"validation_split": 0.25, "test_split": 0.25,
                             "random_seed": 7}}


@pytest.mark.parametrize("dataset_type", ["synthetic_airfoil", "airfoil_2d",
                                          "ahmed_body"])
def test_create_datasets_matches_jax(dataset_type):
    """Generic random split, split by airfoil name and the presplit set:
    the same members in the same order, the same feature bits and stats."""
    if dataset_type == "ahmed_body":
        ts, js = _presplit(TS, 2), _presplit(JS, 2)
    else:
        ts = TS.make_airfoil_dataset(n_cases=32, n_points=40, seed=2)
        js = JS.make_airfoil_dataset(n_cases=32, n_points=40, seed=2)
    tout = TD.create_datasets(ts, dataset_type=dataset_type,
                              params=SPLIT_PARAMS)
    jout = JD.create_datasets(js, dataset_type=dataset_type,
                              params=SPLIT_PARAMS)
    for tsplit, jsplit in zip(tout[:3], jout[:3]):
        assert tsplit, "every split holds samples at this size"
        assert_samples_equal(tsplit, jsplit)
    assert sorted(tout[3]) == sorted(jout[3])
    for k, v in jout[3].items():
        assert tout[3][k].dtype == v.dtype
        np.testing.assert_array_equal(tout[3][k], v, err_msg=k)


def test_split_ratios_must_sum_to_one():
    s = TS.make_airfoil_dataset(n_cases=4, n_points=24, seed=0)
    with pytest.raises(ValueError, match="sum to 1.0"):
        TD.split_generic(s, 0.5, 0.2, 0.2)
    with pytest.raises(ValueError, match="sum to 1.0"):
        TD.split_by_group(s, "airfoil", 0.5, 0.2, 0.2)


# ---------------------------------------------------------------------------
# VTK fixtures: the mesh kinds tests/test_vtk.py writes
# ---------------------------------------------------------------------------

def extruded_airfoil(VC, n=24, z_half=0.1):
    """Extruded closed contour (a quad strip) with P / tau / t point
    fields: the airfoil_2d file shape."""
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([np.cos(th) * 0.5 + 0.5, 0.1 * np.sin(th),
                     np.zeros(n)], 1)
    points = np.concatenate([ring - [0, 0, z_half], ring + [0, 0, z_half]])
    conn = []
    for i in range(n):
        j = (i + 1) % n
        conn += [i, j, j + n, i + n]
    x = points[:, 0]
    return VC.VtkMesh(
        points=points, connectivity=np.asarray(conn, np.int64),
        offsets=np.arange(1, n + 1, dtype=np.int64) * 4,
        cell_types=np.full(n, VC.VTK_QUAD, np.int64),
        point_data={"P": 101325.0 * (1 + 0.1 * x),
                    "tau": np.stack([x * 2.0, -x, np.zeros(2 * n)], 1),
                    "t": 288.0 * (1 + 0.05 * x)},
        cell_data={})


def tri_sphere(VC, n_theta=8, n_phi=6):
    """Triangulated 3D surface with P / tau / T and the ahmed_body fields."""
    pts, tris = [], []
    for i in range(n_phi + 1):
        phi = np.pi * i / n_phi
        for j in range(n_theta):
            th = 2 * np.pi * j / n_theta
            pts.append([np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th),
                        np.cos(phi)])
    for i in range(n_phi):
        for j in range(n_theta):
            a, b = i * n_theta + j, i * n_theta + (j + 1) % n_theta
            c, d = a + n_theta, b + n_theta
            tris += [(a, b, c), (b, d, c)]
    pts = np.asarray(pts)
    n_pts = len(pts)
    shear = np.stack([np.linspace(0.1, 0.2, n_pts), np.full(n_pts, 0.2),
                      np.linspace(0.3, 0.1, n_pts)], 1)
    return VC.VtkMesh(
        points=pts, connectivity=np.asarray(tris, np.int64).ravel(),
        offsets=np.arange(1, len(tris) + 1, dtype=np.int64) * 3,
        cell_types=np.full(len(tris), VC.VTK_TRIANGLE, np.int64),
        point_data={"P": np.linspace(1.0, 2.0, n_pts), "tau": shear,
                    "T": np.full(n_pts, 300.0),
                    "p": np.linspace(1.0, 2.0, n_pts),
                    "wallShearStress": shear},
        cell_data={})


MESH_ARRAYS = ("points", "connectivity", "offsets", "cell_types")


def assert_meshes_equal(t, j):
    for name in MESH_ARRAYS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for kind in ("point_data", "cell_data"):
        ta, ja = getattr(t, kind), getattr(j, kind)
        assert sorted(ta) == sorted(ja), kind
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=f"{kind} {k}")


def _b64(arr):
    raw = arr.tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def _b64z(arr):
    raw = arr.tobytes()
    comp = zlib.compress(raw)
    header = struct.pack("<III", 1, len(raw), len(raw)) + \
        struct.pack("<I", len(comp))
    return base64.b64encode(header).decode() + base64.b64encode(comp).decode()


def _binary_vtu(encode, compressor):
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5]],
                   np.float32)
    conn = np.array([0, 1, 2, 1, 3, 2], np.int32)
    offs = np.array([3, 6], np.int32)
    types = np.array([5, 5], np.uint8)
    pres = np.array([1.5, 2.5, 3.5, 4.5], np.float64)
    comp = (f' compressor="{compressor}"' if compressor else "")
    return f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian" header_type="UInt32"{comp}>
  <UnstructuredGrid><Piece NumberOfPoints="4" NumberOfCells="2">
    <PointData><DataArray type="Float64" Name="P" format="binary">{encode(pres)}</DataArray></PointData>
    <Points><DataArray type="Float32" NumberOfComponents="3" format="binary">{encode(pts)}</DataArray></Points>
    <Cells>
      <DataArray type="Int32" Name="connectivity" format="binary">{encode(conn)}</DataArray>
      <DataArray type="Int32" Name="offsets" format="binary">{encode(offs)}</DataArray>
      <DataArray type="UInt8" Name="types" format="binary">{encode(types)}</DataArray>
    </Cells>
  </Piece></UnstructuredGrid>
</VTKFile>"""


@pytest.mark.parametrize("kind", ["ascii_vtu", "ascii_vtp", "base64",
                                  "zlib"])
def test_vtk_parser_matches_jax(kind, tmp_path):
    """ASCII (as the writers write), inline base64 and zlib-compressed
    base64 files read to the same arrays in both packages."""
    if kind.startswith("ascii"):
        ext = kind[-3:]
        path = str(tmp_path / f"m.{ext}")
        getattr(JVW, f"write_{ext}")(path, tri_sphere(JVC))
    else:
        path = str(tmp_path / "m.vtu")
        encode, comp = ((_b64, None) if kind == "base64"
                        else (_b64z, "vtkZLibDataCompressor"))
        with open(path, "w") as f:
            f.write(_binary_vtu(encode, comp))
    t, j = TVC.read_any(path), JVC.read_any(path)
    assert_meshes_equal(t, j)
    assert t.num_points > 0


@pytest.mark.parametrize("ext", ["vtu", "vtp"])
def test_vtk_writer_byte_equal(ext, tmp_path):
    for name, build in (("sphere", tri_sphere), ("strip", extruded_airfoil)):
        paths = []
        for pkg, VC, VW in (("t", TVC, TVW), ("j", JVC, JVW)):
            p = tmp_path / f"{pkg}_{name}.{ext}"
            getattr(VW, f"write_{ext}")(str(p), build(VC))
            paths.append(p)
        assert paths[0].read_bytes() == paths[1].read_bytes(), name


def test_export_predictions_vtu_byte_equal(tmp_path):
    s = TS.make_airfoil_dataset(n_cases=1, n_points=32, seed=1)[0]
    rng = np.random.default_rng(0)
    pred = rng.standard_normal(s.y.shape).astype(np.float32)
    files = []
    for pkg, VW in (("t", TVW), ("j", JVW)):
        p = tmp_path / f"{pkg}.vtu"
        VW.export_predictions_vtu(
            str(p), points=s.pos, senders=s.senders, receivers=s.receivers,
            feature_names=["P", "tau_x", "tau_y", "T"], pred=pred,
            target=s.y)
        files.append(p.read_bytes())
    assert files[0] == files[1]


def test_vtk_geometry_matches_jax():
    t, j = tri_sphere(TVC, 12, 8), tri_sphere(JVC, 12, 8)
    for flip in (False, True):
        np.testing.assert_array_equal(TVG.compute_point_normals(t, flip=flip),
                                      JVG.compute_point_normals(j, flip=flip))
    for a, b in zip(TVG.compute_cell_normals_areas(t),
                    JVG.compute_cell_normals_areas(j)):
        np.testing.assert_array_equal(a, b)
    tc, jc = TVG.point_data_to_cell_data(t), JVG.point_data_to_cell_data(j)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k])
    ts, js = TVG.slice_z(extruded_airfoil(TVC), 0.0), \
        JVG.slice_z(extruded_airfoil(JVC), 0.0)
    assert_meshes_equal(ts, js)
    for a, b in zip(TVG.extract_all_edges(ts), JVG.extract_all_edges(js)):
        np.testing.assert_array_equal(a, b)
    hexa = dict(points=np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                                 [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                                np.float64),
                connectivity=np.arange(8, dtype=np.int64),
                offsets=np.array([8], np.int64), point_data={}, cell_data={})
    assert_meshes_equal(
        TVG.extract_surface(TVC.VtkMesh(
            **hexa, cell_types=np.array([TVC.VTK_HEXAHEDRON], np.int64))),
        JVG.extract_surface(JVC.VtkMesh(
            **hexa, cell_types=np.array([JVC.VTK_HEXAHEDRON], np.int64))))


@pytest.mark.parametrize("reader,build,fname,writer", [
    ("read_2d_mesh", extruded_airfoil, "walls_Surf64.vtu", "write_vtu"),
    ("read_3d_mesh", tri_sphere, "case_0.85_0_0.vtu", "write_vtu"),
    ("read_ahmed_body", tri_sphere, "case1.vtp", "write_vtp"),
])
def test_readers_match_jax(reader, build, fname, writer, tmp_path):
    path = str(tmp_path / fname)
    getattr(JVW, writer)(path, build(JVC))
    assert_samples_equal([getattr(TVR, reader)(path)],
                         [getattr(JVR, reader)(path)])


def _airfoil_tree(root):
    """<root>/<airfoil>/<prefix>_<mach>_<alpha>/walls_Surf64.vtu, 2 x 3
    cases; one (mach 0.9) outside the experiment's mach range."""
    for a, airfoil in enumerate(("naca0012", "naca2412")):
        for mach, alpha in ((0.3, 2.0), (0.5, -1.0), (0.9, 0.0)):
            d = os.path.join(root, airfoil, f"run_{mach}_{alpha}")
            os.makedirs(d)
            JVW.write_vtu(os.path.join(d, "walls_Surf64.vtu"),
                          extruded_airfoil(JVC, n=16 + 4 * a))


def _ahmed_tree(root):
    """<root>/{train,validation,test}/<case>.vtp + <split>_info files."""
    for k, split in enumerate(("train", "train", "validation", "test")):
        case = f"case{k}"
        os.makedirs(os.path.join(root, split), exist_ok=True)
        os.makedirs(os.path.join(root, f"{split}_info"), exist_ok=True)
        JVW.write_vtp(os.path.join(root, split, f"{case}.vtp"),
                      tri_sphere(JVC, 6 + k, 4))
        with open(os.path.join(root, f"{split}_info",
                               f"{case}_info.txt"), "w") as f:
            f.write(f"Velocity : {30 + k}\nHeight : 288\nWidth : 389\n")


@pytest.mark.parametrize("name", ["airfoil_2d", "ahmed_body"])
def test_mesh_io_create_datasets_match_jax(name, tmp_path):
    """The CLI's file branch: load_dataset over a data_dir, then
    create_datasets, in both packages."""
    root = str(tmp_path / "data")
    (_airfoil_tree if name == "airfoil_2d" else _ahmed_tree)(root)
    ds = {"name": name, "data_dir": root, "mach": [0.3, 0.6],
          "var_keys": ["mach", "alpha"] if name == "airfoil_2d"
          else ["Velocity", "Height"]}
    exp = {"dataset": ds, "training": {"validation_split": 0.25,
                                       "test_split": 0.25,
                                       "random_seed": 3}}
    tl, jl = TIO.load_dataset(ds, exp), JIO.load_dataset(ds, exp)
    assert len(tl) == 4
    assert_samples_equal(tl, jl)
    tout = TD.create_datasets(tl, dataset_type=name, params=exp)
    jout = JD.create_datasets(jl, dataset_type=name, params=exp)
    for a, b in zip(tout[:3], jout[:3]):
        assert_samples_equal(a, b)
    for k, v in jout[3].items():
        np.testing.assert_array_equal(tout[3][k], v, err_msg=k)
    with pytest.raises(FileNotFoundError, match="data_dir"):
        TIO.load_dataset(dict(ds, data_dir=None), exp)
