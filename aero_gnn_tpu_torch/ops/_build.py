"""Build the port's CUDA kernels with nvcc at first use and load them.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes. The output directory ``_kernels_build/<hash>/`` is keyed by a hash
of every file in ``csrc/``, so an edited source rebuilds. All sources are
compiled in parallel, one nvcc process each. A failed build raises with
nvcc's stderr. Nothing here runs at import time.

The host libraries ``csrc/host/<name>.cpp`` (the graph core) build the same
way with g++ (``host_library``), into ``_kernels_build/host-<hash>/`` keyed
by the source, the flags and the machine's architecture.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_kernels_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST_SRC = CSRC / "host"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[tuple, object] = {}
_limits: Dict[object, tuple] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source
ptxas_report: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the kernels cannot be built")


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _hashed_dir(paths, flags, prefix: str = "") -> Path:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_ROOT / (prefix + h.hexdigest()[:16])


def _build_dir() -> Path:
    return _hashed_dir([p for p in sorted(CSRC.iterdir())
                        if p.suffix in (".cu", ".cuh")], NVCC_FLAGS)


def build_all(names: Optional[list] = None) -> float:
    """Compile every missing library (in parallel); returns the seconds
    spent. Raises RuntimeError carrying nvcc's stderr on failure."""
    names = sources() if names is None else names
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out_dir / f"lib{n}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        out, err = p.communicate()
        ptxas_report[n] = err
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {p.returncode}):\n"
                          f"{out}{err}")
        else:
            os.replace(tmp, out_dir / f"lib{n}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_build_dir() / f"lib{name}.so"))
        _libs[name] = lib
    return lib


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/host/<name>.cpp``, built with g++ on
    first use. Raises RuntimeError when g++ is missing or fails (with its
    stderr): the host code has no quiet fallback."""
    key = f"host/{name}"
    lib = _libs.get(key)
    if lib is not None:
        return lib
    src = HOST_SRC / f"{name}.cpp"
    out_dir = _hashed_dir([src], GXX_FLAGS + [platform.machine()], "host-")
    so = out_dir / f"lib{name}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH; {src.name} cannot "
                               "be built")
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        p = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed for {src.name} (exit "
                               f"{p.returncode}):\n{p.stdout}{p.stderr}")
        os.replace(tmp, so)
    lib = _libs[key] = ctypes.CDLL(str(so))
    return lib


def c_function(name: str, symbol: str, argtypes: list):
    """``symbol`` of ``csrc/<name>.cu`` with its ctypes signature set: every
    pointer and the stream as c_void_p, sizes as c_int64/c_int; returns the
    cudaError_t as c_int. Kept after the first call, so a launch does not
    look it up again."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def device_limits(device) -> tuple:
    """(SM count, shared memory a CTA may opt in to) of a CUDA device,
    read once."""
    lim = _limits.get(device)
    if lim is None:
        import torch

        props = torch.cuda.get_device_properties(device)
        lim = _limits[device] = (props.multi_processor_count,
                                 props.shared_memory_per_block_optin)
    return lim


def check_launch(symbol: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol} failed: cudaError_t {err}")


def check_tensors(device, dtype, **tensors) -> None:
    """Raise ValueError unless every tensor is contiguous, on ``device`` and
    of ``dtype``. The raw kernel wrappers have no autograd, so they refuse
    tensors that need grad while grad mode is on (the autograd Functions
    call them with grad mode off)."""
    import torch

    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(
                f"{name} requires grad: the raw kernel wrapper has no "
                "backward; call its *_autograd counterpart, or call it "
                "under torch.no_grad()")


def bwd_only_operands(mats):
    """[n, h, h]: each [h, h] weight W of ``mats`` (a list of [h, h] or
    [k, h, h] tensors, in order) as a chain that runs only its backward
    products dz @ W^T reads their B operand from shared memory
    (csrc/rows_bwd.cuh WeightRing with kBwd, for K8): W transposed, which
    is bf16's [n][k] tile that ldmatrix.trans reads as W^T and fp32's
    [k][n] tile of W^T alike. One copy kernel: the transposed views into
    one buffer."""
    import torch

    return torch.cat([m.reshape(-1, *m.shape[-2:]).mT for m in mats])


def edge_bwd_operands(mats):
    """The weights of ``mats`` (as for bwd_only_operands) as K2's, K4's and
    K9-bwd's products read their B operand from shared memory
    (csrc/rows_bwd.cuh WeightRing, for edge_bwd_rows.cuh and
    node_bwd_rows.cuh): bf16 [n, h, h], each W once, transposed ([n][k])
    for ldmatrix, the backward product dz @ W^T reading the same tile
    transposed (bwd_only_operands' array); fp32 [n, 2, h, h], W and W^T
    (both [k][n]), so both FFMA products stream B as rows."""
    import torch

    if mats[0].dtype == torch.bfloat16:
        return bwd_only_operands(mats)
    w = torch.cat([m.reshape(-1, *m.shape[-2:]) for m in mats])
    return torch.stack((w, w.mT), dim=1).contiguous()
