"""Build the port's CUDA kernels with nvcc at first use and load them.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes. The output directory ``_kernels_build/<hash>/`` is keyed by a hash
of every file in ``csrc/``, so an edited source rebuilds. All sources are
compiled in parallel, one nvcc process each. A failed build raises with
nvcc's stderr. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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

_libs: Dict[str, ctypes.CDLL] = {}
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


def _build_dir() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


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


def c_function(name: str, symbol: str, argtypes: list):
    """``symbol`` of ``csrc/<name>.cu`` with its ctypes signature set: every
    pointer and the stream as c_void_p, sizes as c_int64/c_int; returns the
    cudaError_t as c_int."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(symbol: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol} failed: cudaError_t {err}")


def check_tensors(device, dtype, **tensors) -> None:
    """Raise ValueError unless every tensor is contiguous, on ``device`` and
    of ``dtype``; forward-only kernels also refuse tensors that need grad."""
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
                f"{name} requires grad: the kernel is forward-only, call it "
                "under torch.no_grad()")
