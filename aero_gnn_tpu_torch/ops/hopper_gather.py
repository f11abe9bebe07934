"""Row gather of an aligned receiver stream: Hopper kernel K6 and its plain
version (counterpart of aero_gnn_tpu.ops.pallas_segment.
gather_receivers_pallas).

    K6:  out[e] = nodes[idx[e]]        [N, h] -> [E, h]

``gather_rows`` launches ``csrc/gather_rows.cu`` on CUDA tensors (2-D
float32 / bfloat16 nodes, int32 ids) and runs ``gather_rows_ref``
(``index_select``) on CPU tensors. The kernel copies bytes, so its output
is bit-equal to ``index_select``; it does not check that the ids lie in
``[0, N)`` (the streams of ``graph.padded`` do), and it refuses (the launch
raises) an output of 2^31 copy vectors or more. No backward of its own: the
receiver gather's backward is kernel K5 (``ops.scatter.gather_receivers``).
"""

from __future__ import annotations

import ctypes

import torch

from aero_gnn_tpu_torch.ops import _build
from aero_gnn_tpu_torch.utils.profiling import count

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_void_p]


def gather_rows_ref(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``nodes.index_select(0, idx)``."""
    return nodes.index_select(0, idx)


def gather_rows(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, h] nodes -> [E, h] rows ``nodes[idx]``. CUDA tensors launch
    kernel K6; CPU tensors run the plain version."""
    if not nodes.is_cuda:
        return gather_rows_ref(nodes, idx)
    if nodes.dtype not in _DTYPES or nodes.dim() != 2:
        raise ValueError(f"row-gather kernel takes 2-D float32 or bfloat16 "
                         f"nodes, got {nodes.dtype} {tuple(nodes.shape)}")
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    row_bytes = nodes.shape[1] * nodes.element_size()
    _build.check_tensors(nodes.device, nodes.dtype, nodes=nodes)
    _build.check_tensors(nodes.device, torch.int32, idx=idx)
    out = torch.empty((idx.shape[0], nodes.shape[1]), dtype=nodes.dtype,
                      device=nodes.device)
    fn = _build.c_function("gather_rows", "aero_gather_rows", _ARGTYPES)
    with torch.cuda.device(nodes.device):
        stream = torch.cuda.current_stream(nodes.device).cuda_stream
        err = fn(nodes.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 idx.shape[0], row_bytes, stream)
    _build.check_launch("aero_gather_rows", err)
    count("launch.K6")
    return out
