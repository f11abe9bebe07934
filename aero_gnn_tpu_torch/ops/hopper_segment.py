"""Sorted masked segment sum: Hopper kernel K5 and its plain version
(counterpart of aero_gnn_tpu.ops.pallas_segment.segment_agg_pallas).

    out[n] = sum over i with ids[i] == n of mask[i] * data[rows[i]]

``ids`` ascending, [E_s] -> [N, D]; ``mask`` defaults to ones and ``rows``
to ``i`` (the optional ``rows`` folds the sender backward's permutation
gather ``ct[sender_perm]`` into the kernel). Accumulation is in fp32 with
one rounding to the data's dtype per output row; nodes without a row get
exact zeros. ``segment_sum`` launches ``csrc/segment_sum.cu`` on CUDA
tensors and runs ``segment_sum_ref`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aero_gnn_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I64, _I64, _I, _I, _P]


def segment_sum_ref(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, *, mask: Optional[torch.Tensor] = None,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: gather ``rows``, mask, ``index_add_`` into an fp32
    buffer, round once. Any trailing shape of ``data``."""
    if rows is not None:
        data = data.index_select(0, rows)
    if mask is not None:
        data = data * mask.to(data.dtype).reshape(
            (-1,) + (1,) * (data.dim() - 1))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=torch.float32, device=data.device)
    out.index_add_(0, segment_ids, data.float())
    return out.to(data.dtype)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, mask: Optional[torch.Tensor] = None,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[*, D] data -> [num_segments, D]. CUDA tensors launch kernel K5 (2-D
    float32/bfloat16 data, int32 ids and rows, mask of the data's dtype);
    CPU tensors run the plain version. No backward of its own (see
    ops.scatter)."""
    if not data.is_cuda:
        return segment_sum_ref(data, segment_ids, num_segments, mask=mask,
                               rows=rows)
    if data.dtype not in _DTYPE_CODE:
        raise ValueError(f"segment-sum kernel takes float32 or bfloat16, "
                         f"not {data.dtype}")
    if data.dim() != 2:
        raise ValueError(f"segment-sum kernel takes [rows, D] data, got "
                         f"shape {tuple(data.shape)}")
    n_ids = segment_ids.shape[0]
    src_rows = data.shape[0] if rows is None else n_ids
    if segment_ids.dim() != 1 or src_rows != n_ids:
        raise ValueError(f"segment_ids has shape {tuple(segment_ids.shape)}"
                         f" for {src_rows} data rows")
    ints = {"segment_ids": segment_ids}
    if rows is not None:
        if tuple(rows.shape) != (n_ids,):
            raise ValueError(f"rows has shape {tuple(rows.shape)}, expected "
                             f"({n_ids},)")
        ints["rows"] = rows
    _build.check_tensors(data.device, torch.int32, **ints)
    floats = {"data": data}
    if mask is not None:
        if tuple(mask.shape) != (n_ids,):
            raise ValueError(f"mask has shape {tuple(mask.shape)}, expected "
                             f"({n_ids},)")
        floats["mask"] = mask
    _build.check_tensors(data.device, data.dtype, **floats)

    out = torch.empty((num_segments, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    fn = _build.c_function("segment_sum", "aero_segment_sum", _ARGTYPES)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), segment_ids.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 None if rows is None else rows.data_ptr(), out.data_ptr(),
                 n_ids, num_segments, data.shape[1],
                 _DTYPE_CODE[data.dtype], stream)
    _build.check_launch("aero_segment_sum", err)
    segment_sum.launches += 1
    return out


# launches of kernel K5 since the count was last set to 0
segment_sum.launches = 0
