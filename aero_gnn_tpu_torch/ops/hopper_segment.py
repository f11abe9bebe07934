"""Sorted masked segment sums: Hopper kernels K5, K7 and K10 and their
plain versions (counterparts of aero_gnn_tpu.ops.pallas_segment's
segment_agg_pallas, segment_agg_weighted_pallas and
segment_agg_weighted2_pallas).

    K5:  out[n] = sum over i with ids[i] == n of mask[i] * data[rows[i]]
    K7:  out[n] = sum over i with ids[i] == n of mask[i] * w[i] * data[rows[i]]
    K10: K7 twice over one id stream, (m1, w1) and (m2, w2), no mask or rows

``ids`` ascending, [E_s] -> [N, D]; ``mask`` defaults to ones and ``rows``
to ``i`` (the optional ``rows`` folds a row gather into the kernel: the
sender backward's ``ct[sender_perm]`` for K5, the WeightedEdgeConv's
``x[senders]`` for K7). K7's fp32 weight is rounded to the data's dtype
before the product, as the TPU kernel's weighted one-hot is. Accumulation
is in fp32 with one rounding to the data's dtype per output row; nodes
without a row get exact zeros. ``segment_sum`` / ``segment_sum_weighted``
launch ``csrc/segment_sum.cu`` / ``csrc/segment_sum_weighted.cu`` on CUDA
tensors and run ``segment_sum_ref`` / ``segment_sum_weighted_ref`` on CPU
tensors; ``segment_sum_weighted2`` (the WEC pair probe of
``benchmarks/micro_wec2.py``, on no model path) launches
``csrc/segment_sum_weighted2.cu`` (one row pointer for both sums, on K7's
lane groups) / runs ``segment_sum_weighted2_ref``.

``pad_sink=True`` declares ``ids`` a stream of the aligned layout
(``graph.padded``), whose last segment is the pad sink: its rows are pad
rows adding zero, and a Loader batch puts the tail of its edge budget there.
The kernels then skip them (the last node group's CTA stops its range
before them) and write the sink's row as 0, and so do the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aero_gnn_tpu_torch.ops import _build
from aero_gnn_tpu_torch.utils.profiling import count

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I64, _I64, _I, _I, _I, _P]
_W_ARGTYPES = [_P] * 7 + [_I64, _I64, _I, _I, _I, _P]
_W2_ARGTYPES = [_P] * 8 + [_I64, _I64, _I, _I, _P]


def segment_sum_ref(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, *, mask: Optional[torch.Tensor] = None,
                    rows: Optional[torch.Tensor] = None,
                    pad_sink: bool = False) -> torch.Tensor:
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
    if pad_sink:
        out[-1] = 0.0
    return out.to(data.dtype)


def segment_sum_weighted_ref(data: torch.Tensor, segment_ids: torch.Tensor,
                             weights: torch.Tensor, num_segments: int, *,
                             mask: Optional[torch.Tensor] = None,
                             rows: Optional[torch.Tensor] = None,
                             pad_sink: bool = False) -> torch.Tensor:
    """Plain version of K7: gather ``rows``, the weight rounded to the
    data's dtype, the masked product and the sum in fp32, one rounding."""
    if rows is not None:
        data = data.index_select(0, rows)
    w = weights.to(data.dtype).float()
    if mask is not None:
        w = w * mask.float()
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    out.index_add_(0, segment_ids, data.float() * w[:, None])
    if pad_sink:
        out[-1] = 0.0
    return out.to(data.dtype)


def _check_segment_args(data, segment_ids, mask, rows, **extra):
    """Validate a K5 / K7 launch's tensors; returns the id count."""
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
    for name, t in extra.items():
        if tuple(t.shape) != (n_ids,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"({n_ids},)")
        _build.check_tensors(data.device, torch.float32, **{name: t})
    return n_ids


def weighted_max_width(dtype: torch.dtype, width: int) -> int:
    """The widest row K7 takes (csrc/segment_rows.cuh group_shape): 4
    vectors for each of 32 lanes, 4-value vectors where a row of ``width``
    is a whole number of them, else single values (the same for both
    dtypes)."""
    return 4 * 32 * (4 if width % 4 == 0 else 1)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, mask: Optional[torch.Tensor] = None,
                rows: Optional[torch.Tensor] = None,
                pad_sink: bool = False) -> torch.Tensor:
    """[*, D] data -> [num_segments, D]. CUDA tensors launch kernel K5 (2-D
    float32/bfloat16 data, int32 ids and rows, mask of the data's dtype);
    CPU tensors run the plain version. No backward of its own (see
    ops.scatter)."""
    if not data.is_cuda:
        return segment_sum_ref(data, segment_ids, num_segments, mask=mask,
                               rows=rows, pad_sink=pad_sink)
    n_ids = _check_segment_args(data, segment_ids, mask, rows)
    out = torch.empty((num_segments, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    # the kernel's scratch: the id stream's row pointer
    offsets = torch.empty(num_segments + 1, dtype=torch.int32,
                          device=data.device)
    fn = _build.c_function("segment_sum", "aero_segment_sum", _ARGTYPES)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), segment_ids.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 None if rows is None else rows.data_ptr(),
                 offsets.data_ptr(), out.data_ptr(), n_ids, num_segments,
                 data.shape[1], int(pad_sink), _DTYPE_CODE[data.dtype],
                 stream)
    _build.check_launch("aero_segment_sum", err)
    count("launch.K5")
    return out


def segment_sum_weighted(data: torch.Tensor, segment_ids: torch.Tensor,
                         weights: torch.Tensor, num_segments: int, *,
                         mask: Optional[torch.Tensor] = None,
                         rows: Optional[torch.Tensor] = None,
                         pad_sink: bool = False) -> torch.Tensor:
    """[*, D] data -> [num_segments, D], each row times its fp32 weight.
    CUDA tensors launch kernel K7 (2-D float32/bfloat16 data, int32 ids
    and rows, float32 weights, mask of the data's dtype); CPU tensors run
    the plain version. No backward of its own (see ops.scatter)."""
    if not data.is_cuda:
        return segment_sum_weighted_ref(data, segment_ids, weights,
                                        num_segments, mask=mask, rows=rows,
                                        pad_sink=pad_sink)
    n_ids = _check_segment_args(data, segment_ids, mask, rows,
                                weights=weights)
    if data.shape[1] > weighted_max_width(data.dtype, data.shape[1]):
        raise ValueError(f"K7 takes rows of at most "
                         f"{weighted_max_width(data.dtype, data.shape[1])} "
                         f"values here, not {data.shape[1]}")
    out = torch.empty((num_segments, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    # the kernel's scratch: the id stream's row pointer
    offsets = torch.empty(num_segments + 1, dtype=torch.int32,
                          device=data.device)
    fn = _build.c_function("segment_sum_weighted",
                           "aero_segment_sum_weighted", _W_ARGTYPES)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), segment_ids.data_ptr(), weights.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 None if rows is None else rows.data_ptr(),
                 offsets.data_ptr(), out.data_ptr(),
                 n_ids, num_segments, data.shape[1], int(pad_sink),
                 _DTYPE_CODE[data.dtype], stream)
    _build.check_launch("aero_segment_sum_weighted", err)
    count("launch.K7")
    return out


def segment_sum_weighted2_ref(m1: torch.Tensor, w1: torch.Tensor,
                              m2: torch.Tensor, w2: torch.Tensor,
                              segment_ids: torch.Tensor, num_segments: int):
    """Plain version of K10: two segment_sum_weighted_ref calls."""
    return (segment_sum_weighted_ref(m1, segment_ids, w1, num_segments),
            segment_sum_weighted_ref(m2, segment_ids, w2, num_segments))


def segment_sum_weighted2(m1: torch.Tensor, w1: torch.Tensor,
                          m2: torch.Tensor, w2: torch.Tensor,
                          receivers: torch.Tensor, num_nodes: int):
    """(out1, out2): the weighted segment sums of (m1, w1) and (m2, w2)
    over one ascending receiver stream, [E, D] -> [num_nodes, D] each, the
    fp32 weights rounded to the data's dtype (pad edges: zero weights).
    CUDA tensors launch kernel K10 (2-D float32/bfloat16 data of one dtype
    and shape, int32 receivers); CPU tensors run the plain version. Forward
    only, as the JAX package's probe."""
    if not m1.is_cuda:
        return segment_sum_weighted2_ref(m1, w1, m2, w2, receivers, num_nodes)
    n_ids = _check_segment_args(m1, receivers, None, None, w1=w1, w2=w2)
    if m2.shape != m1.shape:
        raise ValueError(f"m2 has shape {tuple(m2.shape)}, expected "
                         f"{tuple(m1.shape)}")
    _build.check_tensors(m1.device, m1.dtype, m2=m2)
    out1 = torch.empty((num_nodes, m1.shape[1]), dtype=m1.dtype,
                       device=m1.device)
    out2 = torch.empty_like(out1)
    # the kernel's scratch: the id stream's row pointer, shared by both sums
    offsets = torch.empty(num_nodes + 1, dtype=torch.int32,
                          device=m1.device)
    fn = _build.c_function("segment_sum_weighted2",
                           "aero_segment_sum_weighted2", _W2_ARGTYPES)
    with torch.cuda.device(m1.device):
        stream = torch.cuda.current_stream(m1.device).cuda_stream
        err = fn(m1.data_ptr(), m2.data_ptr(), receivers.data_ptr(),
                 w1.data_ptr(), w2.data_ptr(), offsets.data_ptr(),
                 out1.data_ptr(), out2.data_ptr(), n_ids, num_nodes,
                 m1.shape[1], _DTYPE_CODE[m1.dtype], stream)
    _build.check_launch("aero_segment_sum_weighted2", err)
    count("launch.K10")
    return out1, out2
