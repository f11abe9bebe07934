"""Gather / segment primitives with the JAX package's custom VJPs
(counterpart of aero_gnn_tpu.ops.scatter).

Shape-static and mask-aware: pad edges/nodes contribute exact zeros and
empty segments are zero rows. Plain segment sums accumulate in float32 and
round once to the data's dtype (``index_add_`` on a float32 buffer; on CUDA
its atomics make the summation order, and so the last bits, vary run to
run). Each op is a ``torch.autograd.Function`` whose backward is the
transpose the JAX package defines:

  * ``gather_senders``: ``x[senders]``; backward a sorted segment sum over
    the sender-sorted stream (``ct[sender_perm]`` summed by
    ``senders_sorted``), on kernel K5 (``ops.hopper_segment``) when the
    stream is declared aligned on the cuda backend;
  * ``gather_receivers``: ``x[receivers]``; backward a sorted segment sum.
    On a stream declared aligned on the cuda backend the forward is kernel
    K6 (``ops.hopper_gather``) and the backward K5 over the receiver
    stream;
  * ``segment_sum_sorted``: backward a sorted gather;
  * ``segment_sum_masked``: the masked sum of ``aggregate_edges`` on an
    aligned stream, forward on K5; backward ``mask * ct[ids]``;
  * ``segment_sum_weighted``: ``aggregate_edges_weighted`` on an aligned
    stream, forward on K7; backward the JAX package's ``_sswp_bwd``
    (``d_msgs = ct[ids] * w * mask``, ``d_w = <ct[ids], msgs> * mask``).

The sender and receiver backward passes and ``segment_sum_weighted`` run
on streams of the aligned layout, whose last segment is the pad sink: they
pass ``pad_sink=True`` (``ops.hopper_segment``), so the pad tail of a
Loader batch is not walked; ``segment_sum_masked`` does when its caller
declares it.

``segment_sum`` / ``segment_mean`` / ``segment_max`` over ids in any order
(the BSMS pools, the per-graph pools ``graph_pool`` / ``graph_broadcast``
of poolMGN and MGNv2) stay plain ops with PyTorch's autograd: the JAX
package leaves them to XLA. ``segment_pool_sum`` is the same sum taken in
sorted order through a host-built permutation (the BSMS sorted pools):
forward on kernel K5 with the permutation as its ``rows`` (its plain
version on CPU tensors or the torch backend), backward a plain gather.
"""

from __future__ import annotations

from typing import Optional

import torch

from aero_gnn_tpu_torch.ops import hopper_gather as HG
from aero_gnn_tpu_torch.ops import hopper_segment as HS


def gather(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather ``values[indices]``: [N, D] -> [E, D]."""
    return values.index_select(0, indices)


def _backend() -> str:
    from aero_gnn_tpu_torch import ops as _ops

    return _ops.backend()


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked segment sum over ids in any order: [E, D] -> [N, D], zero rows
    for empty segments; fp32 accumulation, one rounding."""
    if mask is not None:
        data = data * mask.to(data.dtype).reshape(
            (-1,) + (1,) * (data.dim() - 1))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=torch.float32, device=data.device)
    return out.index_add(0, segment_ids, data.float()).to(data.dtype)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, *,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked segment mean; empty segments give zeros (scatter_mean)."""
    summed = segment_sum(data, segment_ids, num_segments, mask=mask)
    ones = (torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
            if mask is None else mask)
    counts = segment_sum(ones, segment_ids, num_segments)
    return summed / torch.clamp(counts, min=1.0)[:, None]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked segment max over [E, D]: masked rows count as the dtype's
    finfo.min (so a segment of masked rows only gives finfo.min, as in the
    JAX package), empty segments give 0. Gradient to the maximal rows,
    shared evenly among ties."""
    if mask is not None:
        data = torch.where(mask[:, None] > 0, data,
                           torch.finfo(data.dtype).min)
    out = torch.full((num_segments, data.shape[1]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(0, segment_ids.long()[:, None].expand_as(data),
                             data, "amax", include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def graph_pool(node_values: torch.Tensor, node_graph: torch.Tensor,
               num_graphs: int, *, method: str = "mean",
               node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-graph pooling over the batch vector, [N, D] -> [G, D]: 'mean',
    'add' / 'sum' or 'max' of the real nodes; ValueError on any other
    method. Plain ops, as the JAX package leaves them to XLA."""
    if method == "mean":
        return segment_mean(node_values, node_graph, num_graphs,
                            mask=node_mask)
    if method in ("add", "sum"):
        return segment_sum(node_values, node_graph, num_graphs,
                           mask=node_mask)
    if method == "max":
        return segment_max(node_values, node_graph, num_graphs,
                           mask=node_mask)
    raise ValueError(f"Unsupported global pooling method: {method}")


def graph_broadcast(graph_values: torch.Tensor,
                    node_graph: torch.Tensor) -> torch.Tensor:
    """Per-graph rows back to their nodes: [G, D] -> [N, D]."""
    return gather(graph_values, node_graph)


class _GatherSenders(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, senders, sender_perm, senders_sorted, use_kernel):
        ctx.save_for_backward(sender_perm, senders_sorted)
        ctx.num_nodes = x.shape[0]
        ctx.use_kernel = use_kernel
        return gather(x, senders)

    @staticmethod
    def backward(ctx, ct):
        sender_perm, senders_sorted = ctx.saved_tensors
        ct = ct.contiguous()
        if ctx.use_kernel:
            # K5 reads ct[sender_perm[i]] itself: no [E, h] permuted copy
            dx = HS.segment_sum(ct, senders_sorted, ctx.num_nodes,
                                rows=sender_perm, pad_sink=True)
        else:
            dx = HS.segment_sum_ref(gather(ct, sender_perm), senders_sorted,
                                    ctx.num_nodes)
        return dx, None, None, None, None


def gather_senders(x: torch.Tensor, senders: torch.Tensor,
                   sender_perm: Optional[torch.Tensor] = None,
                   senders_sorted: Optional[torch.Tensor] = None,
                   aligned: bool = False) -> torch.Tensor:
    """``x[senders]`` whose backward is a sorted segment sum over the
    sender-sorted stream (plain autograd of the gather without it).
    ``aligned`` declares the graph block-aligned and, on the cuda backend,
    routes the backward to kernel K5. The JAX package leaves the forward
    gather to XLA, so the port leaves it to ``index_select``."""
    if sender_perm is None or senders_sorted is None:
        return gather(x, senders)
    return _GatherSenders.apply(x, senders, sender_perm, senders_sorted,
                                aligned and _backend() == "cuda")


class _GatherReceivers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, receivers, use_kernel):
        ctx.save_for_backward(receivers)
        ctx.num_nodes = x.shape[0]
        ctx.use_kernel = use_kernel
        if use_kernel:
            return HG.gather_rows(x.contiguous(), receivers)
        return gather(x, receivers)

    @staticmethod
    def backward(ctx, ct):
        (receivers,) = ctx.saved_tensors
        if ctx.use_kernel:
            # K5 over the receiver stream with a mask of ones, as the JAX
            # package's _grp_bwd; the sink's rows are pad rows whose
            # cotangent is zero (they reach the nodes only through the
            # masked aggregation), so pad_sink skips them exactly
            dx = HS.segment_sum(ct.contiguous(), receivers, ctx.num_nodes,
                                pad_sink=True)
        else:
            dx = HS.segment_sum_ref(ct, receivers, ctx.num_nodes)
        return dx, None, None


def gather_receivers(x: torch.Tensor, receivers: torch.Tensor,
                     aligned: bool = False) -> torch.Tensor:
    """``x[receivers]`` (ascending ids) with a sorted segment-sum backward.
    ``aligned`` declares the stream block-aligned (build_graph_batch
    align_edges=True) and, on the cuda backend, routes the forward to
    kernel K6 (``ops.hopper_gather``) and the backward to kernel K5 (their
    plain versions on CPU tensors)."""
    return _GatherReceivers.apply(x, receivers,
                                  aligned and _backend() == "cuda")


class _SegmentSumSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return HS.segment_sum_ref(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, ct):
        (segment_ids,) = ctx.saved_tensors
        return gather(ct, segment_ids), None, None


def segment_sum_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """[E, D] -> [N, D] sum over rows with equal (ascending) ids; backward
    a sorted gather."""
    return _SegmentSumSorted.apply(data, segment_ids, num_segments)


class _SegmentSumMasked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, mask, num_segments, pad_sink):
        ctx.save_for_backward(segment_ids, mask)
        return HS.segment_sum(data, segment_ids, num_segments, mask=mask,
                              pad_sink=pad_sink)

    @staticmethod
    def backward(ctx, ct):
        segment_ids, mask = ctx.saved_tensors
        d = gather(ct, segment_ids) * mask[:, None].to(ct.dtype)
        return d, None, None, None, None


def segment_sum_masked(data: torch.Tensor, segment_ids: torch.Tensor,
                       mask: torch.Tensor, num_segments: int, *,
                       pad_sink: bool = False) -> torch.Tensor:
    """``out[n] = sum_{ids[i] = n} mask[i] * data[i]`` on kernel K5 (CUDA
    tensors) or its plain version (CPU tensors); ``mask`` is cast to the
    data's dtype. ``pad_sink`` (``ops.hopper_segment``) declares every row
    keyed by the last segment masked: K5 skips those rows and writes that
    segment as 0, which is then the exact sum."""
    return _SegmentSumMasked.apply(data.contiguous(), segment_ids,
                                   mask.to(data.dtype).contiguous(),
                                   num_segments, pad_sink)


class _SegmentSumWeighted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, weights, segment_ids, mask, rows, num_segments):
        ctx.save_for_backward(data, weights, segment_ids, mask, rows)
        return HS.segment_sum_weighted(data, segment_ids, weights,
                                       num_segments, mask=mask, rows=rows,
                                       pad_sink=True)

    @staticmethod
    def backward(ctx, ct):
        data, weights, segment_ids, mask, rows = ctx.saved_tensors
        ctg = gather(ct, segment_ids)
        d_rows = ctg * weights.float()[:, None]
        if mask is not None:
            d_rows = d_rows * mask.float()[:, None]
        msgs = data if rows is None else gather(data, rows)
        d_w = (ctg.float() * msgs.float()).sum(1)
        if mask is not None:
            d_w = d_w * mask.float()
        d_rows = d_rows.to(ctg.dtype)
        d_data = d_rows if rows is None else torch.zeros_like(
            data).index_add(0, rows, d_rows)
        return d_data, d_w.to(weights.dtype), None, None, None, None


def segment_sum_weighted(data: torch.Tensor, weights: torch.Tensor,
                         segment_ids: torch.Tensor, num_segments: int, *,
                         mask: Optional[torch.Tensor] = None,
                         rows: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``out[n] = sum_{ids[i] = n} mask[i] * w[i] * data[rows[i]]``
    (ascending ids of an aligned stream; ``rows`` defaults to i) on kernel
    K7 (CUDA tensors) or its plain version (CPU tensors); differentiable in
    ``data`` and ``weights`` with the JAX package's ``_sswp_bwd`` (and the
    scatter of the gather's transpose through ``rows``)."""
    return _SegmentSumWeighted.apply(
        data.contiguous(), weights.float().contiguous(), segment_ids,
        None if mask is None else mask.to(data.dtype).contiguous(),
        None if rows is None else rows.contiguous(), num_segments)


class _SegmentPoolSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg_ids, perm, seg_sorted, num_segments,
                use_kernel):
        ctx.save_for_backward(seg_ids)
        if not use_kernel:
            return HS.segment_sum_ref(data, seg_sorted, num_segments,
                                      rows=perm)
        # K5 reads data[perm[i]] itself; a 1-D operand is one column
        out = HS.segment_sum(data.reshape(data.shape[0], -1).contiguous(),
                             seg_sorted, num_segments, rows=perm)
        return out.reshape((num_segments,) + tuple(data.shape[1:]))

    @staticmethod
    def backward(ctx, ct):
        # the transpose of sum-pooling is the unpool broadcast
        (seg_ids,) = ctx.saved_tensors
        return gather(ct, seg_ids), None, None, None, None, None


def segment_pool_sum(data: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int, *, perm: torch.Tensor,
                     seg_sorted: torch.Tensor) -> torch.Tensor:
    """Segment sum over ``seg_ids`` in any order through the host-built
    stable sort ``perm`` (``seg_sorted = seg_ids[perm]``; HierarchyLevel
    carries both, ``graph.hierarchy.with_pool_perms``): the sorted sum of
    ``data[perm]`` by ``seg_sorted``, [R, *] -> [num_segments, *], with the
    plain gather ``ct[seg_ids]`` as its backward. ``perm`` / ``seg_sorted``
    may be a prefix of the sort: the caller declares the rows past it zero
    (the BSMS pools' pad tails). On the cuda backend a
    CUDA tensor takes kernel K5 (``rows = perm``: no permuted copy of the
    data; deterministic, where ``segment_sum``'s ``index_add_`` is not),
    else the plain version. No pad sink: a pool's ids are not the aligned
    layout's."""
    return _SegmentPoolSum.apply(data, seg_ids, perm, seg_sorted,
                                 num_segments, _backend() == "cuda")


def degree(segment_ids: torch.Tensor, num_segments: int, *,
           mask: Optional[torch.Tensor] = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-segment counts (in-degree when fed receivers). [E] -> [N]."""
    ones = torch.ones(segment_ids.shape[0], dtype=dtype,
                      device=segment_ids.device)
    if mask is not None:
        ones = ones * mask.to(dtype)
    return HS.segment_sum_ref(ones, segment_ids, num_segments)
