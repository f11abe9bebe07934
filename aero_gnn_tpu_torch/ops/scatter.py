"""Gather / segment primitives with the JAX package's custom VJPs
(counterpart of aero_gnn_tpu.ops.scatter).

Shape-static and mask-aware: pad edges/nodes contribute exact zeros and
empty segments are zero rows. Segment sums accumulate in float32 and round
once to the data's dtype. On the cuda backend every float sum adds its rows
in an order fixed by the graph: kernel K5 (``ops.hopper_segment``) over
ascending ids, or over a stable sort of the ids built on the host once (a
permutation read as K5's ``rows``); on CPU tensors the wrapper runs its
plain version. The torch backend is the plain reference: ``index_add_`` on
a float32 buffer, whose CUDA atomics add in whatever order they land. Each
op is a ``torch.autograd.Function`` whose backward is the transpose the JAX
package defines:

  * ``gather_senders``: ``x[senders]``; backward a sorted segment sum over
    the sender-sorted stream (``ct[sender_perm]`` summed by
    ``senders_sorted``), on K5 on the cuda backend;
  * ``gather_receivers``: ``x[receivers]`` (ascending ids); backward a
    sorted segment sum, on K5 on the cuda backend. On a stream declared
    aligned on the cuda backend the forward is kernel K6
    (``ops.hopper_gather``);
  * ``segment_sum_sorted``: forward on K5 on the cuda backend; backward a
    sorted gather;
  * ``segment_sum_masked``: the masked sum of ``aggregate_edges``, forward
    on K5 on the cuda backend; backward ``mask * ct[ids]``;
  * ``segment_sum_weighted``: ``aggregate_edges_weighted`` on an aligned
    stream, forward on K7; backward the JAX package's ``_sswp_bwd``
    (``d_msgs = ct[ids] * w * mask``, ``d_w = <ct[ids], msgs> * mask``);
  * ``segment_pool_sum``: a sum over ids in any order through their
    host-built stable sort, forward on K5 on the cuda backend; backward a
    plain gather;
  * ``gather_chunked``: ``x[ids]`` whose backward sums each segment's
    rows on K5 in two passes through a host plan that splits long runs
    (``graph.padded.chunk_plan``): the BSMS unpool, ``graph_broadcast``;
    ``graph_pool``'s sums take the same plan (a GraphBatch's
    ``graph_chunks``) for poolMGN and MGNv2.

``pad_sink=True`` (``ops.hopper_segment``) declares every row keyed by the
last segment a pad row adding zero: K5 skips those rows and writes that
segment as 0. The streams of ``graph.padded`` (GraphBatch, HierarchyLevel)
declare it, so the pad tail of a Loader batch is not walked; a stream
whose last id can be a real row does not.

``segment_sum`` / ``segment_mean`` over ids in any order without a sort
are the plain reference (the torch backend, CPU callers). ``degree`` and
``segment_max`` keep their plain ops on every backend: sums of 0/1 values
in float32 are exact integers in any order, and a maximum is the same
whatever the order.
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
    shared evenly among ties. The plain op on every backend: a maximum,
    and its backward's 0/1 tie counts, are the same in any order."""
    if mask is not None:
        data = torch.where(mask[:, None] > 0, data,
                           torch.finfo(data.dtype).min)
    out = torch.full((num_segments, data.shape[1]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(0, segment_ids.long()[:, None].expand_as(data),
                             data, "amax", include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


class _ChunkedSum(torch.autograd.Function):
    """[R, D] -> [S, D] segment sums through a chunk plan; backward the
    gather ``ct[ids]``."""

    @staticmethod
    def forward(ctx, data, ids, chunks, num_segments):
        ctx.save_for_backward(ids)
        return _chunked_sum(data, chunks, num_segments)

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        return gather(ct, ids), None, None, None


class _ChunkedGather(torch.autograd.Function):
    """[S, D] -> [R, D] ``values[ids]``; backward the chunked segment sum
    of the cotangent."""

    @staticmethod
    def forward(ctx, values, ids, chunks):
        ctx.chunks = chunks
        ctx.num_segments = values.shape[0]
        return gather(values, ids)

    @staticmethod
    def backward(ctx, ct):
        return _chunked_sum(ct, ctx.chunks, ctx.num_segments), None, None


def _chunked_sum(data: torch.Tensor, chunks, num_segments: int):
    """The segment sum of ``data``'s rows in two K5 passes over the host
    plan ``chunks = (perm, chunk, chunk_seg)`` (``graph.padded.chunk_plan``:
    no run longer than a chunk, where K5 gives each run to one warp's
    serial chain). Accumulated in float32, rounded once."""
    perm, chunk, chunk_seg = chunks
    part = HS.segment_sum(data.float().contiguous(), chunk,
                          chunk_seg.shape[0], rows=perm)
    return HS.segment_sum(part, chunk_seg, num_segments).to(data.dtype)


def _chunked(x: torch.Tensor, chunks) -> bool:
    """Whether a chunked op runs its sums on K5: the cuda backend and a
    plan; a CUDA tensor without one raises."""
    if _backend() != "cuda":
        return False
    if chunks is None:
        if x.is_cuda:
            raise ValueError("a chunked segment sum on the cuda backend "
                             "needs its host plan (graph.padded."
                             "chunk_plan)")
        return False
    return True


def gather_chunked(values: torch.Tensor, ids: torch.Tensor,
                   chunks) -> torch.Tensor:
    """``values[ids]`` (ids in any order; [S, D] -> [R, D]) whose backward
    sums each segment's rows through ``chunks``, the host plan of ``ids``
    (``graph.padded.chunk_plan``), on K5 on the cuda backend; else the
    plain gather."""
    if not _chunked(values, chunks):
        return gather(values, ids)
    return _ChunkedGather.apply(values, ids, chunks)


def graph_pool(node_values: torch.Tensor, node_graph: torch.Tensor,
               num_graphs: int, *, method: str = "mean",
               node_mask: Optional[torch.Tensor] = None,
               chunks=None) -> torch.Tensor:
    """Per-graph pooling over the batch vector, [N, D] -> [G, D]: 'mean',
    'add' / 'sum' or 'max' of the real nodes; ValueError on any other
    method. ``chunks`` is a GraphBatch's ``graph_chunks``: on the cuda
    backend the sums run on K5 through it (the counts of 'mean' stay
    ``degree``'s exact integers); else plain ops, as the JAX package
    leaves them to XLA."""
    if method not in ("mean", "add", "sum", "max"):
        raise ValueError(f"Unsupported global pooling method: {method}")
    if method == "max":
        return segment_max(node_values, node_graph, num_graphs,
                           mask=node_mask)
    if not _chunked(node_values, chunks):
        if method == "mean":
            return segment_mean(node_values, node_graph, num_graphs,
                                mask=node_mask)
        return segment_sum(node_values, node_graph, num_graphs,
                           mask=node_mask)
    data = node_values
    if node_mask is not None:
        data = data * node_mask.to(data.dtype)[:, None]
    summed = _ChunkedSum.apply(data, node_graph, chunks, num_graphs)
    if method != "mean":
        return summed
    counts = degree(node_graph, num_graphs, mask=node_mask,
                    dtype=node_values.dtype)
    return summed / torch.clamp(counts, min=1.0)[:, None]


def graph_broadcast(graph_values: torch.Tensor, node_graph: torch.Tensor,
                    *, chunks=None) -> torch.Tensor:
    """Per-graph rows back to their nodes: [G, D] -> [N, D],
    ``gather_chunked`` over ``chunks`` (a GraphBatch's ``graph_chunks``)."""
    return gather_chunked(graph_values, node_graph, chunks)


class _GatherSenders(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, senders, sender_perm, senders_sorted, use_kernel,
                pad_sink):
        ctx.save_for_backward(sender_perm, senders_sorted)
        ctx.num_nodes = x.shape[0]
        ctx.use_kernel = use_kernel
        ctx.pad_sink = pad_sink
        return gather(x, senders)

    @staticmethod
    def backward(ctx, ct):
        sender_perm, senders_sorted = ctx.saved_tensors
        ct = ct.contiguous()
        if ctx.use_kernel:
            # K5 reads ct[sender_perm[i]] itself: no [E, h] permuted copy
            dx = HS.segment_sum(ct, senders_sorted, ctx.num_nodes,
                                rows=sender_perm, pad_sink=ctx.pad_sink)
        else:
            dx = HS.segment_sum_ref(gather(ct, sender_perm), senders_sorted,
                                    ctx.num_nodes)
        return dx, None, None, None, None, None


def gather_senders(x: torch.Tensor, senders: torch.Tensor,
                   sender_perm: Optional[torch.Tensor] = None,
                   senders_sorted: Optional[torch.Tensor] = None,
                   aligned: bool = False, *,
                   pad_sink: Optional[bool] = None) -> torch.Tensor:
    """``x[senders]`` (ids in any order) whose backward is a sorted segment
    sum over the host-built stable sort ``senders_sorted =
    senders[sender_perm]``, on kernel K5 on the cuda backend. ``pad_sink``
    (default ``aligned``) declares the stream's rows keyed by the last row
    of ``x`` pad rows with a zero cotangent, which K5 then skips.
    ``sender_perm`` / ``senders_sorted`` may be a prefix of the sort: the
    caller declares the cotangent of the rows past it zero. Without a sort
    the plain gather, which the cuda backend refuses on a CUDA tensor. The
    JAX package leaves the forward gather to XLA, so the port leaves it to
    ``index_select``."""
    use_kernel = _backend() == "cuda"
    if sender_perm is None or senders_sorted is None:
        if use_kernel and x.is_cuda:
            raise ValueError("gather_senders on the cuda backend needs the "
                             "ids' sort (sender_perm, senders_sorted)")
        return gather(x, senders)
    return _GatherSenders.apply(x, senders, sender_perm, senders_sorted,
                                use_kernel,
                                aligned if pad_sink is None else pad_sink)


class _GatherReceivers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, receivers, use_k6, use_k5, pad_sink):
        ctx.save_for_backward(receivers)
        ctx.num_nodes = x.shape[0]
        ctx.use_k5 = use_k5
        ctx.pad_sink = pad_sink
        if use_k6:
            return HG.gather_rows(x.contiguous(), receivers)
        return gather(x, receivers)

    @staticmethod
    def backward(ctx, ct):
        (receivers,) = ctx.saved_tensors
        if ctx.use_k5:
            # K5 over the receiver stream with a mask of ones, as the JAX
            # package's _grp_bwd; with the sink declared its rows are pad
            # rows whose cotangent is zero (they reach the nodes only
            # through the masked aggregation), so K5 skips them exactly
            dx = HS.segment_sum(ct.contiguous(), receivers, ctx.num_nodes,
                                pad_sink=ctx.pad_sink)
        else:
            dx = HS.segment_sum_ref(ct, receivers, ctx.num_nodes)
        return dx, None, None, None, None


def gather_receivers(x: torch.Tensor, receivers: torch.Tensor,
                     aligned: bool = False, *,
                     pad_sink: Optional[bool] = None) -> torch.Tensor:
    """``x[receivers]`` (ascending ids) with a sorted segment-sum backward,
    on kernel K5 on the cuda backend (its plain version on CPU tensors).
    ``aligned`` declares the stream block-aligned (build_graph_batch
    align_edges=True) and, on the cuda backend, routes the forward to
    kernel K6 (``ops.hopper_gather``). ``pad_sink`` (default ``aligned``)
    declares the rows keyed by the last row of ``x`` pad rows with a zero
    cotangent."""
    use_kernel = _backend() == "cuda"
    return _GatherReceivers.apply(x, receivers, aligned and use_kernel,
                                  use_kernel,
                                  aligned if pad_sink is None else pad_sink)


class _SegmentSumSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, use_kernel, pad_sink):
        ctx.save_for_backward(segment_ids)
        if use_kernel:
            return HS.segment_sum(data.contiguous(), segment_ids,
                                  num_segments, pad_sink=pad_sink)
        return HS.segment_sum_ref(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, ct):
        (segment_ids,) = ctx.saved_tensors
        return gather(ct, segment_ids), None, None, None, None


def segment_sum_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, *,
                       pad_sink: bool = False) -> torch.Tensor:
    """[E, D] -> [N, D] sum over rows with equal (ascending) ids, on kernel
    K5 on the cuda backend (``pad_sink`` as in ``segment_sum_masked``);
    backward a sorted gather."""
    return _SegmentSumSorted.apply(data, segment_ids, num_segments,
                                   _backend() == "cuda", pad_sink)


class _SegmentSumMasked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, mask, num_segments, pad_sink,
                use_kernel):
        ctx.save_for_backward(segment_ids, mask)
        if not use_kernel:
            return HS.segment_sum_ref(data, segment_ids, num_segments,
                                      mask=mask)
        return HS.segment_sum(data, segment_ids, num_segments, mask=mask,
                              pad_sink=pad_sink)

    @staticmethod
    def backward(ctx, ct):
        segment_ids, mask = ctx.saved_tensors
        d = gather(ct, segment_ids) * mask[:, None].to(ct.dtype)
        return d, None, None, None, None, None


def segment_sum_masked(data: torch.Tensor, segment_ids: torch.Tensor,
                       mask: torch.Tensor, num_segments: int, *,
                       pad_sink: bool = False) -> torch.Tensor:
    """``out[n] = sum_{ids[i] = n} mask[i] * data[i]`` (ascending ids) on
    kernel K5 on the cuda backend (its plain version on CPU tensors or the
    torch backend); ``mask`` is cast to the data's dtype. ``pad_sink``
    (``ops.hopper_segment``) declares every row keyed by the last segment
    masked: K5 skips those rows and writes that segment as 0, which is
    then the exact sum."""
    return _SegmentSumMasked.apply(data.contiguous(), segment_ids,
                                   mask.to(data.dtype).contiguous(),
                                   num_segments, pad_sink,
                                   _backend() == "cuda")


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
        # the scatter through ``rows`` adds in the atomics' order on CUDA;
        # no card path reaches it: the model's only caller, the BSMS WEC,
        # runs K7 inside its own autograd Functions (models/bsms.py _WecA /
        # _WecAt), which record no graph, so this backward runs only when
        # a caller differentiates aggregate_edges_weighted itself
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
                use_kernel, pad_sink):
        ctx.save_for_backward(seg_ids)
        if not use_kernel:
            return HS.segment_sum_ref(data, seg_sorted, num_segments,
                                      rows=perm)
        # K5 reads data[perm[i]] itself; a 1-D operand is one column
        out = HS.segment_sum(data.reshape(data.shape[0], -1).contiguous(),
                             seg_sorted, num_segments, rows=perm,
                             pad_sink=pad_sink)
        return out.reshape((num_segments,) + tuple(data.shape[1:]))

    @staticmethod
    def backward(ctx, ct):
        # the transpose of sum-pooling is the unpool broadcast
        (seg_ids,) = ctx.saved_tensors
        return gather(ct, seg_ids), None, None, None, None, None, None


def segment_pool_sum(data: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int, *, perm: torch.Tensor,
                     seg_sorted: torch.Tensor,
                     pad_sink: bool = False) -> torch.Tensor:
    """Segment sum over ``seg_ids`` in any order through the host-built
    stable sort ``perm`` (``seg_sorted = seg_ids[perm]``; HierarchyLevel
    carries both, ``graph.hierarchy._pool_fields``): the sorted sum of
    ``data[perm]`` by ``seg_sorted``, [R, *] -> [num_segments, *], with the
    plain gather ``ct[seg_ids]`` as its backward. ``perm`` / ``seg_sorted``
    may be a prefix of the sort: the caller declares the rows past it zero
    (the BSMS pools' pad tails). On the cuda backend it runs on kernel K5
    (``rows = perm``: no permuted copy of the data), which adds in the
    sort's order where ``segment_sum``'s ``index_add_`` adds in the
    atomics'; else the plain version. ``pad_sink`` declares the rows keyed
    by the last segment zero (K5 skips them; see ``segment_sum_masked``)."""
    return _SegmentPoolSum.apply(data, seg_ids, perm, seg_sorted,
                                 num_segments, _backend() == "cuda",
                                 pad_sink)


def degree(segment_ids: torch.Tensor, num_segments: int, *,
           mask: Optional[torch.Tensor] = None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-segment counts (in-degree when fed receivers). [E] -> [N]. The
    plain sum on every backend: 0/1 values (masks) sum to the same exact
    integers in float32 in any order, below 2**24."""
    ones = torch.ones(segment_ids.shape[0], dtype=dtype,
                      device=segment_ids.device)
    if mask is not None:
        ones = ones * mask.to(dtype)
    return HS.segment_sum_ref(ones, segment_ids, num_segments)
