"""Differentiable collectives over a process group (the counterparts of the
``jax.lax`` collectives that JAX transposes by itself under ``shard_map``).

  * ``all_gather_tiled``: [n, ...] per rank -> [P * n, ...] in rank order
    (``jax.lax.all_gather(tiled=True)``); backward the reduce-scatter (sum)
    of the cotangent, all_gather's transpose;
  * ``all_to_all``: [P, ...] per rank, block q to rank q -> block q from
    rank q (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``); backward
    the reverse all_to_all, which is the same exchange;
  * ``all_reduce_sum``: ``jax.lax.psum``; backward the psum of the
    cotangent. Counts and losses call it on tensors without a gradient;
  * ``sum_gradients``: the parameters' gradients summed over the group by
    one all_reduce of one flat buffer, then scaled (the
    ``jax.lax.psum(grads, axis)`` / ``pmean`` after the backward).

The reduce-scatter is an all_to_all of the [P, n, ...] blocks and a sum,
so three collectives of ``torch.distributed`` carry everything:
``all_gather``, ``all_to_all_single`` and ``all_reduce``. gloo (torch 2.11)
takes CUDA tensors for all three, so ranks that share a card exchange the
card's tensors directly; the kernels run on the card either way. A
``Group`` without a process group (one process, nothing initialised) is a
group of one, where every collective is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Group:
    """A process group (None: a group of one) with this rank's place in
    it."""

    pg: Optional[object]
    size: int
    rank: int
    backend: str


def make_group(pg) -> Group:
    """The Group of process group ``pg`` (None: a group of one)."""
    if pg is None:
        return Group(None, 1, 0, "none")
    return Group(pg, dist.get_world_size(pg), dist.get_rank(pg),
                 str(dist.get_backend(pg)))


def gather_raw(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[n, ...] -> [P * n, ...], no autograd."""
    if group.pg is None:
        return x
    x = x.contiguous()
    out = x.new_empty((group.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather(list(out.chunk(group.size)), x, group=group.pg)
    return out


def all_to_all_raw(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[P, ...] -> [P, ...], block q exchanged with rank q; no autograd."""
    if group.pg is None:
        return x
    if x.shape[0] != group.size:
        raise ValueError(f"all_to_all of {x.shape[0]} blocks over a group "
                         f"of {group.size}")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group.pg)
    return out


def all_reduce_raw(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the group, in a new tensor; no autograd."""
    if group.pg is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group.pg)
    return out


def reduce_scatter_raw(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[P * n, ...] -> [n, ...]: this rank's block summed over the group;
    no autograd."""
    if group.pg is None:
        return x
    blocks = x.reshape((group.size, -1) + tuple(x.shape[1:]))
    return all_to_all_raw(blocks, group).sum(0)


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_raw(x, group)

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter_raw(ct, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_raw(x, group)

    @staticmethod
    def backward(ctx, ct):
        return all_to_all_raw(ct, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_raw(ct, ctx.group), None


def all_gather_tiled(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's [n, ...] concatenated in rank order; backward a
    reduce-scatter (sum)."""
    return _AllGatherTiled.apply(x, group)


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[P, ...]: block q goes to rank q, block q of the result came from
    rank q; backward the reverse exchange."""
    return _AllToAll.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the group (psum); backward the psum of the cotangent.
    A loss summed by it inside the differentiated function seeds every
    rank's backward with the sum of the seeds: take the local numerator
    over the global count instead (``parallel.spatial.shard_loss``)."""
    return _AllReduceSum.apply(x, group)


def sum_gradients(params: torch.nn.Module, group: Group,
                  scale: float = 1.0) -> None:
    """Every parameter's ``.grad`` summed over the group by one all_reduce
    of one flat fp32 buffer, times ``scale`` (1 / size: the mean). A
    parameter without a gradient contributes zeros and receives the sum."""
    if group.pg is None and scale == 1.0:
        return
    ps = list(params.parameters())
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1).float()
                      for p in ps])
    flat = all_reduce_raw(flat, group)
    if scale != 1.0:
        flat = flat * scale
    for p, g in zip(ps, flat.split([p.numel() for p in ps])):
        p.grad = g.view(p.shape).to(p.dtype)
