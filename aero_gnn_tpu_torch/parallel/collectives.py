"""Differentiable collectives over a process group (the counterparts of the
``jax.lax`` collectives that JAX transposes by itself under ``shard_map``).

  * ``all_gather_tiled``: [n, ...] per rank -> [P * n, ...] in rank order
    (``jax.lax.all_gather(tiled=True)``); backward the reduce-scatter (sum)
    of the cotangent, all_gather's transpose;
  * ``all_to_all``: [P, ...] per rank, block q to rank q -> block q from
    rank q (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``); backward
    the reverse all_to_all, which is the same exchange;
  * ``all_to_all_start`` -> ``Pending``, ``Pending.wait()``: the same
    exchange split into its issue and its wait, so that work which does not
    read the result runs while it is in flight (the async all-to-all that
    JAX's ``async_jit_options`` turns on, parallel/xla_flags.py). The
    backward is split the same way: the wait's backward starts the reverse
    exchange of the cotangent and the start's backward waits for it, so the
    backward of what ran between the two overlaps it too.
    ``AERO_GNN_ASYNC_COLLECTIVES`` (JAX's switch, "1" by default, read at
    call time) set to anything else makes the pair today's synchronous
    ``all_to_all``;
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
import os
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


def _blocks(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` contiguous, ValueError unless it holds one block per rank."""
    if x.shape[0] != group.size:
        raise ValueError(f"all_to_all of {x.shape[0]} blocks over a group "
                         f"of {group.size}")
    return x.contiguous()


def all_to_all_raw(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[P, ...] -> [P, ...], block q exchanged with rank q; no autograd."""
    if group.pg is None:
        return x
    x = _blocks(x, group)
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


def async_collectives() -> bool:
    """Whether ``all_to_all_start`` issues its exchange asynchronously
    (``AERO_GNN_ASYNC_COLLECTIVES``, "1" by default, as JAX's
    ``async_jit_options`` reads it)."""
    return os.environ.get("AERO_GNN_ASYNC_COLLECTIVES", "1") == "1"


class _Flight:
    """One exchange in flight: its work handle and the buffers it reads and
    writes, held until it has completed (the forward's, then the reverse
    exchange's in the backward)."""

    __slots__ = ("work", "send", "recv")

    def __init__(self):
        self.work = self.send = self.recv = None


def _launch(x: torch.Tensor, group: Group, flight: _Flight) -> torch.Tensor:
    """Issue the all_to_all of ``x`` with ``async_op=True``; returns the
    receive buffer, whose contents are defined once ``_finish`` ran. On
    NCCL the exchange runs on its own stream after the current stream's
    work; on gloo its copies of CUDA tensors run on gloo's own streams."""
    flight.send = _blocks(x, group)
    flight.recv = torch.empty_like(flight.send)
    flight.work = dist.all_to_all_single(flight.recv, flight.send,
                                         group=group.pg, async_op=True)
    return flight.recv


def _finish(flight: _Flight) -> torch.Tensor:
    """Wait for the exchange in ``flight`` and release its buffers; returns
    the received blocks. On NCCL the current stream waits, the host does
    not; on gloo the host waits for the exchange, and the current stream
    for its copies back to CUDA tensors."""
    flight.work.wait()
    out = flight.recv
    flight.work = flight.send = flight.recv = None
    return out


class _AllToAllStart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, flight):
        ctx.flight = flight
        return _launch(x, group, flight)

    @staticmethod
    def backward(ctx, ct):
        # ct is the buffer _AllToAllWait.backward's reverse exchange fills
        return _finish(ctx.flight), None, None


class _AllToAllWait(torch.autograd.Function):
    @staticmethod
    def forward(ctx, recv, group, flight):
        ctx.group, ctx.flight = group, flight
        return _finish(flight)

    @staticmethod
    def backward(ctx, ct):
        return _launch(ct, ctx.group, ctx.flight), None, None


class Pending:
    """An all_to_all issued by ``all_to_all_start``; ``wait()`` (once)
    returns the received [P, ...] blocks."""

    def __init__(self, recv: torch.Tensor, group: Group,
                 flight: Optional[_Flight]):
        self._recv, self._group, self._flight = recv, group, flight

    def wait(self) -> torch.Tensor:
        if self._flight is None:
            return self._recv
        return _AllToAllWait.apply(self._recv, self._group, self._flight)


def all_to_all_start(x: torch.Tensor, group: Group) -> Pending:
    """``all_to_all(x, group)`` issued now and read at ``Pending.wait()``:
    with ``async_collectives()`` the exchange is in flight in between, and
    in the backward the reverse exchange is in flight between the wait's
    backward and the start's (the autograd engine runs the backward of the
    work created between the two in that window). Without it, or on a
    group of one, the exchange has completed when this returns."""
    if group.pg is None or not async_collectives():
        return Pending(all_to_all(x, group), group, None)
    flight = _Flight()
    return Pending(_AllToAllStart.apply(x, group, flight), group, flight)


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
