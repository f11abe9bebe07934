"""Profiling instrumentation (counterpart of aero_gnn_tpu.utils.profiling):
the port's one registry of spans and counters, a trace context and the
device's memory figures.

  * ``trace(logdir)``: a torch.profiler trace (host and, on a CUDA machine,
    device activity) written as a Chrome trace into ``logdir``;
  * ``annotate(name)``: a span (below); ``spans()`` / ``clear()``;
  * ``count(name, n)``: a counter; ``counters()`` / ``reset_counters()``;
  * ``device_memory_stats``: the CUDA caching allocator's figures under the
    names JAX's ``device.memory_stats()`` uses.

A span records its name, its start and end in ``time.time_ns()``, its
thread and the span that encloses it on that thread, and only while a torch
profiler runs somewhere in the process (torch's process-wide flag): any
profiled window, ``trace(logdir)``'s too, collects spans with no switch of
its own. ``time.time_ns()`` is the clock of the profiler's Chrome trace (an
event's ``ts`` in microseconds plus the trace's ``baseTimeNanoseconds``),
so a span lines up with the device's kernels whichever thread records it.
On a thread the profiler covers, the span also opens a ``record_function``
range of its name, which the exported trace shows as a ``user_annotation``
event; torch's profiler records no range on a thread started while it runs,
so the registry, not the trace, is where every span is found. With no
profiler running a span is one flag read and a shared null context. The
registry keeps the newest ``SPAN_CAP`` spans.

Span names are ``aero.<layer>.<phase>`` (the Loader, graph, hierarchy,
step and engine phases); counters are always on: ``graph.nodes``,
``graph.node_rows``, ``graph.edges``, ``graph.edge_rows`` (real against
padded, per built batch) and ``launch.<kernel id>``
(``launch.K1`` ... ``launch.K10``, ``launch.K1-save``, ``launch.K9-fwd``,
``launch.K9-bwd``: launches of the hand-written kernels),
``hierarchy.levels_balanced`` (BSMS levels the block balance relabels,
``graph.hierarchy.align_hierarchy``) and ``hierarchy.realigned`` (Loader
batches over the PadSpec's aligned coarse-edge budget, aligned again with
per-batch sizes).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from aero_gnn_tpu_torch.device import DeviceLike

SPAN_CAP = 100_000


class Span(NamedTuple):
    """One finished span: ``parent`` is the ``id`` of the span that
    enclosed it on its thread (None at the top); times in ns of
    ``time.time_ns()``; ``thread`` the native thread id."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]


_spans: "collections.deque[Span]" = collections.deque(maxlen=SPAN_CAP)
_ids = itertools.count()
_open = threading.local()  # .stack: the thread's open spans
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()
_NULL = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "id", "parent", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self.range = None
        if torch._C._autograd._profiler_enabled():  # this thread is covered
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.stack.pop()
        _spans.append(Span(self.id, self.name, self.start, end,
                           threading.get_native_id(), self.parent))
        return False


def annotate(name: str):
    """``with annotate("aero.layer.phase"):`` records a span of the body
    while a torch profiler runs (module docstring); otherwise a shared null
    context. Close a span before a generator's ``yield``: spans nest by
    the thread's order of entry."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _OpenSpan(name)


def spans() -> List[Span]:
    """The registry's spans, oldest first (at most ``SPAN_CAP``)."""
    return list(_spans)


def clear() -> None:
    _spans.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter since the last ``reset_counters()``."""
    with _counts_lock:
        return dict(_counts)


def reset_counters() -> None:
    with _counts_lock:
        _counts.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with trace('profile_dir'): step(...)`` writes
    ``trace_<pid>_<ms>.json`` (Chrome trace format, viewable in Perfetto)
    into ``logdir``, also when the body raises. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def device_memory_stats(device: DeviceLike = None) -> Optional[Dict[str, int]]:
    """Memory figures of a CUDA device in bytes (the current one by
    default): ``bytes_in_use`` / ``peak_bytes_in_use`` (tensors allocated,
    now and at the peak since ``torch.cuda.reset_peak_memory_stats``),
    ``bytes_reserved`` / ``peak_bytes_reserved`` (held by the caching
    allocator), ``num_allocs`` and ``bytes_limit`` (the card's memory).
    None for the CPU, as JAX gives where a backend lacks stats."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": s.get("reserved_bytes.all.current", 0),
            "peak_bytes_reserved": s.get("reserved_bytes.all.peak", 0),
            "num_allocs": s.get("allocation.all.allocated", 0),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}
