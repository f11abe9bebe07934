"""Profiling and throughput instrumentation (counterpart of
aero_gnn_tpu.utils.profiling).

  * ``trace(logdir)``: a torch.profiler trace (host and, on a CUDA machine,
    device activity) written as a Chrome trace into ``logdir``;
  * ``annotate(name)``: a named region in the profiler's timeline;
  * ``Throughput``: per-step edges/s, nodes/s, steps/s;
  * ``device_memory_stats``: the CUDA caching allocator's figures under the
    names JAX's ``device.memory_stats()`` uses.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from aero_gnn_tpu_torch.device import DeviceLike


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


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


class Throughput:
    """Rolling throughput meter for the train loop.

    >>> meter = Throughput(edges_per_step=E, nodes_per_step=N)
    >>> for batch in loader: step(...); meter.tick()
    >>> meter.summary()  # {'steps_per_s': ..., 'edges_per_s': ...}
    """

    def __init__(self, *, edges_per_step: int = 0, nodes_per_step: int = 0,
                 window: int = 50):
        self.edges_per_step = edges_per_step
        self.nodes_per_step = nodes_per_step
        self.window = window
        self._times = []
        self.total_steps = 0

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        self.total_steps += 1
        if len(self._times) > self.window:
            self._times.pop(0)

    def summary(self) -> Dict[str, float]:
        if len(self._times) < 2:
            return {"steps_per_s": 0.0, "edges_per_s": 0.0, "nodes_per_s": 0.0}
        dt = (self._times[-1] - self._times[0]) / (len(self._times) - 1)
        return {
            "steps_per_s": 1.0 / dt,
            "edges_per_s": self.edges_per_step / dt,
            "nodes_per_s": self.nodes_per_step / dt,
        }


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
