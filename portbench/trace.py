"""Reduce a ``torch.profiler`` Chrome trace of the profiled sub-window to
what the per-layer metrics read: the window (from the first to the last
``portbench.*`` span), the device's busy time (the union of kernel, copy
and memset intervals in it), the idle gaps named by the innermost
benchmark span the host was in at each one's middle, device time by kernel
name, and the device time of the kernels a function launched (kernels
matched to their launch by CUPTI's correlation id, the launch to the
host range of the function)."""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.host = [e for e in xs if e.get("cat") in HOST_CATS]
        spans = [e for e in self.host
                 if e["name"].startswith("portbench.")]
        if not spans:
            raise ValueError("the trace holds no portbench span")
        self.t0 = min(e["ts"] for e in spans)
        self.t1 = max(e["ts"] + e["dur"] for e in spans)
        self.spans = spans
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS
                       and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.launch = {e["args"]["correlation"]: e for e in xs
                       if e.get("cat") in LAUNCH_CATS
                       and "correlation" in e.get("args", {})}

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self) -> List[List[float]]:
        return _union([(max(e["ts"], self.t0),
                        min(e["ts"] + e["dur"], self.t1))
                       for e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def _span_at(self, t: float) -> str:
        inner = None
        for e in self.spans:
            if e["ts"] <= t < e["ts"] + e["dur"] and (
                    inner is None or e["dur"] < inner["dur"]):
                inner = e
        return inner["name"][len("portbench."):] if inner else "other"

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The ``top`` longest idle gaps: [the innermost benchmark span the
        host was in at the gap's middle, seconds]."""
        edges = [self.t0]
        for a, b in self._busy():
            edges += [a, b]
        edges.append(self.t1)
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self._span_at(t + d / 2), d * 1e-6]
                for d, t in gaps[:top]]

    def device_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        for e in self.device:
            by[e["name"][:160]] += e["dur"] * 1e-6
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _ranges(self, names: Iterable[str]) -> Dict[int, List[tuple]]:
        names = set(names)
        out: Dict[int, List[tuple]] = defaultdict(list)
        for e in self.host:
            if e["name"] in names:
                out[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
        for v in out.values():
            v.sort()
        return out

    @staticmethod
    def _inside(ranges: List[tuple], t: float) -> bool:
        i = bisect.bisect_right(ranges, (t, float("inf")))
        return any(a <= t <= b for a, b in ranges[:i])

    def function_device_s(self, ranges: Iterable[str],
                          kernels: Iterable[str],
                          exclude: Iterable[str] = ()) -> Optional[float]:
        """Device seconds of the kernels whose names match ``kernels``
        (regular expressions) and whose launch lies inside a host range
        named in ``ranges`` and outside one named in ``exclude`` (a
        recompute's forward nested in a backward); None when none is
        found."""
        inside, outside = self._ranges(ranges), self._ranges(exclude)
        pats = [re.compile(k) for k in kernels]
        total, found = 0.0, False
        for e in self.device:
            if e.get("cat") != "kernel" or not any(
                    p.search(e["name"]) for p in pats):
                continue
            lau = self.launch.get(e.get("args", {}).get("correlation"))
            if lau is None:
                continue
            tid, t = lau["tid"], lau["ts"]
            if self._inside(inside.get(tid, []), t) and not self._inside(
                    outside.get(tid, []), t):
                total += e["dur"] * 1e-6
                found = True
        return total if found else None
