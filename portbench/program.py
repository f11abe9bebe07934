"""Arithmetic the metric readers of the program's own spans and counters
share. The port records them in ``aero_gnn_tpu_torch.utils.profiling``
(spans only while a torch profiler runs, so a traced run's registry holds
the profiled steps or requests; counters always). A reader returns None
where the program under test has no such registry, as before the port had
one, or where the registry holds nothing to read: it never raises for
that.

Times are means per profiled tick: an ``aero.step`` span (training) or an
``aero.engine.predict`` span (serving). A span's self time is its duration
less its children's."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Iterable, Optional

TICK = {"train": "aero.step", "serve": "aero.engine.predict"}
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")


def _registry():
    try:
        from aero_gnn_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("spans", "counters")):
        return None
    return profiling


def _spans():
    reg = _registry()
    return None if reg is None else reg.spans()


def _ticks(view, spans) -> int:
    return sum(s.name == TICK[view.kind] for s in spans)


def span_ms(view, names: Iterable[str], less: Iterable[str] = ()
            ) -> Optional[float]:
    """Mean ms per tick of the spans named ``names``, less those named
    ``less``; None without a tick or without any span of ``names``."""
    spans = _spans()
    if not spans:
        return None
    names, less = set(names), set(less)
    ticks = _ticks(view, spans)
    if not ticks or not any(s.name in names for s in spans):
        return None
    ns = sum((s.end_ns - s.start_ns) * ((s.name in names)
                                         - (s.name in less))
             for s in spans)
    return ns * 1e-6 / ticks


def self_ms(view, name: str) -> Optional[float]:
    """Mean ms per tick of the self time of the spans named ``name``."""
    spans = _spans()
    if not spans:
        return None
    ticks = _ticks(view, spans)
    own = [s for s in spans if s.name == name]
    if not ticks or not own:
        return None
    children = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            children[s.parent] += s.end_ns - s.start_ns
    ns = sum(s.end_ns - s.start_ns - children[s.id] for s in own)
    return ns * 1e-6 / ticks


def counter_ratio(num: str, den: str) -> Optional[float]:
    """counters()[num] / counters()[den] over the run (the counters count
    from the process's start, set-up included)."""
    reg = _registry()
    if reg is None:
        return None
    c = reg.counters()
    if not c.get(den):
        return None
    return c.get(num, 0) / c[den]


def launches_per_step(view) -> Optional[float]:
    """The CUDA launch calls (runtime or driver API) of the trace made
    inside an ``aero.step`` range, on any thread (the backward launches
    from autograd's), over the number of such ranges; None without a
    trace, a range or any launch (the CPU)."""
    t = view.trace
    if t is None:
        return None
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in t.host
                   if e["name"] == TICK["train"])
    starts = [e["ts"] for e in t.launch.values() if LAUNCH.match(e["name"])]
    if not steps or not starts:
        return None
    inside = 0
    for ts in starts:
        i = bisect.bisect_right(steps, (ts, float("inf")))
        inside += any(a <= ts <= b for a, b in steps[max(0, i - 1):i])
    return inside / len(steps)
