"""Host spans the benchmark records around its calls into the port's
layers: the host clock's duration of each, and, for a traced run, a
``torch.profiler.record_function`` range named ``portbench.<name>`` so that
the device trace can say what the host was doing in an idle gap."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self):
        self.durations = defaultdict(list)
        self.annotate = False

    def reset(self):
        self.durations.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = (torch.profiler.record_function("portbench." + name)
               if self.annotate else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.durations[name].append(time.perf_counter() - t0)
