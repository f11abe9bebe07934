"""Structured metric logging (JSONL); the port's own copy of
aero_gnn_tpu.utils.logging.

One JSON object per line with a monotonic step and wall time; cheap enough
to call every epoch, greppable, and ingestible by any dashboard.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None, *, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {"step": step,
                               "time": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            print(line)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
