"""serve_p95_ms: the 95th percentile of the latencies of all requests of
the window (host clock, linear interpolation between order statistics)."""

import numpy as np


def read(view):
    if view.kind != "serve" or not view.latencies_s:
        return None
    return 1e3 * float(np.percentile(view.latencies_s, 95))
