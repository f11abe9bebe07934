"""serve_ms: the mean latency of all requests of the window, from the
Loader's construction to the denormalised predictions on the host
(host clock)."""


def read(view):
    if view.kind != "serve" or not view.latencies_s:
        return None
    return 1e3 * sum(view.latencies_s) / len(view.latencies_s)
