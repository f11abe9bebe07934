"""loader_ms.serve: the mean host time a request spends building its
Loader and taking its one batch."""

from portbench.readers import span_mean_ms


def read(view):
    return span_mean_ms(view, "loader") if view.kind == "serve" else None
