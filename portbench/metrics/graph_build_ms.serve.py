"""graph_build_ms.serve: the self time of the port's ``aero.graph.build``
span (the request's graph join and build, not its copies to the device),
mean per profiled request."""

from portbench.program import self_ms


def read(view):
    return self_ms(view, "aero.graph.build") if view.kind == "serve" else None
