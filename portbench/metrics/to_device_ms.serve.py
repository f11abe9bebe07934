"""to_device_ms.serve: the port's copies of a request's graph (and
hierarchy) to the device, the ``aero.graph.to_device`` and
``aero.hierarchy.to_device`` spans, mean per profiled request."""

from portbench.program import span_ms

NAMES = ("aero.graph.to_device", "aero.hierarchy.to_device")


def read(view):
    return span_ms(view, NAMES) if view.kind == "serve" else None
