"""hierarchy_ms.train: the Loader's per-batch hierarchy on the host, the
``aero.loader.hierarchy`` span (collation and alignment) less its copies
to the device (``aero.hierarchy.to_device``), mean per profiled step."""

from portbench.program import span_ms


def read(view):
    if view.kind != "train":
        return None
    return span_ms(view, ("aero.loader.hierarchy",),
                   less=("aero.hierarchy.to_device",))
