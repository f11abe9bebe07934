"""graph_build_ms.train: the self time of the port's ``aero.graph.build``
span (the Loader's join and ``graph/padded.build_graph_batch``: receiver
sort, block alignment, sender argsort, padding; not its copies to the
device), mean per profiled step."""

from portbench.program import self_ms


def read(view):
    return self_ms(view, "aero.graph.build") if view.kind == "train" else None
