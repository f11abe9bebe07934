"""pad_ratio.serve: the edge rows the port's graph build gives its
requests over their real edges, the counters ``graph.edge_rows`` /
``graph.edges`` over every request of the run."""

from portbench.program import counter_ratio


def read(view):
    if view.kind != "serve":
        return None
    return counter_ratio("graph.edge_rows", "graph.edges")
