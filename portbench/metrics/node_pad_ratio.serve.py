"""node_pad_ratio.serve: the node rows the port's graph build gives its
requests over their real nodes, the counters ``graph.node_rows`` /
``graph.nodes`` over every request of the run."""

from portbench.program import counter_ratio


def read(view):
    if view.kind != "serve":
        return None
    return counter_ratio("graph.node_rows", "graph.nodes")
