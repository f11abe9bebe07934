"""node_pad_ratio.train: the node rows the port's graph build gives its
batches over their real nodes, the counters ``graph.node_rows`` /
``graph.nodes`` over every batch of the run."""

from portbench.program import counter_ratio


def read(view):
    if view.kind != "train":
        return None
    return counter_ratio("graph.node_rows", "graph.nodes")
