"""pad_ratio.train: the edge rows the port's graph build gives its
batches over their real edges, the counters ``graph.edge_rows`` /
``graph.edges`` over every batch of the run."""

from portbench.program import counter_ratio


def read(view):
    if view.kind != "train":
        return None
    return counter_ratio("graph.edge_rows", "graph.edges")
