"""loader_ms.train: the mean host time of the Loader iterator's next()
a batch in the window (graph/padded.batch_graphs, the hierarchy's collation
and alignment, the copies to the device)."""

from portbench.readers import span_mean_ms


def read(view):
    return span_mean_ms(view, "loader.next") if view.kind == "train" else None
