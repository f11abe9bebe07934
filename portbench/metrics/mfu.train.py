"""mfu.train: the model's forward and backward matmul operations on real
nodes and edges (portbench.flops.train_ops) over the traced steps' window
times the configuration's peak."""

from portbench.readers import mfu_pct


def read(view):
    return mfu_pct(view, train=True) if view.kind == "train" else None
