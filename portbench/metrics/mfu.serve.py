"""mfu.serve: the forward's matmul operations on real nodes and edges
over the traced requests' window times the configuration's peak."""

from portbench.readers import mfu_pct


def read(view):
    return mfu_pct(view, train=False) if view.kind == "serve" else None
