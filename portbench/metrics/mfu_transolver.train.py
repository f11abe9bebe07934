"""mfu_transolver.train: Transolver's forward and backward matmul
operations on each profiled graph's real points
(portbench.flops_transolver.train_ops) over the traced steps' window times
the configuration's peak."""

from portbench import flops_transolver as FT


def read(view):
    t = view.trace
    if view.kind != "train" or t is None or t.busy_s <= 0 \
            or not view.profiled:
        return None
    ops = sum(FT.train_ops(view.config, sizes) for group in view.profiled
              for sizes in group)
    return 100.0 * ops / (t.window_s * view.config["peak_ops_per_s"])
