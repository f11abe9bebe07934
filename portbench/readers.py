"""Arithmetic the metric readers share: span means, the idle share, the
model's share of the compute peak and the fused edge layer's share of its
roofline over the profiled steps or requests. A reader returns None where
its run has nothing to read (no trace, no such span, no kernel found)."""

from __future__ import annotations

from typing import Iterable, Optional

from portbench import flops as FL


def span_mean_ms(view, name: str) -> Optional[float]:
    d = view.spans.get(name)
    return 1e3 * sum(d) / len(d) if d else None


def idle_pct(view) -> Optional[float]:
    t = view.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _dims(view):
    m = view.config["model"]
    item = 2 if m["compute_dtype"] == "bfloat16" else 4
    return m["hidden_dim"], m["num_hidden_layers_edge_processor"], item


def mfu_pct(view, train: bool) -> Optional[float]:
    """The model's operations over the profiled steps (requests) over the
    traced window times the configuration's peak."""
    t = view.trace
    if t is None or t.busy_s <= 0 or not view.profiled:
        return None
    fn = FL.train_ops if train else FL.forward_ops
    ops = sum(fn(view.config, sizes) for group in view.profiled
              for sizes in group)
    return 100.0 * ops / (t.window_s * view.config["peak_ops_per_s"])


def edge_roofline_pct(view, backward: bool, kernels: Iterable[str]
                      ) -> Optional[float]:
    """The least time of the fused edge layer's work (forward or
    backward) in the profiled steps, on real nodes and edges, over the
    device time of the listed kernels launched inside that function."""
    t = view.trace
    if t is None or not view.profiled:
        return None
    if backward:
        dev_s = t.function_device_s(
            ("_FusedEdgeLayerBackward",
             "autograd::engine::evaluate_function: _FusedEdgeLayerBackward"),
            kernels, exclude=("_FusedEdgeLayer", "_FusedNodeLayer"))
    else:
        dev_s = t.function_device_s(("_FusedEdgeLayer",), kernels)
    if not dev_s:
        return None
    h, nh, item = _dims(view)
    work = FL.edge_bwd_work if backward else FL.edge_fwd_work
    least = 0.0
    for group in view.profiled:
        for sizes in group:
            for layers, n, e in sizes:
                ops, nbytes = work(n, e, h, nh, item)
                least += layers * FL.least_seconds(
                    ops, nbytes, view.config["peak_ops_per_s"],
                    view.config["peak_bytes_per_s"])
    return 100.0 * least / dev_s
