"""edge_fwd_roofline.serve: the fused edge layer's forward
(ops/hopper_fused.py _FusedEdgeLayer; K1 today): the least time of its work
over the device time of these kernels launched inside it."""

from portbench.readers import edge_roofline_pct

KERNELS = (r"\bedge_fwd_rows_kernel\b", r"\bfill_pad_rows\b",
           r"\breduce_partials\b", r"\brow_offsets_kernel\b",
           r"\bsegment_rows_kernel\b", r"\bsegment_bulk_kernel\b")


def read(view):
    if view.kind != "serve":
        return None
    return edge_roofline_pct(view, backward=False, kernels=KERNELS)
