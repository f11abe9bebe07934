"""edge_bwd_roofline.train: the fused edge layer's backward
(ops/hopper_fused.py _FusedEdgeLayer; K2 today): the least time of its work
over the device time of these kernels launched inside its backward."""

from portbench.readers import edge_roofline_pct

KERNELS = (r"\bedge_rows_kernel\b", r"\bedge_dw_kernel\b",
           r"\bfill_pad_rows\b", r"\breduce_partials\b",
           r"\brow_offsets_kernel\b", r"\bsegment_rows_kernel\b",
           r"\bsegment_bulk_kernel\b")


def read(view):
    if view.kind != "train":
        return None
    return edge_roofline_pct(view, backward=True, kernels=KERNELS)
