"""Operations and bytes of the model and of its fused edge layer, from the
configuration and the graph's real sizes (never the padded ones, and never
from which kernel runs).

Operations are the matmuls' multiply-adds (2 per MAC): the MLPs of the
encoders, each message-passing layer and the decoder, in the
concatenation-trick form (nodes projected by W_s and W_d before the
gather), with no recompute. Element-wise work, LayerNorm, the
aggregations and BSMS's WeightedEdgeConv transfers are not counted. A
training step is three forward passes' worth (forward, and the input and
weight gradients).
"""

from __future__ import annotations

from typing import Iterable, Tuple


def mlp_ops(rows: int, fin: int, h: int, fout: int, n_hidden: int) -> int:
    return 2 * rows * (fin * h + n_hidden * h * h + h * fout)


def layer_ops(n: int, e: int, h: int, n_hidden: int) -> int:
    """One MGN layer: the edge MLP (W_e, the hidden stack, the output) on
    e edges, W_s and W_d on n nodes, the node MLP on [x, agg]."""
    edge = 2 * e * h * h * (n_hidden + 2)
    proj = 2 * n * h * h * 2
    return edge + proj + mlp_ops(n, 2 * h, h, h, n_hidden)


def forward_ops(cfg: dict, sizes: Iterable[Tuple[int, int, int]]) -> int:
    """``sizes``: (layers, real nodes, real edges) per scale, the finest
    first (the encoders and decoder run there)."""
    m, d = cfg["model"], cfg["dims"]
    h, nh = m["hidden_dim"], m["num_hidden_layers_edge_processor"]
    sizes = list(sizes)
    _, n0, e0 = sizes[0]
    ops = (mlp_ops(n0, d["input_node_dim"], h, h, nh)
           + mlp_ops(e0, d["input_edge_dim"], h, h, nh)
           + mlp_ops(n0, h, h, d["output_node_dim"], nh))
    return ops + sum(k * layer_ops(n, e, h, nh) for k, n, e in sizes)


def train_ops(cfg: dict, sizes) -> int:
    return 3 * forward_ops(cfg, sizes)


def _weight_elems(h: int, n_hidden: int) -> int:
    return (n_hidden + 2) * h * h + (n_hidden + 1) * h + 2 * h


def edge_fwd_work(n: int, e: int, h: int, n_hidden: int,
                  item: int) -> Tuple[int, int]:
    """(operations, bytes) of the fused edge layer's forward: inputs e,
    s_proj[senders], d_proj, the edge mask (compute dtype) and receivers
    (int32) and the weights read once; e' and agg written once."""
    ops = 2 * e * h * h * (n_hidden + 2)
    reads = (2 * e * h + n * h + e + _weight_elems(h, n_hidden)) * item \
        + 4 * e
    writes = (e * h + n * h) * item
    return ops, reads + writes


def edge_bwd_work(n: int, e: int, h: int, n_hidden: int,
                  item: int) -> Tuple[int, int]:
    """(operations, bytes) of its backward from the layer inputs: the
    forward again, then the input and weight gradients (three forwards'
    operations); reads the forward's inputs and the cotangents of e' and
    agg, writes d_e, d_sg, d_dproj and the weight gradients."""
    ops = 3 * 2 * e * h * h * (n_hidden + 2)
    w = _weight_elems(h, n_hidden)
    reads = (3 * e * h + 2 * n * h + e + w) * item + 4 * e
    writes = (2 * e * h + n * h + w) * item
    return ops, reads + writes


def least_seconds(ops: int, nbytes: int, peak_ops: float,
                  peak_bytes: float) -> float:
    return max(ops / peak_ops, nbytes / peak_bytes)
