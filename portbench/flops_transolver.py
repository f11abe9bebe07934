"""Operations and bytes of Transolver and of its Physics-Attention, from the
configuration and each graph's real points (never the padded rows, the
Loader's graph slots or which kernels run).

Operations are the matmuls' multiply-adds (2 per MAC), with no recompute:
per point the preprocess (d_in -> 2h -> h), per layer and point in_fx and
in_x (h x h each), in_slice (C -> slices per head), the slice reduction
w^T fx and the deslice w z' (slices x C per head each), to_out (h x h) and
the MLP (h -> r h -> h), the head (h -> out); per layer and graph the
attention among its slice tokens (q, k, v: slices x C x C per head; q k^T
and attn v: slices^2 x C per head). Softmaxes, LayerNorms, GELU and the
token normalisation are not counted. A training step is three forward
passes' worth (forward, then the input and the weight gradients); the
Physics-Attention backward two.
"""

from __future__ import annotations

from typing import Iterable, Tuple

F32 = 4


def _widths(cfg: dict):
    m = cfg["model"]
    h, heads, s = m["hidden_dim"], m["num_heads"], m["slice_num"]
    return h, heads, s, h // heads, m["mlp_ratio"] * h


def physattn_point_ops(cfg: dict) -> int:
    """One Physics-Attention layer's operations a point."""
    h, heads, s, c, _ = _widths(cfg)
    return 2 * (2 * h * h + heads * c * s + 2 * heads * s * c + h * h)


def physattn_graph_ops(cfg: dict) -> int:
    """One Physics-Attention layer's attention among a graph's tokens."""
    h, heads, s, c, _ = _widths(cfg)
    return 2 * heads * (3 * s * c * c + 2 * s * s * c)


def forward_ops(cfg: dict, sizes: Iterable[Tuple[int, int, int]]) -> int:
    """``sizes``: [(layers, real points, 0)] of one graph."""
    h, _, _, _, r = _widths(cfg)
    d = cfg["dims"]
    ops = 0
    for layers, n, _ in sizes:
        ops += 2 * n * (d["input_node_dim"] * 2 * h + 2 * h * h
                        + h * d["output_node_dim"])
        ops += layers * (n * (physattn_point_ops(cfg) + 2 * 2 * h * r)
                         + physattn_graph_ops(cfg))
    return ops


def train_ops(cfg: dict, sizes) -> int:
    return 3 * forward_ops(cfg, sizes)


def _weight_elems(cfg: dict) -> int:
    h, heads, s, c, _ = _widths(cfg)
    return 3 * (h * h + h) + c * s + s + heads + 3 * c * c


def physattn_fwd_work(cfg: dict, n: int) -> Tuple[int, int]:
    """(operations, bytes) of one Physics-Attention layer's forward on a
    graph of ``n`` real points: u [n, h] and the weights read once, the
    output [n, h] written once (float32)."""
    h = cfg["model"]["hidden_dim"]
    ops = n * physattn_point_ops(cfg) + physattn_graph_ops(cfg)
    return ops, F32 * (2 * n * h + _weight_elems(cfg))


def physattn_bwd_work(cfg: dict, n: int) -> Tuple[int, int]:
    """(operations, bytes) of its backward: the input and the weight
    gradients (two forwards' operations); reads u, the output's cotangent
    and the weights, writes d_u and the weight gradients."""
    h = cfg["model"]["hidden_dim"]
    ops, _ = physattn_fwd_work(cfg, n)
    w = _weight_elems(cfg)
    return 2 * ops, F32 * (2 * n * h + w + n * h + w)


def least_physattn_s(view, backward: bool) -> float:
    """The least time of every Physics-Attention layer of the profiled
    steps: max(operations / peak, bytes / bandwidth) a layer and graph."""
    cfg = view.config
    work = physattn_bwd_work if backward else physattn_fwd_work
    least = 0.0
    for group in view.profiled:
        for sizes in group:
            for layers, n, _ in sizes:
                ops, nbytes = work(cfg, n)
                least += layers * max(ops / cfg["peak_ops_per_s"],
                                      nbytes / cfg["peak_bytes_per_s"])
    return least
