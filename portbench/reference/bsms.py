"""Plain BSMS-GNN (Cao et al., arXiv:2210.02573) as the port's
configuration states it: MGN encoders and decoder; per scale
``layers_per_scale`` MGN layers, then the WeightedEdgeConv transfer down
(x_c = the representative's row of A x; e_c the length-weighted mean of
the fine edges it merges); a bottleneck of the remaining layers; up, x_f =
A^T (rep * x_c[f2c]) plus the skip, e_f the skip's, then the stage's
layers. A x = conv_self * x + sum over incoming edges of conv_edge *
x[sender]. The hierarchy comes from ``hierarchy.build``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from portbench.reference import hierarchy as HR
from portbench.reference import mgn as R


def counts(cfg: dict) -> Tuple[int, int, int]:
    m = cfg["model"]
    down = m["layers_per_scale"]
    bottleneck = max(1, m["processor_size"]
                     - 2 * down * (m["num_scales"] - 1))
    return m["num_scales"] - 1, down, bottleneck


def layout(cfg: dict) -> List[tuple]:
    h, nh = R.widths(cfg)
    n_lv, down, bottleneck = counts(cfg)
    out = R.io_layout(cfg)
    for s in range(n_lv):
        for i in range(down):
            out += R.layer_layout(f"down.{s}.{i}", h, nh)
    for i in range(bottleneck):
        out += R.layer_layout(f"bottleneck.{i}", h, nh)
    for s in range(n_lv):
        for i in range(down):
            out += R.layer_layout(f"up.{s}.{i}", h, nh)
    return out


def _t(a, device, dtype=None):
    return torch.as_tensor(a, device=device, dtype=dtype)


def prepare(cfg: dict, mesh, device) -> dict:
    g = R.prepare(cfg, mesh, device)
    levels = HR.build(mesh.senders, mesh.receivers, mesh.pos,
                      cfg["model"]["num_scales"])
    f32 = torch.float32
    g["levels"] = [{
        "f2c": _t(lv["f2c"], device), "e2c": _t(lv["e2c"], device),
        "rep": _t(lv["rep"], device, f32),
        "cs": _t(lv["conv_self"], device, f32),
        "ce": _t(lv["conv_edge"], device, f32),
        "ew": _t(lv["edge_w"], device, f32),
        "s": _t(lv["senders"], device), "r": _t(lv["receivers"], device),
        "num_nodes": lv["num_nodes"], "num_edges": len(lv["senders"]),
    } for lv in levels]
    return g


def _conv(x, cs, ce, s, r):
    """A x."""
    return cs[:, None] * x + torch.zeros_like(x).index_add_(
        0, r, ce[:, None] * x[s])


def _conv_t(y, cs, ce, s, r):
    """A^T y."""
    return cs[:, None] * y + torch.zeros_like(y).index_add_(
        0, s, ce[:, None] * y[r])


def forward(w, cfg: dict, g: dict, mm, ckpt: bool = False) -> torch.Tensor:
    n_lv, down, bottleneck = counts(cfg)
    x = R.encode(w, "node_encoder", g["x"], mm, ckpt)
    e = R.encode(w, "edge_encoder", g["edge_attr"], mm, ckpt)
    s, r = g["s"], g["r"]
    skips = []
    for k, lv in enumerate(g["levels"]):
        x, e = R.process(w, [f"down.{k}.{i}" for i in range(down)], x, e, s,
                         r, mm, ckpt)
        skips.append((x, e, s, r))
        ax = _conv(x, lv["cs"], lv["ce"], s, r) * lv["rep"][:, None]
        x = torch.zeros(lv["num_nodes"], x.shape[1], device=x.device,
                        dtype=x.dtype).index_add_(0, lv["f2c"], ax)
        ne = lv["num_edges"]
        es = torch.zeros(ne, e.shape[1], device=e.device,
                         dtype=e.dtype).index_add_(0, lv["e2c"],
                                                   e * lv["ew"][:, None])
        wsum = torch.zeros(ne, device=e.device, dtype=e.dtype).index_add_(
            0, lv["e2c"], lv["ew"])
        e = es / torch.clamp(wsum, min=1e-12)[:, None]
        s, r = lv["s"], lv["r"]
    x, e = R.process(w, [f"bottleneck.{i}" for i in range(bottleneck)], x,
                     e, s, r, mm, ckpt)
    for k in range(n_lv):
        lv = g["levels"][-(k + 1)]
        skip_x, skip_e, s, r = skips[-(k + 1)]
        z = x[lv["f2c"]] * lv["rep"][:, None]
        x = _conv_t(z, lv["cs"], lv["ce"], s, r) + skip_x
        x, e = R.process(w, [f"up.{k}.{i}" for i in range(down)], x, skip_e,
                         s, r, mm, ckpt)
    return R.mlp(w, "decoder", x, mm, False)


def level_sizes(cfg: dict, mesh) -> List[Tuple[int, int, int]]:
    """(layers, real nodes, real edges) per scale: each scale's down and up
    stages, and the bottleneck on the coarsest."""
    levels = HR.build(mesh.senders, mesh.receivers, mesh.pos,
                      cfg["model"]["num_scales"])
    n_lv, down, bottleneck = counts(cfg)
    out = [(2 * down, mesh.num_nodes, mesh.num_edges)]
    for k, lv in enumerate(levels):
        layers = bottleneck if k == n_lv - 1 else 2 * down
        out.append((layers, lv["num_nodes"], len(lv["senders"])))
    return out


checkpoint_needed = R.checkpoint_needed
loss_fn = R.loss_fn
