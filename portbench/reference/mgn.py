"""Plain MeshGraphNet (Pfaff et al., arXiv:2010.03409) as the port's
configuration states it: MLP encoders, residual message-passing layers
(edge update, then node update over the summed incoming edges), MLP
decoder; ReLU, LayerNorm after every MLP but the decoder's.

The edge MLP's first linear is written as the concatenation trick
(W [e, x_s, x_r] = W_e e + (W_s x)[s] + (W_d x)[r]): the same function,
held in the port's parameter names (``w_e``, ``w_s``, ``w_d``, ``b``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

LN_EPS = 1e-5


def widths(cfg: dict) -> Tuple[int, int]:
    m = cfg["model"]
    return m["hidden_dim"], m["num_hidden_layers_edge_processor"]


def mlp_layout(prefix: str, fin: int, h: int, fout: int, n_hidden: int,
               ln: bool) -> List[tuple]:
    dims = [(fin, h)] + [(h, h)] * n_hidden + [(h, fout)]
    out = []
    for i, (a, b) in enumerate(dims):
        out += [(f"{prefix}.linears.{i}.w", (a, b), "w", a),
                (f"{prefix}.linears.{i}.b", (b,), "b", a)]
    if ln:
        out += [(f"{prefix}.ln.scale", (fout,), "ln_scale", 0),
                (f"{prefix}.ln.bias", (fout,), "ln_bias", 0)]
    return out


def layer_layout(prefix: str, h: int, n_hidden: int) -> List[tuple]:
    fin = 3 * h  # [e, x_s, x_r]
    out = [(f"{prefix}.edge.w_e", (h, h), "w", fin),
           (f"{prefix}.edge.w_s", (h, h), "w", fin),
           (f"{prefix}.edge.w_d", (h, h), "w", fin),
           (f"{prefix}.edge.b", (h,), "b", fin)]
    for i in range(n_hidden + 1):
        out += [(f"{prefix}.edge.stack.{i}.w", (h, h), "w", h),
                (f"{prefix}.edge.stack.{i}.b", (h,), "b", h)]
    out += [(f"{prefix}.edge.ln.scale", (h,), "ln_scale", 0),
            (f"{prefix}.edge.ln.bias", (h,), "ln_bias", 0)]
    return out + mlp_layout(f"{prefix}.node", 2 * h, h, h, n_hidden, True)


def io_layout(cfg: dict) -> List[tuple]:
    h, nh = widths(cfg)
    d = cfg["dims"]
    return (mlp_layout("node_encoder", d["input_node_dim"], h, h, nh, True)
            + mlp_layout("edge_encoder", d["input_edge_dim"], h, h, nh, True)
            + mlp_layout("decoder", h, h, d["output_node_dim"], nh, False))


def layout(cfg: dict) -> List[tuple]:
    """(name, shape, kind, fan_in) of every weight, in the port's names."""
    h, nh = widths(cfg)
    out = io_layout(cfg)
    for i in range(cfg["model"]["processor_size"]):
        out += layer_layout(f"layers.{i}", h, nh)
    return out


def mlp(w: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, mm,
        ln: bool) -> torch.Tensor:
    i = 0
    while f"{prefix}.linears.{i + 1}.w" in w:
        x = F.relu(mm(x, w[f"{prefix}.linears.{i}.w"])
                   + w[f"{prefix}.linears.{i}.b"])
        i += 1
    x = mm(x, w[f"{prefix}.linears.{i}.w"]) + w[f"{prefix}.linears.{i}.b"]
    if ln:
        x = F.layer_norm(x, x.shape[-1:], w[f"{prefix}.ln.scale"],
                         w[f"{prefix}.ln.bias"], LN_EPS)
    return mm.q(x)


def mp_layer(w, prefix: str, x, e, s, r, mm):
    """One residual MGN layer on real nodes and edges; returns (x', e')."""
    p = prefix + ".edge"
    z = (mm(e, w[p + ".w_e"]) + mm(x, w[p + ".w_s"])[s]
         + (mm(x, w[p + ".w_d"]) + w[p + ".b"])[r])
    z = F.relu(z)
    i = 0
    while f"{p}.stack.{i + 1}.w" in w:
        z = F.relu(mm(z, w[f"{p}.stack.{i}.w"]) + w[f"{p}.stack.{i}.b"])
        i += 1
    z = mm(z, w[f"{p}.stack.{i}.w"]) + w[f"{p}.stack.{i}.b"]
    z = mm.q(F.layer_norm(z, z.shape[-1:], w[p + ".ln.scale"],
                          w[p + ".ln.bias"], LN_EPS))
    e = mm.q(e + z)
    agg = mm.q(torch.zeros_like(x).index_add_(0, r, e))
    x = mm.q(x + mlp(w, prefix + ".node", torch.cat([x, agg], dim=1), mm,
                     True))
    return x, e


GROUP = 3  # layers under one outer checkpoint when recomputing


def _layers(w, prefixes, x, e, s, r, mm, ckpt: bool):
    for p in prefixes:
        if ckpt:
            x, e = torch.utils.checkpoint.checkpoint(
                lambda a, b, p=p: mp_layer(w, p, a, b, s, r, mm), x, e,
                use_reentrant=False)
        else:
            x, e = mp_layer(w, p, x, e, s, r, mm)
    return x, e


def process(w, prefixes, x, e, s, r, mm, ckpt: bool):
    """The layers ``prefixes`` in order. ``ckpt`` recomputes them in the
    backward, so that a 1M-node graph fits in float32: an outer checkpoint
    keeps the input of each group of ``GROUP`` layers, and inside it each
    layer is checkpointed again."""
    if not (ckpt and torch.is_grad_enabled()):
        return _layers(w, prefixes, x, e, s, r, mm, False)
    for i in range(0, len(prefixes), GROUP):
        x, e = torch.utils.checkpoint.checkpoint(
            lambda a, b, g=prefixes[i:i + GROUP]: _layers(
                w, g, a, b, s, r, mm, True), x, e, use_reentrant=False)
    return x, e


def encode(w, prefix: str, a: torch.Tensor, mm, ckpt: bool) -> torch.Tensor:
    if ckpt and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            lambda t: mlp(w, prefix, t, mm, True), a, use_reentrant=False)
    return mlp(w, prefix, a, mm, True)


def prepare(cfg: dict, mesh, device) -> dict:
    """The real graph of ``mesh`` on ``device``."""
    return {"x": torch.as_tensor(mesh.x, device=device),
            "edge_attr": torch.as_tensor(mesh.edge_attr, device=device),
            "s": torch.as_tensor(mesh.senders, device=device),
            "r": torch.as_tensor(mesh.receivers, device=device),
            "y": torch.as_tensor(mesh.y, device=device),
            "num_nodes": mesh.num_nodes, "num_edges": mesh.num_edges}


def forward(w, cfg: dict, g: dict, mm, ckpt: bool = False) -> torch.Tensor:
    x = encode(w, "node_encoder", mm.q(g["x"]), mm, ckpt)
    e = encode(w, "edge_encoder", mm.q(g["edge_attr"]), mm, ckpt)
    x, e = process(w, [f"layers.{i}" for i in
                       range(cfg["model"]["processor_size"])],
                   x, e, g["s"], g["r"], mm, ckpt)
    return mlp(w, "decoder", x, mm, False)


def level_sizes(cfg: dict, mesh) -> List[Tuple[int, int, int]]:
    """(layers, real nodes, real edges) per scale, for the FLOP count."""
    return [(cfg["model"]["processor_size"], mesh.num_nodes,
             mesh.num_edges)]


def checkpoint_needed(mesh) -> bool:
    """Per-layer recompute above 262,144 nodes: the float32 activations of
    15 layers at 1M nodes do not fit beside their boundaries."""
    return mesh.num_nodes > 262144


def loss_fn(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - y))
