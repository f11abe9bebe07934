"""Plain Transolver (Wu et al., arXiv:2402.02366; github.com/thuml/Transolver,
``Physics_Attention_Irregular_Mesh`` and ``Transolver_block``) on one
graph's real points, in float32: every matmul (the projections, w^T fx,
w z', q k^T, attn v) through ``mm``, softmaxes and LayerNorms in plain
torch, no custom Function, no batching and no padding.

Per point x [N, h]: preprocess Linear(d_in, 2h) -> GELU -> Linear(2h, h),
plus the placeholder; each block x += PhysAttn(LN1(x)), x += MLP(LN2(x))
(Linear(h, r h) -> GELU -> Linear(r h, h)); the head Linear(h, out) of
LN3(x). PhysAttn per head: fx = in_fx(u), xm = in_x(u), w = softmax over
slices of in_slice(xm) / temperature[head], tokens (w^T fx) / (sum_n w +
1e-5), attention among the tokens (q, k, v without bias, scale C^-1/2),
back to the points as w z', then to_out.

Departures from the published code, the same in the port:

* 6 node inputs (the benchmark mesh's position, normals, mach, alpha) in
  place of the ShapeNet-Car loader's 7;
* the seeded uniform draw of ``portbench.weights`` in place of the
  published init (trunc-normal std 0.02 for every Linear, the orthogonal
  in_project_slice it overwrites, temperature 0.5, placeholder
  U(0, 1/h)): the temperature takes the kind ``ln_scale`` (1 +
  U(-0.1, 0.1)), the placeholder the kind ``placeholder`` (0.1 U(-1, 1));
* the attention's and to_out's dropout are left out (dropout 0 in the
  ShapeNet-Car setting).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
SLICE_EPS = 1e-5
ACTIVATIONS = {"gelu_exact": F.gelu}


def _linear(name: str, fin: int, fout: int) -> List[tuple]:
    return [(f"{name}.w", (fin, fout), "w", fin),
            (f"{name}.b", (fout,), "b", fin)]


def _ln(name: str, h: int) -> List[tuple]:
    return [(f"{name}.scale", (h,), "ln_scale", 0),
            (f"{name}.bias", (h,), "ln_bias", 0)]


def layout(cfg: dict) -> List[tuple]:
    """(name, shape, kind, fan_in) of every weight, in the port's names."""
    m, d = cfg["model"], cfg["dims"]
    h, heads, s = m["hidden_dim"], m["num_heads"], m["slice_num"]
    c, r = h // heads, m["mlp_ratio"] * h
    out = (_linear("preprocess.0", d["input_node_dim"], 2 * h)
           + _linear("preprocess.1", 2 * h, h)
           + [("placeholder", (h,), "placeholder", 0)])
    for i in range(m["processor_size"]):
        p = f"blocks.{i}"
        a = p + ".attn"
        out += (_ln(p + ".ln1", h) + _linear(a + ".in_fx", h, h)
                + _linear(a + ".in_x", h, h) + _linear(a + ".in_slice", c, s)
                + [(a + ".temperature", (heads,), "ln_scale", 0)]
                + [(f"{a}.to_{k}", (c, c), "w", c) for k in "qkv"]
                + _linear(a + ".to_out", h, h) + _ln(p + ".ln2", h)
                + _linear(p + ".mlp.0", h, r) + _linear(p + ".mlp.1", r, h))
    return (out + _ln("ln_out", h)
            + _linear("head", h, d["output_node_dim"]))


def _lin(w, name, x, mm):
    return mm(x, w[name + ".w"]) + w[name + ".b"]


def _layer_norm(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[name + ".scale"],
                        w[name + ".bias"], LN_EPS)


def physics_attention(w: Dict[str, torch.Tensor], p: str, u: torch.Tensor,
                      heads: int, mm) -> torch.Tensor:
    n = u.shape[0]
    fx = _lin(w, p + ".in_fx", u, mm).view(n, heads, -1).transpose(0, 1)
    xm = _lin(w, p + ".in_x", u, mm).view(n, heads, -1).transpose(0, 1)
    c = fx.shape[-1]
    logits = _lin(w, p + ".in_slice", xm, mm)  # [H, N, S]
    sw = torch.softmax(logits / w[p + ".temperature"][:, None, None], dim=-1)
    tokens = mm(sw.transpose(1, 2), fx) / (sw.sum(1) + SLICE_EPS)[..., None]
    q, k, v = (mm(tokens, w[f"{p}.to_{t}"]) for t in "qkv")
    attn = torch.softmax(mm(q, k.transpose(1, 2)) * c ** -0.5, dim=-1)
    out = mm(sw, mm(attn, v))  # [H, N, C]
    return _lin(w, p + ".to_out", out.transpose(0, 1).reshape(n, -1), mm)


def prepare(cfg: dict, mesh, device) -> dict:
    """The real points of ``mesh`` on ``device``."""
    return {"x": torch.as_tensor(mesh.x, device=device),
            "y": torch.as_tensor(mesh.y, device=device),
            "num_nodes": mesh.num_nodes}


def forward(w, cfg: dict, g: dict, mm, ckpt: bool = False) -> torch.Tensor:
    m = cfg["model"]
    act = ACTIVATIONS[m["activation"]]
    x = _lin(w, "preprocess.1", act(_lin(w, "preprocess.0", g["x"], mm)), mm)
    x = x + w["placeholder"]
    for i in range(m["processor_size"]):
        p = f"blocks.{i}"
        x = x + physics_attention(w, p + ".attn",
                                  _layer_norm(w, p + ".ln1", x),
                                  m["num_heads"], mm)
        u = _layer_norm(w, p + ".ln2", x)
        x = x + _lin(w, p + ".mlp.1", act(_lin(w, p + ".mlp.0", u, mm)), mm)
    return _lin(w, "head", _layer_norm(w, "ln_out", x), mm)


def level_sizes(cfg: dict, mesh) -> List[Tuple[int, int, int]]:
    """(layers, real points, 0): Transolver reads no edges."""
    return [(cfg["model"]["processor_size"], mesh.num_nodes, 0)]


def checkpoint_needed(mesh) -> bool:
    """No recompute: 8 layers of a 65,536-point graph fit in float32."""
    return False


def loss_fn(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - y))
