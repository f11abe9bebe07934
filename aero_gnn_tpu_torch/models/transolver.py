"""Transolver (Wu et al., "Transolver: A Fast Transformer Solver for PDEs
on General Geometries", ICML 2024, arXiv:2402.02366): a transformer whose
attention runs among a few learned slices of the mesh, not its points.
There is no counterpart in the JAX package.

Per graph, x [N, h] the points' states:

  * preprocess: Linear(d_in, 2h) -> act -> Linear(2h, h), then
    + ``placeholder`` [h];
  * ``processor_size`` blocks: x += PhysAttn(LN1(x)), then
    x += MLP(LN2(x)), MLP = Linear(h, mlp_ratio h) -> act -> Linear(., h);
  * head: Linear(h, out)(LN3(x)).

PhysAttn(u), per head of C = h / ``num_heads`` channels: fx = in_fx(u) and
xm = in_x(u); w = softmax over ``slice_num`` slices of in_slice(xm) /
temperature[head]; slice tokens z = (w^T fx) / (sum_n w + 1e-5), a sum over
all of one graph's points; z' = softmax(q k^T / sqrt(C)) v with q, k, v =
z to_q, z to_k, z to_v; out = to_out(concat_heads(w z')). The published
ShapeNet-Car model has dropout 0 and so has the port: a non-zero
``dropout`` is refused.

Batching: the Loader packs graphs one after another and pads rows. The
model runs on a slot layout (``slot_plan``): every row, real or pad, moves
into chunks of ``SLOT_ROWS`` slots, each chunk holding rows of one graph
slot only; slots that no row fills read zeros. The slice reduction is one
batched matmul a chunk and head, then a sum of each graph's chunks (a
one-hot matmul, in a fixed order); the deslice reads its chunk's graph's
tokens. Work and memory grow with the rows, not with rows times graphs.
Pad rows and empty slots get slice weights 0, and a graph slot without
points gets tokens 0. The output returns to row order; the loss and the
engine never read pad rows' outputs.

Physics-Attention is ``_PhysicsAttention``, an autograd Function whose
backward is written out in plain torch ops: it saves u, fx, xm, the
slice tokens z, the attention, z' and the rows o = w z', and recomputes
the slice weights from xm (one softmax over [slots, heads, slices]).
Spans ``aero.transolver.slice`` / ``.attend`` / ``.deslice`` (forward) and
``.mlp``; counters ``transolver.points`` (real points sliced, summed over
layers) and ``transolver.point_rows`` (slots the slice reductions walk,
summed over layers).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from aero_gnn_tpu_torch.device import DeviceLike
from aero_gnn_tpu_torch.graph.padded import GraphBatch
from aero_gnn_tpu_torch.models.mgn import ModelParams, check_apply, init_params
from aero_gnn_tpu_torch.nn import mlp as M
from aero_gnn_tpu_torch.utils.profiling import annotate, count

SLICE_EPS = 1e-5  # the published slice_norm + 1e-5
INIT_STD = 0.02  # the published trunc_normal_ of every Linear weight
TEMPERATURE_INIT = 0.5
SLOT_ROWS = 128  # slots of one chunk of the slot layout


@dataclasses.dataclass(frozen=True)
class TransolverConfig:
    input_node_dim: int
    output_node_dim: int
    hidden_dim: int = 256
    processor_size: int = 8
    num_heads: int = 8
    slice_num: int = 32
    mlp_ratio: int = 2
    activation: str = "gelu_exact"
    dropout: float = 0.0
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise ValueError("Transolver computes in float32 only, not "
                             f"{self.compute_dtype!r}")
        if self.dropout != 0.0:
            raise ValueError("Transolver runs without dropout, not "
                             f"{self.dropout!r}")
        if self.hidden_dim % self.num_heads:
            raise ValueError(f"hidden_dim {self.hidden_dim} is not a "
                             f"multiple of num_heads {self.num_heads}")
        M.activation_fn(self.activation)

    @property
    def params_dtype(self) -> torch.dtype:
        return torch.float32

    def init(self, generator: Union[torch.Generator, int, None] = None, *,
             device: DeviceLike = None) -> "Transolver":
        """Parameters drawn on the CPU from ``generator`` (a CPU
        torch.Generator or an int seed) as the published model draws them
        (Linear weights truncated normal, std 0.02, biases 0, LayerNorms 1
        and 0, temperatures 0.5, placeholder U(0, 1/h)), moved to
        ``device`` (CUDA unless ``"cpu"``)."""
        return init_params(Transolver, self, generator, device)

    def apply(self, params: "Transolver", graph: GraphBatch, *,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward pass -> fp32 [N_pad, output_node_dim]. Reads
        ``graph.x``, ``node_mask`` and ``node_graph``; no edges.
        ``generator`` is taken for the steps' interface and not read (no
        dropout)."""
        check_apply(self, params, graph)
        act = M.activation_fn(self.activation)
        plan = slot_plan(graph.node_graph, graph.node_mask,
                         graph.num_graphs_pad)
        count("transolver.points", graph.n_node * self.processor_size)
        count("transolver.point_rows",
              plan.row_of_slot.numel() * self.processor_size)
        x = torch.cat([graph.x.float(), graph.x.new_zeros(
            1, graph.x.shape[1], dtype=torch.float32)])[plan.row_of_slot]
        x = params.preprocess[1](act(params.preprocess[0](x))) \
            + params.placeholder
        for blk in params.blocks:
            u = M.layer_norm_apply(blk.ln1, x)
            x = x + physics_attention(blk.attn, u, plan, self.num_heads)
            with annotate("aero.transolver.mlp"):
                u = M.layer_norm_apply(blk.ln2, x)
                x = x + blk.mlp[1](act(blk.mlp[0](u)))
        out = params.head(M.layer_norm_apply(params.ln_out, x))
        return out[plan.slot_of_row]


class SlotPlan(NamedTuple):
    """The slot layout: K chunks of R slots (``slot_plan``)."""
    row_of_slot: torch.Tensor  # i64[K R]: the row a slot holds; N if none
    slot_of_row: torch.Tensor  # i64[N]
    mask: torch.Tensor  # f32[K, R]: 1 where a slot holds a real point
    chunk_graph: torch.Tensor  # i64[K], ascending
    onehot: torch.Tensor  # f32[G, K]: 1 where chunk k is graph g's


def slot_plan(node_graph: torch.Tensor, node_mask: torch.Tensor,
              graphs: int, rows: int = SLOT_ROWS) -> SlotPlan:
    """Each graph slot's rows, in row order, into whole chunks of ``rows``
    slots of their own: K = ceil(N / rows) + ``graphs`` chunks (enough
    for any split of N rows), so the shapes follow N and ``graphs``
    alone. Chunks past the last graph's hold no row and belong to the
    last graph slot. Built on the rows' device, without atomics."""
    n = node_graph.shape[0]
    dev = node_graph.device
    k = -(-n // rows) + graphs
    ng = node_graph.long()
    perm = torch.argsort(ng, stable=True)
    gs = ng[perm]
    ids = torch.arange(graphs, device=dev)
    first_row = torch.searchsorted(gs, ids)
    counts = torch.searchsorted(gs, ids, right=True) - first_row
    chunks = (counts + rows - 1) // rows
    ends = torch.cumsum(chunks, 0)
    local = torch.arange(n, device=dev) - first_row[gs]
    slot = (ends[gs] - chunks[gs] + local // rows) * rows + local % rows
    slot_of_row = torch.empty_like(slot)
    slot_of_row[perm] = slot
    row_of_slot = torch.full((k * rows,), n, dtype=torch.long, device=dev)
    row_of_slot[slot] = perm
    chunk_graph = torch.searchsorted(
        ends, torch.arange(k, device=dev), right=True).clamp_(max=graphs - 1)
    mask = torch.cat([node_mask.float(), node_mask.new_zeros(
        1, dtype=torch.float32)])[row_of_slot].view(k, rows)
    onehot = (chunk_graph[None, :] == ids[:, None]).float()
    return SlotPlan(row_of_slot, slot_of_row, mask, chunk_graph, onehot)


def _slice_weights(xm, w_slice, b_slice, temperature, mask):
    """(logits [K, R, H, S], softmax of logits / temperature[head], 0 in
    slots without a real point)."""
    logits = xm @ w_slice + b_slice
    w = torch.softmax(logits / temperature[:, None], dim=-1)
    return logits, w * mask[:, :, None, None]


def _graph_sum(onehot, t):
    """[K, ...] -> [G, ...]: each graph's chunks summed."""
    return (onehot @ t.reshape(t.shape[0], -1)).view(-1, *t.shape[1:])


def _tokens(w, fx, onehot):
    """(slice tokens z [G, H, S, C], each graph's weighted mean of fx;
    the denominators [G, H, S])."""
    den = _graph_sum(onehot, w.sum(1)) + SLICE_EPS
    num = _graph_sum(onehot, torch.einsum("krhs,krhc->khsc", w, fx))
    return num / den[..., None], den


def _attend(z, to_q, to_k, to_v):
    """Attention among each graph's slice tokens, per head: (softmax
    [G, H, S, S], z' [G, H, S, C])."""
    c = z.shape[-1]
    q, k, v = z @ to_q, z @ to_k, z @ to_v
    attn = torch.softmax(q @ k.transpose(-1, -2) * c ** -0.5, dim=-1)
    return attn, attn @ v


def physics_attention_plain(u, plan: SlotPlan, w_fx, b_fx, w_x, b_x,
                            w_slice, b_slice, temperature, to_q, to_k, to_v,
                            w_out, b_out, heads: int):
    """PhysAttn(u) on the slot layout (u [K R, h]) in plain torch ops:
    (out [K R, h], and what the backward reads: fx, xm, z, attn, z', the
    deslice's rows o)."""
    k, r = plan.mask.shape
    with annotate("aero.transolver.slice"):
        fx = (u @ w_fx + b_fx).view(k, r, heads, -1)
        xm = (u @ w_x + b_x).view(k, r, heads, -1)
        _, w = _slice_weights(xm, w_slice, b_slice, temperature, plan.mask)
        z, _ = _tokens(w, fx, plan.onehot)
    with annotate("aero.transolver.attend"):
        attn, zp = _attend(z, to_q, to_k, to_v)
    with annotate("aero.transolver.deslice"):
        o = torch.einsum("krhs,khsc->krhc", w,
                         zp[plan.chunk_graph]).reshape(k * r, -1)
        out = o @ w_out + b_out
    return out, (fx, xm, z, attn, zp, o)


class _PhysicsAttention(torch.autograd.Function):
    """PhysAttn(u) on the slot layout (module docstring): the forward of
    ``physics_attention_plain``, the backward in plain torch ops."""

    @staticmethod
    def forward(ctx, u, plan, w_fx, b_fx, w_x, b_x, w_slice, b_slice,
                temperature, to_q, to_k, to_v, w_out, b_out, heads: int):
        out, (fx, xm, z, attn, zp, o) = physics_attention_plain(
            u, plan, w_fx, b_fx, w_x, b_x, w_slice, b_slice, temperature,
            to_q, to_k, to_v, w_out, b_out, heads)
        ctx.save_for_backward(u, plan.mask, plan.chunk_graph, plan.onehot,
                              fx, xm, z, attn, zp, o, w_fx, w_x, w_slice,
                              b_slice, temperature, to_q, to_k, to_v, w_out)
        return out

    @staticmethod
    def backward(ctx, d_out):
        (u, mask, chunk_graph, onehot, fx, xm, z, attn, zp, o, w_fx, w_x,
         w_slice, b_slice, temperature, to_q, to_k, to_v,
         w_out) = ctx.saved_tensors
        k, r, heads, c = fx.shape
        s = w_slice.shape[1]
        d_w_out = o.t() @ d_out
        d_b_out = d_out.sum(0)
        d_o = (d_out @ w_out.t()).view(k, r, heads, c)
        logits, w = _slice_weights(xm, w_slice, b_slice, temperature, mask)
        # deslice: o = w z'[chunk's graph]
        d_w = torch.einsum("krhc,khsc->krhs", d_o, zp[chunk_graph])
        d_zp = _graph_sum(onehot, torch.einsum("krhs,krhc->khsc", w, d_o))
        # attention: z' = attn v, with q, k, v = z to_{q,k,v}
        q, kk, v = z @ to_q, z @ to_k, z @ to_v
        d_v = attn.transpose(-1, -2) @ d_zp
        d_attn = d_zp @ v.transpose(-1, -2)
        d_dots = attn * (d_attn - (d_attn * attn).sum(-1, keepdim=True))
        d_dots = d_dots * c ** -0.5
        d_q = d_dots @ kk
        d_k = d_dots.transpose(-1, -2) @ q
        zf = z.reshape(-1, c)
        d_to_q = zf.t() @ d_q.reshape(-1, c)
        d_to_k = zf.t() @ d_k.reshape(-1, c)
        d_to_v = zf.t() @ d_v.reshape(-1, c)
        d_z = d_q @ to_q.t() + d_k @ to_k.t() + d_v @ to_v.t()
        # tokens: z = (sum of the graph's chunks of w^T fx) / den
        den = _graph_sum(onehot, w.sum(1)) + SLICE_EPS
        d_part = (d_z / den[..., None])[chunk_graph]
        d_den = (-(d_z * z).sum(-1) / den)[chunk_graph]
        d_w = d_w + torch.einsum("khsc,krhc->krhs", d_part, fx) \
            + d_den[:, None]
        d_fx = torch.einsum("krhs,khsc->krhc", w, d_part).reshape(k * r, -1)
        # slice weights: w = mask softmax(logits / temperature)
        d_a = w * (d_w - (d_w * w).sum(-1, keepdim=True))
        d_logits = d_a / temperature[:, None]
        d_temperature = -(d_a * logits).sum((0, 1, 3)) / temperature.square()
        d_w_slice = xm.reshape(-1, c).t() @ d_logits.reshape(-1, s)
        d_b_slice = d_logits.sum((0, 1, 2))
        d_xm = (d_logits @ w_slice.t()).reshape(k * r, -1)
        d_u = d_fx @ w_fx.t() + d_xm @ w_x.t()
        return (d_u, None, u.t() @ d_fx, d_fx.sum(0), u.t() @ d_xm,
                d_xm.sum(0), d_w_slice, d_b_slice, d_temperature, d_to_q,
                d_to_k, d_to_v, d_w_out, d_b_out, None)


def physics_attention(p: "PhysicsAttentionParams", u: torch.Tensor,
                      plan: SlotPlan, heads: int) -> torch.Tensor:
    """PhysAttn(u) -> [K R, h] through ``_PhysicsAttention``."""
    return _PhysicsAttention.apply(
        u, plan, p.in_fx.w, p.in_fx.b, p.in_x.w, p.in_x.b, p.in_slice.w,
        p.in_slice.b, p.temperature, p.to_q, p.to_k, p.to_v, p.to_out.w,
        p.to_out.b, heads)


def _linear(fan_in: int, fan_out: int, generator) -> M.Linear:
    lin = M.Linear(fan_in, fan_out, generator=generator)
    with torch.no_grad():
        nn.init.trunc_normal_(lin.w, std=INIT_STD, generator=generator)
        lin.b.zero_()
    return lin


def _square(c: int, generator) -> nn.Parameter:
    w = torch.empty(c, c)
    nn.init.trunc_normal_(w, std=INIT_STD, generator=generator)
    return nn.Parameter(w)


class PhysicsAttentionParams(nn.Module):
    """``in_fx``, ``in_x`` (h -> h), ``in_slice`` (C -> slices, shared by
    the heads), ``temperature`` [heads], ``to_q`` / ``to_k`` / ``to_v``
    (C x C, no bias), ``to_out`` (h -> h)."""

    def __init__(self, h: int, heads: int, slices: int, generator):
        super().__init__()
        c = h // heads
        self.in_fx = _linear(h, h, generator)
        self.in_x = _linear(h, h, generator)
        self.in_slice = _linear(c, slices, generator)
        self.temperature = nn.Parameter(torch.full((heads,),
                                                   TEMPERATURE_INIT))
        self.to_q = _square(c, generator)
        self.to_k = _square(c, generator)
        self.to_v = _square(c, generator)
        self.to_out = _linear(h, h, generator)


class TransolverBlock(nn.Module):
    def __init__(self, cfg: TransolverConfig, generator):
        super().__init__()
        h = cfg.hidden_dim
        self.ln1 = M.LayerNorm(h)
        self.attn = PhysicsAttentionParams(h, cfg.num_heads, cfg.slice_num,
                                           generator)
        self.ln2 = M.LayerNorm(h)
        self.mlp = nn.ModuleList([_linear(h, cfg.mlp_ratio * h, generator),
                                  _linear(cfg.mlp_ratio * h, h, generator)])


class Transolver(ModelParams):
    """Parameters of a TransolverConfig: ``preprocess`` (two Linears),
    ``placeholder``, ``blocks``, ``ln_out`` and ``head``."""

    def __init__(self, cfg: TransolverConfig, generator: torch.Generator):
        super().__init__()
        h = cfg.hidden_dim
        self.preprocess = nn.ModuleList([
            _linear(cfg.input_node_dim, 2 * h, generator),
            _linear(2 * h, h, generator)])
        self.placeholder = nn.Parameter(
            torch.rand(h, generator=generator) / h)
        self.blocks = nn.ModuleList(TransolverBlock(cfg, generator)
                                    for _ in range(cfg.processor_size))
        self.ln_out = M.LayerNorm(h)
        self.head = _linear(h, cfg.output_node_dim, generator)
