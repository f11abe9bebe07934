"""The reference's first training steps: the model module's forward, the
mean squared error over real nodes, ``torch.autograd.grad`` and a plain
Adam (torch.optim.Adam's update, additive weight decay 0), from the same
initial weights over the same meshes in the same order. Returns what the
comparison reads: each step's loss, each leaf's first gradient norm and
each leaf's change after the last step."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import precision as P


def adam_steps(model, cfg: dict, w0: Dict[str, torch.Tensor], meshes: List,
               device, precision: str = "fp32", lr: float = 1e-3,
               betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    mm = P.matmul(precision)
    names = list(w0)
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w0.items()}
    losses, grad1 = [], None
    for t, mesh in enumerate(meshes, 1):
        g = model.prepare(cfg, mesh, device)
        with P.tf32(precision == "tf32"):
            pred = model.forward(w, cfg, g, mm,
                                 ckpt=model.checkpoint_needed(mesh))
            loss = model.loss_fn(pred, g["y"])
            grads = torch.autograd.grad(loss, [w[k] for k in names])
        losses.append(float(loss.detach()))
        del g, pred, loss
        if t == 1:
            grad1 = {k: float(gr.norm()) for k, gr in zip(names, grads)}
        bc1, bc2 = 1 - betas[0] ** t, 1 - betas[1] ** t
        with torch.no_grad():
            for k, gr in zip(names, grads):
                m[k].mul_(betas[0]).add_(gr, alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(gr, gr, value=1 - betas[1])
                denom = (v2[k].sqrt() / bc2 ** 0.5).add_(eps)
                w[k].addcdiv_(m[k], denom, value=-lr / bc1)
        del grads
    delta = {k: float((w[k].detach() - w0[k]).norm()) for k in names}
    return {"losses": losses, "grad1": grad1, "delta": delta}


def predict(model, cfg: dict, w: Dict[str, torch.Tensor], mesh, device,
            precision: str = "fp32") -> torch.Tensor:
    """The forward's normalised predictions over the mesh's real nodes."""
    g = model.prepare(cfg, mesh, device)
    with torch.no_grad(), P.tf32(precision == "tf32"):
        return model.forward(w, cfg, g, P.matmul(precision))
