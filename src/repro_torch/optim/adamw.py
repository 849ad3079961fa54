"""AdamW + schedule + global-norm clipping (PyTorch port of
``repro.optim.adamw``).  The optimizer state mirrors the param tree:
``{"m": tree, "v": tree, "step": int32 scalar}``.

:func:`update` writes the new params and moments into the given tensors
(PyTorch's in-place idiom; the JAX function returns new trees): a full-width
fp32 step cannot hold a second copy of the params and both moments on one
card.  The arithmetic is the JAX function's, in float32 throughout — the
schedule's cosine, the bias corrections ``1 - b**step`` and the clip factor
are float32 tensor ops, never Python float64 — and :func:`global_norm` sums
the leaves in JAX's order (dict keys sorted), since another order rounds the
norm, and through the clip factor every update, differently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr (float32)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog)
    )
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Pytree) -> Pytree:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(g.to(torch.float32)))
            for g in tree_leaves(tree))
    )


@torch.no_grad()
def update(
    grads: Pytree, state: Pytree, params: Pytree, cfg: AdamWConfig
) -> tuple[Pytree, Pytree, dict]:
    """One AdamW step, written into ``params`` and ``state`` (returned).
    Weight decay applies to leaves with ``ndim >= 2`` (the matrices and the
    tied embedding table, not the norm scales)."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state["step"] += 1
    step = state["step"]
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=sf.device), sf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        # products rounded apart, as XLA's un-fused form: no add(alpha=)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g) * (1 - b2))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        if p.ndim >= 2:  # decay matrices only (standard practice)
            delta += cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, state, {"grad_norm": gnorm, "lr": lr}
