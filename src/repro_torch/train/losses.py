"""Per-family training losses (PyTorch port of ``repro.train.losses``; the
lm family — ``whisper_loss`` comes with whisper, ROADMAP A13), and the
classifier loss of the CNN examples."""

from __future__ import annotations

import torch
import torch.nn.functional as F

AUX_WEIGHT = 0.01  # MoE load-balance aux coefficient
IGNORE = -1


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions where target != IGNORE.  logits (B,S,V) fp32.
    Padded-vocab logits masked to -1e30 get zero probability and zero
    gradient; an all-IGNORE batch gives 0 (and zero gradients)."""
    mask = (targets != IGNORE).to(torch.float32)
    safe_t = targets.clamp(min=0).to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe_t[..., None])[..., 0]
    ce = (logz - gold) * mask
    return ce.sum() / mask.sum().clamp(min=1.0)


def lm_loss(model_forward, params, cfg, ctx, batch, remat=False):
    """batch: tokens (B,S), targets (B,S).  Returns (loss, {"ce", "aux",
    "n_tokens"}): ``n_tokens`` counts the positions the CE covered, as
    float32 — the throughput denominator, summed (not averaged) across
    microbatches (trainer.SUM_AUX_KEYS)."""
    logits, aux = model_forward(params, cfg, ctx, batch["tokens"], remat=remat)
    targets = batch["targets"]
    ce = cross_entropy(logits, targets)
    loss = ce + AUX_WEIGHT * aux
    n_tok = (targets != IGNORE).sum().to(torch.float32)
    return loss, {"ce": ce, "aux": aux, "n_tokens": n_tok}


def classifier_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of (B, n_classes) logits against (B,)
    labels, written as the CNN examples write it
    (``benchmarks/accuracy_bench.py``)."""
    onehot = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
    return -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * onehot, -1))
