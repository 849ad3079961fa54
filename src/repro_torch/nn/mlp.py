"""Feed-forward blocks: the gated MLP of the llama/gemma family and MoE with
shared + routed experts (deepseek-moe / qwen2-moe) — PyTorch port of
``repro.nn.mlp``.

MoE dispatch is sort-based ragged grouping: the (token, expert) pairs are
stably sorted by expert, contracted against the stacked expert weights, and
combined back with their gate weights.  Fake-quant contracts with
``dispatch.ragged_dot``; packed serving keeps the expert stacks bit-packed
and contracts with ``dispatch.quant_gemm_grouped`` (the expert-batched
kernels).  The router stays full precision (policy ``fp_patterns`` include
``"router"``).

Determinism on the card: the sort is stable, top-k breaks ties toward the
lower expert index (a stable descending sort, as ``jax.lax.top_k``), and
each token's k contributions are summed from zero in ascending sorted
position with no atomics, so two runs give the same bits and the combine
does not depend on a token's batch mates.  The packed path reads nothing
back to the host.  Expert parallelism (``QCtx.mesh``) comes with slice 6.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import qlayers, quant
from repro_torch.kernels import dispatch
from repro_torch.nn.common import ACTIVATIONS, QCtx

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    act: str = "silu"
    gated: bool = True


def mlp_init(gen: torch.Generator, cfg: MLPConfig, *,
             dtype=torch.float32) -> Params:
    p = {
        "up": qlayers.dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
        "down": qlayers.dense_init(gen, cfg.d_ff, cfg.d_model, dtype=dtype),
    }
    if cfg.gated:
        p["gate"] = qlayers.dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype)
    return p


def mlp_apply(params: Params, x: torch.Tensor, cfg: MLPConfig, ctx: QCtx,
              path: str) -> torch.Tensor:
    act = ACTIVATIONS[cfg.act]
    up = ctx.dense(params["up"], x, f"{path}/up")
    if cfg.gated:
        gate = ctx.dense(params["gate"], x, f"{path}/gate")
        h = act(gate) * up
    else:
        h = act(up)
    return ctx.dense(params["down"], h, f"{path}/down")


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int  # per-expert FFN width (fine-grained)
    n_routed: int
    n_shared: int
    top_k: int
    act: str = "silu"
    n_routed_padded: int | None = None  # pad experts for EP divisibility
    router_scale_norm: bool = True  # normalise top-k gate weights to sum 1

    @property
    def e(self) -> int:
        return self.n_routed_padded or self.n_routed


def moe_init(gen: torch.Generator, cfg: MoEConfig, *,
             dtype=torch.float32) -> Params:
    e, d, f = cfg.e, cfg.d_model, cfg.d_expert
    dev = gen.device

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev) * std

    p: Params = {"router": qlayers.dense_init(gen, d, e, dtype=dtype)}
    p["experts"] = {"up": normal((e, d, f), d**-0.5),
                    "gate": normal((e, d, f), d**-0.5),
                    "down": normal((e, f, d), f**-0.5)}
    if cfg.n_shared:
        p["shared"] = mlp_init(gen, _shared_cfg(cfg), dtype=dtype)
    return p


def _shared_cfg(cfg: MoEConfig) -> MLPConfig:
    return MLPConfig(cfg.d_model, cfg.d_expert * cfg.n_shared, cfg.act)


def _router_probs(params, x2, cfg: MoEConfig, ctx: QCtx, path: str):
    """(T, E) float32 probs — router forced fp by policy (an fp32 matmul,
    TF32 off: ``resolve_device``); padded experts masked."""
    logits = ctx.dense(params["router"], x2, f"{path}/router").to(torch.float32)
    if cfg.n_routed_padded and cfg.n_routed_padded > cfg.n_routed:
        pad = torch.arange(cfg.e, device=logits.device) >= cfg.n_routed
        logits = logits.masked_fill(pad, -1e30)
    return torch.softmax(logits, dim=-1)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: values descending, ties to the lower index."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[:, :k], idx[:, :k]


def _expert_quant(w, ctx: QCtx, path: str):
    spec = ctx.policy.spec(path)
    if spec.is_fp:
        return w.to(ctx.compute_dtype)
    return quant.quantize_weight(w.to(torch.float32), spec.w_bits).to(
        ctx.compute_dtype)


def _expert_weights(experts: Params, ctx: QCtx, path: str) -> Params:
    """Expert weight bundle.  Fake-quant: quantized ``{"up"/"gate": (E, D,
    F), "down": (E, F, D)}`` stacks for ``ragged_dot``.  Packed serving: the
    converter's ``{name}_packed`` stacks — ``(E, d_out, Kw)`` sign words at
    1 bit, ``(E, w_bits, d_out, Kw)`` DoReFa bit planes at k bits — pass
    through untouched to ``dispatch.quant_gemm_grouped``, so only packed
    words reach the GEMM."""
    if "up_packed" in experts:
        return {k: v for k, v in experts.items() if k.endswith("_packed")}
    return {name: _expert_quant(experts[name], ctx, path)
            for name in ("up", "gate", "down")}


def _moe_compute_local(xs_q, gate_w, gate_idx, ew, cfg: MoEConfig, spec,
                       compute_dtype, gemm_config):
    """Sort-based ragged expert compute over all E experts on one device
    (the JAX package's single-device branch: every pair owned, capacity
    ``T*k``).  Returns the gate-weighted combine (T, D)."""
    t, d = xs_q.shape
    k = gate_idx.shape[1]
    e = cfg.e
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # rows of a bucket keep order
    tok_of = order // k
    xs = xs_q[tok_of]  # (T*k, D)
    gs = torch.zeros(e, dtype=torch.int64, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))

    act = ACTIVATIONS[cfg.act]
    if "up_packed" in ew:
        hu, hg = dispatch.quant_gemm_grouped(
            xs.to(torch.float32), (ew["up_packed"], ew["gate_packed"]), gs,
            k_true=d, config=gemm_config, out_dtype=torch.float32,
            w_bits=spec.w_bits, a_bits=spec.a_bits)
        h = act(hg) * hu
        ye = dispatch.quant_gemm_grouped(
            h, ew["down_packed"], gs, k_true=cfg.d_expert, config=gemm_config,
            out_dtype=compute_dtype, w_bits=spec.w_bits, a_bits=spec.a_bits)
    else:
        hu = dispatch.ragged_dot(xs, ew["up"], gs)
        hg = dispatch.ragged_dot(xs, ew["gate"], gs)
        h = act(hg) * hu
        if not spec.is_fp:
            h = quant.quantize_act(h.to(torch.float32), spec.a_bits).to(
                compute_dtype)
        ye = dispatch.ragged_dot(h, ew["down"], gs)  # (T*k, D)

    yw = ye * gate_w.reshape(-1)[order].to(ye.dtype)[:, None]
    # each token's k contributions in ascending sorted position, summed
    # from zero one after another (no atomics: a fixed order on any device)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    ranks, _ = rank.view(t, k).sort(dim=1)
    y = torch.zeros((t, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        y = y + yw[ranks[:, j]]
    return y


def moe_apply(params: Params, x: torch.Tensor, cfg: MoEConfig, ctx: QCtx,
              path: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), Switch load-balance aux loss scalar)."""
    if ctx.mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE (QCtx.mesh) comes with slice 6 of the port")
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)

    probs = _router_probs(params, x2, cfg, ctx, path)  # (T, E)
    gate_w, gate_idx = _top_k(probs, cfg.top_k)  # (T, K)
    if cfg.router_scale_norm:
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)

    spec = ctx.policy.spec(f"{path}/experts")
    a_q = (quant.quantize_act(x2.to(torch.float32), spec.a_bits)
           if not spec.is_fp else x2).to(ctx.compute_dtype)
    ew = _expert_weights(params["experts"], ctx, f"{path}/experts")
    y = _moe_compute_local(a_q, gate_w, gate_idx, ew, cfg, spec,
                           ctx.compute_dtype, ctx.gemm_config)

    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, _shared_cfg(cfg), ctx,
                          f"{path}/shared").reshape(t, d)

    # Switch-style load-balance aux: n_routed * sum_e f_e * p_e
    flat_e = gate_idx.reshape(-1)
    counts = torch.zeros(cfg.e, dtype=torch.int64,
                         device=x.device).scatter_add_(0, flat_e,
                                                       torch.ones_like(flat_e))
    ce = counts.to(torch.float32) / (t * cfg.top_k)
    aux = cfg.n_routed * torch.sum(probs.mean(0) * ce)
    return y.reshape(b, s, d).to(ctx.compute_dtype), aux
