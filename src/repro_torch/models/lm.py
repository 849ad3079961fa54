"""Decoder-only LM for pure attention + MLP stacks (PyTorch port of
``repro.models.lm``: the dense granite/llama family).

Every GEMM goes through ``QCtx.dense``, so one ``QuantPolicy`` turns the
model into its BMXNet-binarized variant.  The hybrid / recurrent / MoE /
vision members of the JAX pool wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.qlayers import dense_init
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import mlp as mlp_lib
from repro_torch.nn.common import QCtx, embed_init, norm_apply, norm_init, softcap

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab_size: int
    attn: attn_lib.AttnConfig
    mlp: mlp_lib.MLPConfig
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    logit_softcap: float | None = None
    # pad the vocab (granite 49155 -> 49408); pad logits are masked to -1e30
    vocab_pad_to: int = 0

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_to:
            m = self.vocab_pad_to
            return (self.vocab_size + m - 1) // m * m
        return self.vocab_size


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init(gen: torch.Generator, cfg: LMConfig,
         dtype=torch.float32) -> Params:
    """Random params at ``cfg``'s widths on ``gen``'s device, in the JAX
    package's layout (dense ``w`` is ``(d_in, d_out)``)."""
    dev = gen.device
    p: Params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)}
    p["layers"] = [
        {
            "pre_norm": norm_init(cfg.norm, cfg.d_model, device=dev),
            "attn": attn_lib.attn_init(gen, cfg.attn, dtype=dtype),
            "pre_ffn_norm": norm_init(cfg.norm, cfg.d_model, device=dev),
            "mlp": mlp_lib.mlp_init(gen, cfg.mlp, dtype=dtype),
        }
        for _ in range(cfg.n_layers)
    ]
    p["final_norm"] = norm_init(cfg.norm, cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                  dtype=dtype)
    return p


# --------------------------------------------------------------------------
# forward (training / prefill)
# --------------------------------------------------------------------------


def _embed(params, cfg: LMConfig, ctx: QCtx, tokens):
    return params["embed"]["table"].to(ctx.compute_dtype)[tokens]


def block_forward(blk, i, x, positions, cfg: LMConfig, ctx: QCtx):
    path = f"layers/{i}"
    h = norm_apply(cfg.norm, blk["pre_norm"], x)
    h = attn_lib.attn_forward(blk["attn"], h, positions, cfg.attn, ctx,
                              f"{path}/attn")
    x = x + h
    h = norm_apply(cfg.norm, blk["pre_ffn_norm"], x)
    h = mlp_lib.mlp_apply(blk["mlp"], h, cfg.mlp, ctx, f"{path}/mlp")
    return x + h


def _logits(params, cfg: LMConfig, ctx: QCtx, x):
    x = norm_apply(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x,
                              params["embed"]["table"].to(x.dtype))
    else:
        logits = ctx.dense(params["lm_head"], x, "lm_head")
    logits = softcap(logits.to(torch.float32), cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(params: Params, cfg: LMConfig, ctx: QCtx,
            tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward.  Returns (logits (B,S,V), aux loss) —
    the aux loss is 0 for dense MLP stacks."""
    x = _embed(params, cfg, ctx, tokens)
    positions = _positions(*tokens.shape, tokens.device)
    for i, blk in enumerate(params["layers"]):
        x = block_forward(blk, i, x, positions, cfg, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _logits(params, cfg, ctx, x), aux


# --------------------------------------------------------------------------
# serving: prefill + decode (contiguous KV cache)
# --------------------------------------------------------------------------


def init_cache(cfg: LMConfig, b: int, cache_len: int, dtype=torch.bfloat16,
               device="cuda") -> Params:
    return {"layers": [attn_lib.CONTIGUOUS.init(b, cfg.attn, cache_len, dtype,
                                                device)
                       for _ in range(cfg.n_layers)]}


def cache_insert(cache: Params, sub: Params, slots: torch.Tensor) -> Params:
    """Write a (G,)-batch prefill cache into G slots of the serving cache
    (in place; ``slots``: (G,) distinct slot indices)."""
    for lc, sub_lc in zip(cache["layers"], sub["layers"]):
        attn_lib.CONTIGUOUS.insert(lc, sub_lc, slots)
    return cache


def cache_reset(cfg: LMConfig, cache: Params, slot: int) -> Params:
    """Retire one serving slot: its attention rows become invisible.  This
    is hygiene; what protects the next occupant is :func:`cache_insert`
    overwriting the ENTIRE slot at admission."""
    for lc in cache["layers"]:
        attn_lib.CONTIGUOUS.reset(lc, slot)
    return cache


def decode_step(params: Params, cfg: LMConfig, ctx: QCtx, cache: Params,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One token for every sequence in the batch.  tokens: (B, 1); pos: (B,)
    absolute position of this token.  Returns (logits (B,1,V), cache); the
    cache is updated in place."""
    x = _embed(params, cfg, ctx, tokens)
    for i, blk in enumerate(params["layers"]):
        path = f"layers/{i}"
        h = norm_apply(cfg.norm, blk["pre_norm"], x)
        h, _ = attn_lib.attn_decode(blk["attn"], h, pos, cache["layers"][i],
                                    cfg.attn, ctx, f"{path}/attn")
        x = x + h
        h = norm_apply(cfg.norm, blk["pre_ffn_norm"], x)
        x = x + mlp_lib.mlp_apply(blk["mlp"], h, cfg.mlp, ctx, f"{path}/mlp")
    return _logits(params, cfg, ctx, x), cache


def prefill(params: Params, cfg: LMConfig, ctx: QCtx, tokens: torch.Tensor,
            cache_len: int):
    """Process the prompt (B, S), build a fresh (B,)-batch cache, return
    (last-position logits (B,1,V), cache)."""
    x = _embed(params, cfg, ctx, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, tokens.device)
    cache = init_cache(cfg, b, cache_len, ctx.compute_dtype, tokens.device)
    acfg = cfg.attn
    for i, blk in enumerate(params["layers"]):
        path = f"layers/{i}"
        h = norm_apply(cfg.norm, blk["pre_norm"], x)
        q, k, v = attn_lib._project_qkv(blk["attn"], h, positions, acfg, ctx,
                                        f"{path}/attn")
        attn_lib.CONTIGUOUS.fill(cache["layers"][i], k, v, positions)
        qg = q.reshape(b, s, acfg.n_kv_heads, acfg.groups, acfg.d_head)
        out = attn_lib._full_sdpa(acfg, qg, k, v, positions, positions)
        out = out.reshape(b, s, acfg.n_heads * acfg.d_head)
        h = ctx.dense(blk["attn"]["o"], out.to(ctx.compute_dtype),
                      f"{path}/attn/o")
        x = x + h
        hf = norm_apply(cfg.norm, blk["pre_ffn_norm"], x)
        x = x + mlp_lib.mlp_apply(blk["mlp"], hf, cfg.mlp, ctx, f"{path}/mlp")
    return _logits(params, cfg, ctx, x[:, -1:, :]), cache
