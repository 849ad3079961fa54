"""Decoder-only LM for attention stacks with a dense or MoE FFN (PyTorch
port of ``repro.models.lm``: the dense granite/llama family and the
deepseek-moe / qwen2-moe family).

Block ``i`` gets its FFN from ``ffn_pattern`` (``"mlp"`` or ``"moe"``);
``first_dense_layers`` keeps a dense ``first_dense_mlp`` for the first
layers of an MoE stack (deepseek-moe).  Every GEMM goes through
``QCtx.dense`` or the MoE's grouped GEMM, so one ``QuantPolicy`` turns the
model into its BMXNet-binarized variant.  ``init_packed`` builds the
converted model one block at a time, so a model whose fp32 weights exceed
the card (qwen2-72b) is never whole in float.  The hybrid / recurrent /
vision members of the JAX pool wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import converter
from repro_torch.core.policy import QuantPolicy
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
    ffn_pattern: tuple[str, ...] = ("mlp",)
    mlp: mlp_lib.MLPConfig | None = None
    moe: mlp_lib.MoEConfig | None = None
    first_dense_layers: int = 0  # deepseek-moe: dense FFN for first layer(s)
    first_dense_mlp: mlp_lib.MLPConfig | None = None
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

    def ffn_kind(self, i: int) -> str:
        k = self.ffn_pattern[i % len(self.ffn_pattern)]
        if k == "moe" and i < self.first_dense_layers:
            return "dense_first"
        return k


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _draw(gen: torch.Generator, cfg: LMConfig, dtype, place) -> Params:
    """Draw ``cfg``'s params from ``gen`` in the one order every build
    shares — the embedding, then block by block, then the head when it is
    untied — and hand each top-level piece to ``place(path, node)`` as soon
    as it is drawn (``path``: ``"embed"``, ``"layers/<i>"``,
    ``"final_norm"``, ``"lm_head"``); the tree keeps what ``place``
    returns."""
    dev = gen.device
    p: Params = {"embed": place("embed", embed_init(gen, cfg.padded_vocab,
                                                    cfg.d_model, dtype))}
    p["layers"] = [place(f"layers/{i}", _block_init(gen, i, cfg, dtype))
                   for i in range(cfg.n_layers)]
    p["final_norm"] = place("final_norm",
                            norm_init(cfg.norm, cfg.d_model, device=dev))
    if not cfg.tie_embeddings:
        p["lm_head"] = place("lm_head", dense_init(
            gen, cfg.d_model, cfg.padded_vocab, dtype=dtype))
    return p


def init(gen: torch.Generator, cfg: LMConfig,
         dtype=torch.float32) -> Params:
    """Random params at ``cfg``'s widths on ``gen``'s device, in the JAX
    package's layout (dense ``w`` is ``(d_in, d_out)``)."""
    return _draw(gen, cfg, dtype, lambda path, node: node)


def init_packed(gen: torch.Generator, cfg: LMConfig,
                policy: QuantPolicy | None, *, draft_layers: int = 0,
                draft_policy: QuantPolicy | None = None):
    """``converter.convert(init(gen, cfg), policy)`` built one piece at a
    time: each block is drawn in fp32, converted under its path and freed
    before the next is drawn, so at most one float block exists at once
    (with the float embedding and head, which the policy keeps float).  The
    result equals the whole-model conversion bit for bit, and so does the
    ``SizeReport`` (fp32 and packed bytes).

    ``draft_layers > 0`` also converts blocks ``< draft_layers`` under
    ``draft_policy`` (default ``QuantPolicy.binary()``) while they are
    still float: the speculative draft ``converter.derive_draft(init(gen,
    cfg), cfg, n_layers=draft_layers, policy=draft_policy)`` gives, sharing
    the embedding, final norm and head tensors with the target.  Returns
    ``(params, report, draft_params)``, ``draft_params`` None without a
    draft.  ``policy`` None builds the draft alone, for a target that comes
    from a packed checkpoint: every block is still drawn, so the draft is
    the one the seed gives, and the target's blocks are dropped as they are
    drawn (``params`` and ``report`` come back None)."""
    if draft_layers:
        converter.draft_depth(cfg.n_layers, draft_layers)
        draft_policy = draft_policy or QuantPolicy.binary()
    report = converter.SizeReport(leaves=[])
    draft: Params = {"layers": []}

    def place(path, node):
        top, _, i = path.partition("/")
        if draft_layers and (not i or int(i) < draft_layers):
            d, _ = converter.convert(node, draft_policy, prefix=path)
            if i:
                draft["layers"].append(d)
            else:
                draft[top] = d
        if policy is None:
            return None
        out, rep = converter.convert(node, policy, prefix=path)
        report.leaves.extend(rep.leaves)
        return out

    params = _draw(gen, cfg, torch.float32, place)
    # derive_draft's key order: the shared pieces, then the blocks
    dparams = ({**{k: draft[k] for k in params if k != "layers"},
                "layers": draft["layers"]} if draft_layers else None)
    if policy is None:
        return None, None, dparams
    return params, report, dparams


def _block_init(gen: torch.Generator, i: int, cfg: LMConfig,
                dtype=torch.float32) -> Params:
    dev = gen.device
    blk: Params = {"pre_norm": norm_init(cfg.norm, cfg.d_model, device=dev),
                   "attn": attn_lib.attn_init(gen, cfg.attn, dtype=dtype),
                   "pre_ffn_norm": norm_init(cfg.norm, cfg.d_model, device=dev)}
    ffn = cfg.ffn_kind(i)
    if ffn == "mlp":
        blk["mlp"] = mlp_lib.mlp_init(gen, cfg.mlp, dtype=dtype)
    elif ffn == "dense_first":
        blk["mlp"] = mlp_lib.mlp_init(gen, cfg.first_dense_mlp, dtype=dtype)
    elif ffn == "moe":
        blk["moe"] = mlp_lib.moe_init(gen, cfg.moe, dtype=dtype)
    else:
        raise ValueError(f"ffn kind {ffn!r} is not in the port yet")
    return blk


# --------------------------------------------------------------------------
# forward (training / prefill)
# --------------------------------------------------------------------------


def _embed(params, cfg: LMConfig, ctx: QCtx, tokens):
    return params["embed"]["table"].to(ctx.compute_dtype)[tokens]


def _ffn_forward(blk, i, x, cfg: LMConfig, ctx: QCtx, path: str):
    """Block ``i``'s FFN on its normed input: (output, aux loss)."""
    kind = cfg.ffn_kind(i)
    if kind == "moe":
        return mlp_lib.moe_apply(blk["moe"], x, cfg.moe, ctx, f"{path}/moe")
    mcfg = cfg.first_dense_mlp if kind == "dense_first" else cfg.mlp
    return mlp_lib.mlp_apply(blk["mlp"], x, mcfg, ctx, f"{path}/mlp"), 0.0


def block_forward(blk, i, x, positions, cfg: LMConfig, ctx: QCtx):
    path = f"layers/{i}"
    h = norm_apply(cfg.norm, blk["pre_norm"], x)
    h = attn_lib.attn_forward(blk["attn"], h, positions, cfg.attn, ctx,
                              f"{path}/attn")
    x = x + h
    h = norm_apply(cfg.norm, blk["pre_ffn_norm"], x)
    h, aux = _ffn_forward(blk, i, h, cfg, ctx, path)
    return x + h, aux


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


def forward(params: Params, cfg: LMConfig, ctx: QCtx, tokens: torch.Tensor,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward.  Returns (logits (B,S,V), aux loss):
    the sum of the MoE layers' load-balance losses, 0 for dense stacks.

    ``remat`` runs each block under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint``): the backward pass keeps only the blocks'
    inputs and recomputes one block at a time.  The recomputation repeats
    the forward bit for bit (MoE routing included: top-k is a stable sort).
    The JAX function's ``scan_blocks`` and ``seq_parallel`` are XLA / GSPMD
    lowering patterns (a ``lax.scan`` over stacked layers, sequence-sharding
    constraints); the port has neither argument."""
    x = _embed(params, cfg, ctx, tokens)
    positions = _positions(*tokens.shape, tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, blk in enumerate(params["layers"]):
        if remat:
            x, aux = checkpoint(block_forward, blk, i, x, positions, cfg, ctx,
                                use_reentrant=False)
        else:
            x, aux = block_forward(blk, i, x, positions, cfg, ctx)
        aux_total = aux_total + aux
    return _logits(params, cfg, ctx, x), aux_total


# --------------------------------------------------------------------------
# serving: prefill + decode + windows
# --------------------------------------------------------------------------


def init_cache(cfg: LMConfig, b: int, cache_len: int, dtype=torch.bfloat16,
               device="cuda", kv: attn_lib.KVCache | None = None) -> Params:
    """``kv`` selects the attention cache layout (default contiguous)."""
    kv = attn_lib.CONTIGUOUS if kv is None else kv
    return {"layers": [kv.init(b, cfg.attn, cache_len, dtype, device)
                       for _ in range(cfg.n_layers)]}


def cache_insert(cache: Params, sub: Params, slots: torch.Tensor,
                 kv: attn_lib.KVCache | None = None) -> Params:
    """Write a (G,)-batch contiguous fp prefill cache into G slots of the
    serving cache (in place; ``slots``: (G,) distinct slot indices).
    Contiguous layout: a full-slot overwrite whose ``slot_pos = -1`` rows
    past the prompt retire the previous occupant's stale rows.  Paged
    layout: the sub-cache's valid rows scatter into the slots' mapped
    blocks, which the allocator pos-reset at admission."""
    kv = attn_lib.CONTIGUOUS if kv is None else kv
    for lc, sub_lc in zip(cache["layers"], sub["layers"]):
        kv.insert(lc, sub_lc, slots)
    return cache


def cache_reset(cfg: LMConfig, cache: Params, slot: int,
                kv: attn_lib.KVCache | None = None) -> Params:
    """Retire one serving slot: its attention rows become invisible
    (``slot_pos = -1`` / table row unmapped).  On the contiguous layout this
    is hygiene — what protects the next occupant is :func:`cache_insert`
    overwriting the ENTIRE slot at admission; on the paged layout junk
    writes would land in blocks that may belong to another slot, so the
    scheduler also write-masks retired rows (``decode_step(...,
    write_mask=active)``)."""
    kv = attn_lib.CONTIGUOUS if kv is None else kv
    for lc in cache["layers"]:
        kv.reset(lc, slot)
    return cache


def cache_truncate(cfg: LMConfig, cache: Params, lengths: torch.Tensor,
                   kv: attn_lib.KVCache | None = None) -> Params:
    """Per-row KV rollback for speculative decoding (in place): row b keeps
    its first ``lengths[b]`` positions, and every position ``>= lengths[b]``
    becomes invisible again (``kv.truncate`` per attention layer).  Rows
    whose cache is already shorter are untouched, so one batch-wide call
    covers ragged accept lengths.  Pure-attention stacks only: recurrent
    state has no per-position rollback (the port's stacks are all
    attention; a layer cache without positions raises)."""
    kv = attn_lib.CONTIGUOUS if kv is None else kv
    for i, lc in enumerate(cache["layers"]):
        if "slot_pos" not in lc and "pool_pos" not in lc:
            raise ValueError(f"cache_truncate supports pure-attention stacks; "
                             f"layer {i} holds no KV positions")
        kv.truncate(lc, lengths)
    return cache


def decode_step(params: Params, cfg: LMConfig, ctx: QCtx, cache: Params,
                tokens: torch.Tensor, pos: torch.Tensor,
                kv: attn_lib.KVCache | None = None,
                write_mask: torch.Tensor | None = None):
    """One token for every sequence in the batch.  tokens: (B, 1); pos: (B,)
    absolute position of this token; ``kv`` the cache layout;
    ``write_mask`` (B,) bool drops inactive rows' cache writes.  Returns
    (logits (B,1,V), cache); the cache is updated in place."""
    x = _embed(params, cfg, ctx, tokens)
    for i, blk in enumerate(params["layers"]):
        path = f"layers/{i}"
        h = norm_apply(cfg.norm, blk["pre_norm"], x)
        h, _ = attn_lib.attn_decode(blk["attn"], h, pos, cache["layers"][i],
                                    cfg.attn, ctx, f"{path}/attn", kv=kv,
                                    write_mask=write_mask)
        x = x + h
        h = norm_apply(cfg.norm, blk["pre_ffn_norm"], x)
        x = x + _ffn_forward(blk, i, h, cfg, ctx, path)[0]
    return _logits(params, cfg, ctx, x), cache


def decode_window(params: Params, cfg: LMConfig, ctx: QCtx, cache: Params,
                  tokens: torch.Tensor, pos_start: torch.Tensor,
                  kv: attn_lib.KVCache,
                  write_mask: torch.Tensor | None = None,
                  logits_all: bool = False):
    """A C-token window for every batch row against the cache: the serving
    primitive behind chunked prefill, decode (its C == 1 case) and the
    speculative verify.  Row b's tokens (B, C) sit at positions
    ``pos_start[b] + [0..C)``; their k/v are stored through
    ``kv.fill_window`` and attention runs over the whole cache, so a chunk
    attends to everything already cached for its slot (earlier chunks,
    shared-prefix blocks) plus itself.  Rows with ``write_mask=False``
    compute junk and write nothing.  Returns the LAST-position logits
    (B, 1, V) — the only ones admission samples from — and the cache,
    updated in place.

    ``logits_all=True`` is the speculative window: it returns every
    position's logits (B, C, V), with which the target scores all its
    proposals in one call (row c conditions on window tokens <= c through
    the causal mask: the sequential decode distribution at each position).
    Its fp32 reductions (the norms, attention, the logits product) then run
    one position at a time at a decode step's shapes, so each row gives the
    decode step's bits: on the card those reductions' order depends on the
    number of rows, and in a binarized stack one flipped sign changes the
    stream.  The packed GEMMs, exact integers at any M, still run once over
    all B*C rows."""
    c = tokens.shape[1]
    x = _embed(params, cfg, ctx, tokens)
    positions = (pos_start.to(torch.int32)[:, None]
                 + torch.arange(c, dtype=torch.int32, device=tokens.device))

    def per_position(fn, x):
        if not logits_all:
            return fn(x)
        return torch.cat([fn(x[:, j:j + 1].contiguous()) for j in range(c)],
                         dim=1)

    for i, blk in enumerate(params["layers"]):
        path = f"layers/{i}"
        h = per_position(lambda r: norm_apply(cfg.norm, blk["pre_norm"], r), x)
        h, _ = attn_lib.attn_window(blk["attn"], h, positions,
                                    cache["layers"][i], cfg.attn, ctx,
                                    f"{path}/attn", kv, write_mask=write_mask,
                                    per_position=logits_all)
        x = x + h
        h = per_position(lambda r: norm_apply(cfg.norm, blk["pre_ffn_norm"], r),
                         x)
        x = x + _ffn_forward(blk, i, h, cfg, ctx, path)[0]
    if not logits_all:
        x = x[:, -1:, :]
    return per_position(lambda r: _logits(params, cfg, ctx, r), x), cache


def prefill(params: Params, cfg: LMConfig, ctx: QCtx, tokens: torch.Tensor,
            cache_len: int):
    """Process the prompt (B, S), build a fresh (B,)-batch contiguous fp
    cache, return (last-position logits (B,1,V), cache)."""
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
        # s <= full_attn_max_seq: _sdpa, else _sdpa_chunked (JAX's routing)
        out = attn_lib._full_sdpa(acfg, qg, k, v, positions, positions)
        out = out.reshape(b, s, acfg.n_heads * acfg.d_head)
        h = ctx.dense(blk["attn"]["o"], out.to(ctx.compute_dtype),
                      f"{path}/attn/o")
        x = x + h
        hf = norm_apply(cfg.norm, blk["pre_ffn_norm"], x)
        x = x + _ffn_forward(blk, i, hf, cfg, ctx, path)[0]
    return _logits(params, cfg, ctx, x[:, -1:, :]), cache
