"""Attention for pure attention + MLP stacks (PyTorch port of the gather
path of ``repro.nn.attention``): MHA/GQA with a grouped einsum (KV is never
materialised per query head), causal / sliding-window masks from absolute
positions, logit softcap, QKV bias, RoPE, and the contiguous KV cache with
per-batch positions.

All projections run through ``QCtx.dense`` => they obey the BMXNet
quantization policy like every other GEMM.

Not in this slice: the fused flash-decode kernel (``fused_attn=True``),
quantized KV storage (``kv_bits``) and the paged cache — slice 3 — and
``_sdpa_chunked`` for prefill longer than ``full_attn_max_seq``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.qlayers import dense_init
from repro_torch.nn.common import QCtx, rope, softcap

Params = dict[str, Any]

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    use_rope: bool = True
    qkv_bias: bool = False
    logit_softcap: float | None = None
    window: int | None = None  # sliding window; None = global
    causal: bool = True
    query_scale: float | None = None  # default d_head ** -0.5
    full_attn_max_seq: int = 4096
    fused_attn: bool = False  # the flash-decode kernel: slice 3
    kv_bits: int | None = None  # quantized KV storage: slice 3

    def __post_init__(self):
        if self.fused_attn:
            raise NotImplementedError(
                "fused_attn (the flash-decode kernel) comes with slice 3 of "
                "the port; the gather + _sdpa path serves this slice")
        if self.kv_bits is not None:
            raise NotImplementedError(
                "quantized KV storage (kv_bits) comes with slice 3 of the port")

    @property
    def groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def scale(self) -> float:
        return self.query_scale if self.query_scale is not None else self.d_head**-0.5


def attn_init(gen: torch.Generator, cfg: AttnConfig, *,
              dtype=torch.float32) -> Params:
    h, kvh, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    return {
        "q": dense_init(gen, d, h * dh, bias=cfg.qkv_bias, dtype=dtype),
        "k": dense_init(gen, d, kvh * dh, bias=cfg.qkv_bias, dtype=dtype),
        "v": dense_init(gen, d, kvh * dh, bias=cfg.qkv_bias, dtype=dtype),
        "o": dense_init(gen, h * dh, d, dtype=dtype),
    }


def _project_qkv(params, x, positions, cfg: AttnConfig, ctx: QCtx, path: str):
    b, s, _ = x.shape
    q = ctx.dense(params["q"], x, f"{path}/q").reshape(b, s, cfg.n_heads, cfg.d_head)
    k = ctx.dense(params["k"], x, f"{path}/k").reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = ctx.dense(params["v"], x, f"{path}/v").reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(cfg: AttnConfig, q_pos, k_pos):
    """(..., Sq, Sk) bool validity mask from absolute positions."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                   device=qp.device)
    if cfg.causal:
        m &= kp <= qp
    if cfg.window is not None:
        m &= kp > qp - cfg.window
    m &= kp >= 0  # empty cache slots carry position -1
    return m


def _sdpa(cfg: AttnConfig, q, k, v, mask):
    """Grouped scaled-dot-product attention with softcap.

    q: (B, Sq, KVH, G, Dh); k, v: (B, Sk, KVH, Dh); mask: (B, Sq, Sk) bool.
    Returns (B, Sq, KVH, G, Dh).
    """
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                          k.to(torch.float32)) * cfg.scale
    scores = softcap(scores, cfg.logit_softcap)
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)
    scores = torch.where(mask[:, None, None, :, :], scores, neg)
    p = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def attn_forward(params: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: AttnConfig, ctx: QCtx, path: str) -> torch.Tensor:
    """Full-sequence self-attention forward (training / prefill)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, positions, cfg, ctx, path)
    qg = q.reshape(b, s, cfg.n_kv_heads, cfg.groups, cfg.d_head)
    out = _full_sdpa(cfg, qg, k, v, positions, positions)
    out = out.reshape(b, s, cfg.n_heads * cfg.d_head).to(ctx.compute_dtype)
    return ctx.dense(params["o"], out, f"{path}/o")


def _full_sdpa(cfg: AttnConfig, qg, k, v, q_pos, k_pos):
    if max(qg.shape[1], k.shape[1]) > cfg.full_attn_max_seq:
        raise NotImplementedError(
            f"sequence longer than full_attn_max_seq={cfg.full_attn_max_seq} "
            "needs _sdpa_chunked, which the port does not have yet")
    return _sdpa(cfg, qg, k, v, _mask(cfg, q_pos, k_pos))


# --------------------------------------------------------------------------
# KV cache (decode) — the contiguous layout
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ContiguousKVCache:
    """Per-slot contiguous storage: ``k``/``v`` (B, cache_len, KVH, Dh) +
    ``slot_pos`` (B, cache_len) int32 absolute positions (-1 = empty).
    The cache state is a plain dict of tensors; unlike the JAX package the
    methods write it IN PLACE (and return it): the decode write is an index
    write, not the one-hot select the JAX package uses to stay SPMD-safe
    under GSPMD.  Local (sliding-window) layers use cache_len == window as a
    ring."""

    kv_bits: int | None = None

    def __post_init__(self):
        if self.kv_bits is not None:
            raise NotImplementedError(
                "quantized KV storage (kv_bits) comes with slice 3 of the port")

    def init(self, b: int, cfg: AttnConfig, cache_len: int,
             dtype=torch.bfloat16, device="cuda") -> Params:
        shape = (b, cache_len, cfg.n_kv_heads, cfg.d_head)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((b, cache_len), -1, dtype=torch.int32,
                                   device=device),
        }

    def insert(self, cache: Params, sub: Params,
               slots: torch.Tensor) -> Params:
        """Write the G batch rows of a prefill sub-cache into batch slots
        ``slots`` ((G,) distinct indices).  The inserted ``slot_pos`` rows
        carry -1 beyond the prompt, which retires the previous occupant's
        stale rows: admission overwrites the WHOLE slot."""
        for name, big in cache.items():
            big[slots] = sub[name].to(big.dtype)
        return cache

    def reset(self, cache: Params, slot: int) -> Params:
        """Retire one batch slot: every row of it becomes empty
        (``slot_pos = -1``); K/V bytes stay and the next occupant's
        full-slot insert overwrites them."""
        cache["slot_pos"][slot] = -1
        return cache

    def fill(self, cache: Params, k, v, positions) -> Params:
        """Store projected k/v (B, S, KVH, Dh) at absolute ``positions``
        (B, S).  Slots are ``pos % cache_len`` (a ring for local layers).
        S == 1 (decode, per-row positions) is an index write; S > 1
        (prefill) assumes the standard arange positions: a slice write, or
        the last cache_len tokens rolled into place when S > cache_len."""
        cache_len = cache["slot_pos"].shape[1]
        s = k.shape[1]
        new = {"k": k, "v": v, "slot_pos": positions}
        if s == 1:
            rows = torch.arange(k.shape[0], device=k.device)
            slots = positions[:, 0].long() % cache_len
            for name, val in new.items():
                cache[name][rows, slots] = val[:, 0].to(cache[name].dtype)
            return cache
        if s <= cache_len:
            for name, val in new.items():
                cache[name][:, :s] = val.to(cache[name].dtype)
            return cache
        # ring wrap: token at position p lands in slot p % cache_len
        shift = (s - cache_len) % cache_len
        for name, val in new.items():
            cache[name].copy_(torch.roll(val[:, s - cache_len:], shift, dims=1))
        return cache

    def gather(self, cache: Params):
        return cache["k"], cache["v"], cache["slot_pos"]


CONTIGUOUS = ContiguousKVCache()


@dataclasses.dataclass(frozen=True)
class PagedKVCache:
    """The block-table paged pool — slice 3 of the port."""

    block_size: int = 16
    kv_bits: int | None = None

    def __post_init__(self):
        raise NotImplementedError(
            "PagedKVCache (block-table paged KV) comes with slice 3 of the "
            "port; use the contiguous cache")


def attn_decode(params: Params, x: torch.Tensor, pos: torch.Tensor,
                cache: Params, cfg: AttnConfig, ctx: QCtx, path: str,
                *, kv: ContiguousKVCache | None = None):
    """One decode step against the cache on the gather + ``_sdpa`` path.
    x: (B, 1, D); pos: (B,) position of this token.  Returns (out (B,1,D),
    cache) — the cache is updated in place."""
    kv = CONTIGUOUS if kv is None else kv
    b = x.shape[0]
    positions = pos[:, None]
    q, k_new, v_new = _project_qkv(params, x, positions, cfg, ctx, path)
    cache = kv.fill(cache, k_new, v_new, positions)
    qg = q.reshape(b, 1, cfg.n_kv_heads, cfg.groups, cfg.d_head)
    k, v, k_pos = kv.gather(cache)
    out = _sdpa(cfg, qg, k, v, _mask(cfg, positions, k_pos))
    out = out.reshape(b, 1, cfg.n_heads * cfg.d_head).to(ctx.compute_dtype)
    return ctx.dense(params["o"], out, f"{path}/o"), cache
