"""Attention for pure attention + MLP stacks (PyTorch port of
``repro.nn.attention``): MHA/GQA with a grouped einsum (KV is never
materialised per query head), causal / sliding-window masks from absolute
positions, logit softcap, QKV bias, RoPE, and the KV cache in two layouts —
contiguous per-slot slabs and the block-table paged pool — each optionally
storing K/V quantized (``kv_bits``).  Decode and window attention read the
cache through the gather + ``_sdpa`` oracle, or through the fused
flash-decode kernel (``fused_attn``, ``kernels/attn_decode.py``).

All projections run through ``QCtx.dense`` => they obey the BMXNet
quantization policy like every other GEMM.

The speculative-decoding cache operations are here too: ``fill_window`` at
per-row window starts on both layouts (the verify window and the draft's
restart window) and ``truncate``, the per-row rollback that flips positions
past a row's accepted length back to empty.

Sequences longer than ``full_attn_max_seq`` (training forward and prefill)
go through ``_sdpa_chunked``, an online softmax over query and KV chunks
whose score memory is ``chunk_q * chunk_kv`` per head, in plain PyTorch as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.qlayers import dense_init
from repro_torch.kernels import attn_decode as attn_kernels
from repro_torch.kernels.attn_decode import (kv_code_shapes, kv_dequantize,
                                             kv_quantize)
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
    # chunked-path knobs: longer sequences take _sdpa_chunked
    full_attn_max_seq: int = 4096
    chunk_q: int = 512
    chunk_kv: int = 1024
    # decode-attention execution (serving): route attn_decode / attn_window
    # through the flash-decode kernel (kernels/attn_decode.py) instead of
    # gather + _sdpa.  False keeps the gather path, the oracle the fused
    # kernel is held against.
    fused_attn: bool = False
    # KV-cache storage tier: None = fp compute dtype; 8 = int8 codes +
    # per-(head, dh-group) absmax scales; 1 = packed sign bytes + per-head
    # alpha (the XNOR tier).  The cache layout carrying the same value
    # quantises on write; gather() dequantises, so the oracle path reads the
    # identical quantized storage.
    kv_bits: int | None = None

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
    """Full-sequence attention: ``_sdpa`` up to ``full_attn_max_seq``
    positions, ``_sdpa_chunked`` beyond (the JAX package's routing)."""
    if max(qg.shape[1], k.shape[1]) <= cfg.full_attn_max_seq:
        return _sdpa(cfg, qg, k, v, _mask(cfg, q_pos, k_pos))
    return _sdpa_chunked(cfg, qg, k, v, q_pos, k_pos)


def _sdpa_chunked(cfg: AttnConfig, q, k, v, q_pos, k_pos):
    """Online-softmax attention, O(chunk_q * chunk_kv) score memory.

    Same signature and semantics as ``_sdpa`` with the mask derived from
    positions; both sequence axes run in chunks (the flash-attention
    recurrence in plain PyTorch, as JAX's pure-jnp version).  KV is padded
    to a chunk multiple with pad positions -1.  A row that sees no key in
    any chunk ends as the mean of the chunks' values, as in JAX.
    """
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    cq, ck = min(cfg.chunk_q, sq), min(cfg.chunk_kv, sk)
    if sq % cq:
        raise ValueError(f"_sdpa_chunked: {sq} query positions are not a "
                         f"multiple of chunk_q {cq}")
    if sk % ck:  # pad KV to a chunk multiple; pad slots masked via pos=-1
        pad = ck - sk % ck
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
        sk += pad
    q32 = q.to(torch.float32)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    outs = []
    for i in range(0, sq, cq):
        qi, qp = q32[:, i:i + cq], q_pos[:, i:i + cq]
        m_run = torch.full((b, kvh, g, cq), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((b, kvh, g, cq), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((b, kvh, g, cq, dh), dtype=torch.float32,
                          device=q.device)
        for j in range(0, sk, ck):
            ki, vi, kp = k[:, j:j + ck], v[:, j:j + ck], k_pos[:, j:j + ck]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi,
                             ki.to(torch.float32)) * cfg.scale
            s = softcap(s, cfg.logit_softcap)
            valid = _mask(cfg, qp, kp)  # (b, cq, ck)
            s = torch.where(valid[:, None, None, :, :], s, neg)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vi.dtype), vi).to(torch.float32)
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-37)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (b, cq, kvh, g, dh)
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# KV cache (decode) — one KVCache API, two layouts
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVCache:
    """Layout handle for attention KV caches.

    An instance is a static descriptor; the cache state is a plain dict of
    tensors.  Unlike the JAX package the methods write that dict IN PLACE
    (and return it): index writes and scatters instead of the one-hot
    selects the JAX package uses to stay SPMD-safe under GSPMD.  Both
    layouts implement the same surface, so model code never branches on
    the layout:

    * ``init(b, cfg, cache_len, dtype, device)`` -> empty cache
    * ``insert(cache, sub, slots)`` -> write a (G,)-batch contiguous fp
      prefill sub-cache into G batch slots (admission)
    * ``reset(cache, slot)`` -> retire one slot (rows become invisible to
      :func:`_mask`)
    * ``fill(cache, k, v, positions, write_mask=None)`` -> store projected
      k/v at absolute positions
    * ``fill_window(...)`` -> the same at arbitrary per-row window starts
      (chunked prefill, the speculative verify and draft windows)
    * ``truncate(cache, lengths)`` -> per-row rollback: positions
      ``>= lengths[b]`` of row b become empty again
    * ``gather(cache)`` -> dense ``(k, v, pos)`` views ``(B, L, KVH, Dh) x2
      + (B, L)`` that ``_sdpa`` consumes (dequantized)
    * ``attend(cache, q, q_pos, cfg)`` -> the fused flash-decode kernel on
      the layout's own storage; value-equivalent to ``_sdpa`` over
      ``gather`` under :func:`_mask`

    Quantized tiers (``kv_bits``) store codes in the K/V leaves and scales
    in leaves beside them, written by the same index writes, so a block and
    its scales never go out of sync; visibility (``reset``, ``truncate``)
    only touches the position plane."""

    def fill_window(self, cache: Params, k, v, positions,
                    write_mask: torch.Tensor | None = None) -> Params:
        """Window write at arbitrary per-row start positions.  The paged
        scatter handles that natively."""
        return self.fill(cache, k, v, positions, write_mask)


@dataclasses.dataclass(frozen=True)
class ContiguousKVCache(KVCache):
    """Per-slot contiguous storage: ``k``/``v`` (B, cache_len, KVH, Dh) +
    ``slot_pos`` (B, cache_len) int32 absolute positions (-1 = empty), plus
    ``k_scale``/``v_scale`` when ``kv_bits`` stores codes.  Local
    (sliding-window) layers use cache_len == window as a ring."""

    kv_bits: int | None = None

    def _encode(self, k, v) -> Params:
        """Projected fp k/v (B, S, KVH, Dh) -> the storage leaves this
        layout persists for them (codes + scales under ``kv_bits``)."""
        if self.kv_bits is None:
            return {"k": k, "v": v}
        kc, ks = kv_quantize(self.kv_bits, k)
        vc, vs = kv_quantize(self.kv_bits, v)
        return {"k": kc, "k_scale": ks, "v": vc, "v_scale": vs}

    def init(self, b: int, cfg: AttnConfig, cache_len: int,
             dtype=torch.bfloat16, device="cuda") -> Params:
        (code, cdt), sc = kv_code_shapes(self.kv_bits, cfg.n_kv_heads,
                                         cfg.d_head, dtype)
        out = {
            "k": torch.zeros((b, cache_len) + code, dtype=cdt, device=device),
            "v": torch.zeros((b, cache_len) + code, dtype=cdt, device=device),
            "slot_pos": torch.full((b, cache_len), -1, dtype=torch.int32,
                                   device=device),
        }
        if sc is not None:
            for name in ("k_scale", "v_scale"):
                out[name] = torch.zeros((b, cache_len) + sc[0], dtype=sc[1],
                                        device=device)
        return out

    def insert(self, cache: Params, sub: Params,
               slots: torch.Tensor) -> Params:
        """Write the G batch rows of a contiguous fp prefill sub-cache into
        batch slots ``slots`` ((G,) distinct indices), encoding its k/v
        under ``kv_bits``.  The inserted ``slot_pos`` rows carry -1 beyond
        the prompt, which retires the previous occupant's stale rows:
        admission overwrites the WHOLE slot."""
        new = {**self._encode(sub["k"], sub["v"]), "slot_pos": sub["slot_pos"]}
        for name, big in cache.items():
            big[slots] = new[name].to(big.dtype)
        return cache

    def reset(self, cache: Params, slot: int) -> Params:
        """Retire one batch slot: every row of it becomes empty
        (``slot_pos = -1``); K/V bytes stay and the next occupant's
        full-slot insert overwrites them."""
        cache["slot_pos"][slot] = -1
        return cache

    def fill(self, cache: Params, k, v, positions,
             write_mask: torch.Tensor | None = None) -> Params:
        """Store projected k/v (B, S, KVH, Dh) at absolute ``positions``
        (B, S).  Slots are ``pos % cache_len`` (a ring for local layers).
        S == 1 (decode, per-row positions) is :meth:`fill_window`'s index
        write, which skips ``write_mask=False`` rows; S > 1 (prefill)
        assumes the standard arange positions: a slice write, or the last
        cache_len tokens rolled into place when S > cache_len.  The prefill paths ignore
        ``write_mask``: storage is slot-private and admission's full-slot
        ``insert`` overwrites any junk."""
        cache_len = cache["slot_pos"].shape[1]
        s = k.shape[1]
        if s == 1:
            return self.fill_window(cache, k, v, positions, write_mask)
        new = {**self._encode(k, v), "slot_pos": positions}
        if s <= cache_len:
            for name, val in new.items():
                cache[name][:, :s] = val.to(cache[name].dtype)
            return cache
        # ring wrap: token at position p lands in slot p % cache_len
        shift = (s - cache_len) % cache_len
        for name, val in new.items():
            cache[name].copy_(torch.roll(val[:, s - cache_len:], shift, dims=1))
        return cache

    def fill_window(self, cache: Params, k, v, positions,
                    write_mask: torch.Tensor | None = None) -> Params:
        """A C-token window at per-row starts (speculative verify, the
        draft's restart window; C == 1 is a decode step): window token c of
        row b lands in slot ``positions[b, c] % cache_len``, every leaf
        (codes, scales, ``slot_pos``) by one index write.  The JAX package
        writes through a one-hot einsum, which selects exactly one addend
        per slot: the same bits, save that its +0 addends can turn a stored
        -0.0 into +0.0 (ROADMAP C).  Rows with ``write_mask=False`` write
        their slots' current values back, so they stay untouched without a
        boolean index (which would read the mask on the host).  A row's
        window positions are consecutive and at most ``cache_len`` long, so
        no two writes hit one slot."""
        b, c = positions.shape
        cache_len = cache["slot_pos"].shape[1]
        rows = torch.arange(b, device=k.device)[:, None].expand(b, c)
        slots = positions.long() % cache_len
        for name, val in {**self._encode(k, v), "slot_pos": positions}.items():
            leaf = cache[name]
            val = val.to(leaf.dtype)
            if write_mask is not None:
                keep = write_mask.view((b, 1) + (1,) * (val.ndim - 2))
                val = torch.where(keep, val, leaf[rows, slots])
            leaf[rows, slots] = val
        return cache

    def truncate(self, cache: Params, lengths: torch.Tensor) -> Params:
        """Rows at positions ``>= lengths[b]`` flip to ``slot_pos = -1``:
        invisible to :func:`_mask` and rewritten in place by the next window
        before it is read.  K/V bytes stay, as in :meth:`reset`."""
        sp = cache["slot_pos"]
        sp.masked_fill_(sp >= lengths.to(sp.dtype)[:, None], -1)
        return cache

    def gather(self, cache: Params):
        if self.kv_bits is None:
            return cache["k"], cache["v"], cache["slot_pos"]
        dh = cache["k"].shape[-1] * (8 if self.kv_bits == 1 else 1)
        k = kv_dequantize(self.kv_bits, cache["k"], cache["k_scale"], dh)
        v = kv_dequantize(self.kv_bits, cache["v"], cache["v_scale"], dh)
        return k, v, cache["slot_pos"]

    def attend(self, cache: Params, q, q_pos, cfg: AttnConfig):
        b, c = q_pos.shape
        tile = attn_kernels.select_attn_tiles(
            b, c, cache["slot_pos"].shape[1], cfg.d_head, "ctg")
        return attn_kernels.flash_decode_contig(
            q.to(torch.float32).contiguous(), q_pos.to(torch.int32),
            cache["k"], cache["v"], cache["slot_pos"], cache.get("k_scale"),
            cache.get("v_scale"), kv_bits=self.kv_bits, sm_scale=cfg.scale,
            logit_softcap=cfg.logit_softcap, causal=cfg.causal,
            window=cfg.window, kv_tile=tile)


@dataclasses.dataclass(frozen=True)
class PagedKVCache(KVCache):
    """Block-table paged storage over a shared pool.

    Leaves: ``pool_k``/``pool_v`` (num_blocks, block_size, KVH, Dh) (codes
    under ``kv_bits``, with scale pools ``pool_ks``/``pool_vs`` riding the
    same flat-index scatters), ``pool_pos`` (num_blocks, block_size) int32
    absolute token positions (-1 = empty), ``table`` (B, blocks_per_slot)
    int32 block ids (-1 = unmapped — the whole entry is invisible).  The
    token at slot-local position ``p`` lives in block ``table[b, p //
    block_size]`` at offset ``p % block_size``, so ``gather`` reassembles
    each slot's tokens in position order — value-identical to the
    contiguous layout's storage, which is what makes paged serving emit the
    contiguous greedy tokens.

    The host-side allocator (``serve/engine.BlockAllocator``) rewrites
    table rows and resets freshly allocated blocks' ``pool_pos`` at
    admission; fill / gather / attend only follow the table.  Invariants
    the allocator keeps:

    * a block is written by at most one slot position range; shared
      prompt-prefix blocks are never written (chunked prefill starts at the
      first novel token and decode writes at pos >= prompt_len);
    * freshly allocated blocks get ``pool_pos = -1`` before the table row
      lands, so a previous occupant's stale keys are invisible;
    * retired slots keep decoding junk in the batch-wide step; their writes
      MUST be dropped (``write_mask``), because their freed blocks may
      already belong to another slot.
    """

    block_size: int = 16
    kv_bits: int | None = None

    def _encode(self, k, v) -> Params:
        """Projected fp k/v (B, S, KVH, Dh) -> the pool leaves this layout
        persists for them (codes + scale pools under ``kv_bits``)."""
        if self.kv_bits is None:
            return {"pool_k": k, "pool_v": v}
        kc, ks = kv_quantize(self.kv_bits, k)
        vc, vs = kv_quantize(self.kv_bits, v)
        return {"pool_k": kc, "pool_ks": ks, "pool_v": vc, "pool_vs": vs}

    def _scatter(self, cache: Params, flat, enc: Params, positions) -> Params:
        """Scatter encoded (B, S, ...) leaves + positions to flattened pool
        indices ``flat`` ((B*S,); invalid -> nb*bs and dropped, as JAX's
        ``mode='drop'``)."""
        nb, bs = cache["pool_pos"].shape
        keep = flat < nb * bs
        idx = flat[keep]
        for name, val in {**enc, "pool_pos": positions}.items():
            pool = cache[name]
            rows = val.reshape((flat.shape[0],) + pool.shape[2:])[keep]
            pool.view((nb * bs,) + pool.shape[2:])[idx] = rows.to(pool.dtype)
        return cache

    def _flat(self, cache: Params, positions, write_mask):
        """(B, S) flattened pool indices; invalid / masked writes -> index
        num_blocks * block_size, which the scatter drops."""
        bs = self.block_size
        table = cache["table"]
        bps = table.shape[1]
        nb = cache["pool_pos"].shape[0]
        positions = positions.long()
        blk_idx = torch.clamp(positions // bs, 0, bps - 1)  # (B, S)
        blk = torch.take_along_dim(table.long(), blk_idx, dim=1)  # (B, S)
        valid = (positions >= 0) & (positions < bps * bs) & (blk >= 0)
        if write_mask is not None:
            valid &= write_mask[:, None]
        flat = torch.clamp(blk, min=0) * bs + positions % bs
        return torch.where(valid, flat, torch.full_like(flat, nb * bs))

    def init(self, b: int, cfg: AttnConfig, cache_len: int,
             dtype=torch.bfloat16, device="cuda") -> Params:
        bs = self.block_size
        if cache_len % bs:
            raise ValueError(
                f"cache_len {cache_len} not a multiple of kv block size {bs}")
        bps = cache_len // bs
        nb = b * bps  # the contiguous layout's exact footprint
        (code, cdt), sc = kv_code_shapes(self.kv_bits, cfg.n_kv_heads,
                                         cfg.d_head, dtype)
        out = {
            "pool_k": torch.zeros((nb, bs) + code, dtype=cdt, device=device),
            "pool_v": torch.zeros((nb, bs) + code, dtype=cdt, device=device),
            "pool_pos": torch.full((nb, bs), -1, dtype=torch.int32,
                                   device=device),
            "table": torch.full((b, bps), -1, dtype=torch.int32, device=device),
        }
        if sc is not None:
            for name in ("pool_ks", "pool_vs"):
                out[name] = torch.zeros((nb, bs) + sc[0], dtype=sc[1],
                                        device=device)
        return out

    def insert(self, cache: Params, sub: Params,
               slots: torch.Tensor) -> Params:
        """Write a (G, L, ...) contiguous prefill sub-cache into the G
        slots' mapped blocks (positions from ``sub['slot_pos']``; -1 rows
        are dropped — freshly allocated blocks were already pos-reset by
        the allocator)."""
        pos = sub["slot_pos"]
        flat = self._flat({**cache, "table": cache["table"][slots]}, pos, None)
        return self._scatter(cache, flat.reshape(-1),
                             self._encode(sub["k"], sub["v"]), pos)

    def reset(self, cache: Params, slot: int) -> Params:
        """Retire one slot: unmap its table row (-1).  Block bookkeeping is
        the host allocator's job; pool bytes are untouched, so a block
        shared with a live slot keeps serving its holder."""
        cache["table"][slot] = -1
        return cache

    def fill(self, cache: Params, k, v, positions,
             write_mask: torch.Tensor | None = None) -> Params:
        """Scatter k/v/pos through the block table.  Distinct (row, pos)
        pairs hit distinct pool entries (the allocator never maps a
        writable position range of two slots onto one block);
        ``write_mask=False`` rows are dropped entirely."""
        flat = self._flat(cache, positions, write_mask).reshape(-1)
        return self._scatter(cache, flat, self._encode(k, v), positions)

    def truncate(self, cache: Params, lengths: torch.Tensor) -> Params:
        """Rollback through the table: every pool row mapped by slot b that
        holds a position ``>= lengths[b]`` flips to ``pool_pos = -1``,
        invisible to :func:`_mask` until the next window rewrites it.
        Unmapped (-1) entries are dropped; block ownership is the host
        allocator's and stays as it is.  A block takes the least length of
        the slots that map it, so a shared-prefix block, whose positions lie
        below every holder's length (rows that must not roll back carry a
        length past every position), keeps its bytes.  The JAX package
        scatters each holder's row back instead; where the holders agree,
        as the allocator guarantees, the two are the same."""
        table = cache["table"]
        b, bps = table.shape
        nb = cache["pool_pos"].shape[0]
        pos = cache["pool_pos"]
        # per block the least length of its holders; unmapped entries land
        # on the extra entry nb, which is then dropped
        idx = torch.where(table >= 0, table, nb).long().view(-1)
        lim = torch.full((nb + 1,), torch.iinfo(pos.dtype).max,
                         dtype=pos.dtype, device=pos.device)
        lim.scatter_reduce_(0, idx, lengths.to(pos.dtype)[:, None]
                            .expand(b, bps).reshape(-1), "amin")
        pos.masked_fill_(pos >= lim[:nb, None], -1)
        return cache

    def gather(self, cache: Params):
        """Dense (B, L, KVH, Dh) views via the table, in position order.
        Unmapped entries read block 0 but report pos -1, which
        :func:`_mask` hides."""
        table = cache["table"]
        b, bps = table.shape
        bs = self.block_size
        safe = torch.clamp(table, min=0).long()
        k = cache["pool_k"][safe]  # (B, bps, bs, KVH, Dh-coded)
        v = cache["pool_v"][safe]
        if self.kv_bits is not None:
            dh = k.shape[-1] * (8 if self.kv_bits == 1 else 1)
            k = kv_dequantize(self.kv_bits, k, cache["pool_ks"][safe], dh)
            v = kv_dequantize(self.kv_bits, v, cache["pool_vs"][safe], dh)
        pos = cache["pool_pos"][safe].masked_fill(table[:, :, None] < 0, -1)
        kvh, dh = k.shape[-2:]
        return (k.reshape(b, bps * bs, kvh, dh), v.reshape(b, bps * bs, kvh, dh),
                pos.reshape(b, bps * bs))

    def attend(self, cache: Params, q, q_pos, cfg: AttnConfig):
        return attn_kernels.flash_decode_paged(
            cache["table"], q.to(torch.float32).contiguous(),
            q_pos.to(torch.int32), cache["pool_k"], cache["pool_v"],
            cache["pool_pos"], cache.get("pool_ks"), cache.get("pool_vs"),
            block_size=self.block_size, kv_bits=self.kv_bits,
            sm_scale=cfg.scale, logit_softcap=cfg.logit_softcap,
            causal=cfg.causal, window=cfg.window)


CONTIGUOUS = ContiguousKVCache()


def _attend(params, q, positions, cache, cfg: AttnConfig, ctx: QCtx, path,
            kv: KVCache, per_position: bool = False):
    """Attention of the projected (B, C, H, Dh) queries over the cache they
    were just written into, then the output projection.  ``per_position``
    attends one window position at a time, each call at a decode step's
    shapes, so that every row rounds as the decode step of that position
    would (the fp32 reductions and K11's split plan depend on the number of
    query rows); the output projection still runs once over all rows."""
    b, c = positions.shape
    kvh, g, dh = cfg.n_kv_heads, cfg.groups, cfg.d_head
    gathered = None if cfg.fused_attn else kv.gather(cache)

    def attend(qc, pc):
        qg = qc.reshape(b, pc.shape[1], kvh, g, dh)
        if cfg.fused_attn:
            return kv.attend(cache, qg, pc, cfg)
        k, v, k_pos = gathered
        return _sdpa(cfg, qg, k, v, _mask(cfg, pc, k_pos))

    if per_position:
        out = torch.cat([attend(q[:, j:j + 1].contiguous(),
                                positions[:, j:j + 1].contiguous())
                         for j in range(c)], dim=1)
    else:
        out = attend(q, positions)
    out = out.reshape(b, c, cfg.n_heads * dh).to(ctx.compute_dtype)
    return ctx.dense(params["o"], out, f"{path}/o")


def attn_decode(params: Params, x: torch.Tensor, pos: torch.Tensor,
                cache: Params, cfg: AttnConfig, ctx: QCtx, path: str,
                *, kv: KVCache | None = None,
                write_mask: torch.Tensor | None = None):
    """One decode step against the cache.  x: (B, 1, D); pos: (B,) position
    of this token.  ``kv`` selects the layout (default contiguous);
    ``write_mask`` (B,) drops inactive rows' cache writes (required on the
    paged layout, where recycled blocks make junk writes unsafe).  Returns
    (out (B,1,D), cache) — the cache is updated in place."""
    kv = CONTIGUOUS if kv is None else kv
    positions = pos[:, None]
    q, k_new, v_new = _project_qkv(params, x, positions, cfg, ctx, path)
    cache = kv.fill(cache, k_new, v_new, positions, write_mask)
    return _attend(params, q, positions, cache, cfg, ctx, path, kv), cache


def attn_window(params: Params, x: torch.Tensor, positions: torch.Tensor,
                cache: Params, cfg: AttnConfig, ctx: QCtx, path: str,
                kv: KVCache, *, write_mask: torch.Tensor | None = None,
                per_position: bool = False):
    """A C-token window against the cache: project, store the window's k/v,
    then attend over the whole cache (the window included — causality comes
    from the position mask).  ``attn_decode`` is the C == 1 case; chunked
    prefill is the general one, where each chunk of a long prompt attends to
    everything already cached (earlier chunks, shared prefix blocks) plus
    itself.  x: (B, C, D); positions: (B, C) absolute positions.
    ``per_position``: see :func:`_attend` (the speculative windows)."""
    q, k_new, v_new = _project_qkv(params, x, positions, cfg, ctx, path)
    cache = kv.fill_window(cache, k_new, v_new, positions, write_mask)
    return _attend(params, q, positions, cache, cfg, ctx, path, kv,
                   per_position), cache
