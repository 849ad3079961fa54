"""Gather-free fused decode attention — PyTorch port of
``repro.kernels.attn_decode``: a flash-decode kernel over the KV cache's own
storage, paged pool blocks read THROUGH the per-slot block tables, or a
contiguous slab viewed as an identity-table pool, with optional quantized
(int8 / 1-bit-scaled) KV dequantized in the kernel.

The gather path (``kv.gather`` + ``_sdpa``) materialises a dense
``(B, cache_len, KVH, Dh)`` K and V copy every step and every layer, then
sweeps the whole static cache length under a mask.  The kernel reads each
mapped cache block in place, in its storage tier:

* **block tables** — one query's slot walks its table entries in order;
  unmapped entries (-1: slot shorter than the table, or a retired slot)
  cost no loads and add nothing to the running softmax state.
* **per-row masking** — ``pool_pos`` carries each row's absolute position
  (-1 = never written / write-masked); the mask is ``nn/attention._mask``
  (pos >= 0, causal, sliding window), so ragged lengths and retired rows
  fall out of the position plane.
* **quantized KV** (``kv_bits``): 8 -> int8 codes + per-(head, dh-group)
  absmax scales; 1 -> sign bytes (8 lanes per uint8) + per-head alpha (the
  XNOR tier, mean |x| as BMXNet Eq. 1).  Only the narrow codes leave device
  memory.
* **query windows** — queries are a ``(B, C)`` tile: C == 1 is decode, C > 1
  a chunked-prefill window (per-row causal masking from absolute positions).

``flash_decode_paged`` launches ``csrc/flash_decode.cu`` on a CUDA tensor
(or raises) and runs ``flash_decode_paged_plain`` — the JAX kernel's
entry-by-entry online softmax in PyTorch ops — on a CPU tensor.  The
contiguous layout reshapes (free) to a pool of ``L / t`` tiles per slot
under an arange table and runs the same kernel.

The kernel has two tiles, chosen from static shapes (:func:`window_tile`):
a split-KV decode tile for C*G <= ``DECODE_TILE_ROWS``, whose key ranges
(:func:`split_plan`) this wrapper sizes from B*KVH and the table span and
whose per-split partials a second kernel merges in split order, and a
register-blocked window tile for prefill windows.  The split plan's plain
counterparts, :func:`flash_decode_split_plain` (one range's partial) and
:func:`combine_splits_plain` (the merge), are for tests.

Numerics against the gather oracle: scores and softmax in fp32 with the
same scale / softcap / mask; only the summation order differs.  A row with
no visible key at all is junk on every path (callers never read it): the
plain version, like the JAX kernel, carries the masked rows' values while
its running max is still ``NEG_INF``; the CUDA kernel admits no masked key
and emits zeros.  A slot with no mapped entry emits exact zeros on both.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _cuda

NEG_INF = -2.0e38

DEFAULT_CTG_TILE = 512  # contiguous tile (tokens per identity-table block)
DEFAULT_PGD_SPB = 4  # the JAX kernel's paged table entries per split step

# the CUDA kernel's tiles (csrc/flash_decode.cu: kDecodeRows, kMaxSplits, kRG)
DECODE_TILE_ROWS = 16  # C*G at or below which the split-KV decode tile runs
MAX_SPLITS = 64
SPLIT_ROWS = 4  # query rows per decode-tile block
SPLIT_BLOCKS_PER_SM = 4  # decode-tile blocks the split plan aims for per SM
SPLIT_KEY_GRAIN = 32  # a planned range is a multiple of 32 keys

# storage tier -> the kernel's pool kind (fp pools by dtype)
_KIND = {torch.float32: 0, torch.bfloat16: 1, 8: 2, 1: 3}
_CODE_DTYPE = {8: torch.int8, 1: torch.uint8}


# ---------------------------------------------------------------------------
# Quantized KV storage codecs — shared by the cache write paths
# (nn/attention.py quantises on fill) and the plain kernel's dequant.
# ---------------------------------------------------------------------------


def kv_scale_groups(d_head: int) -> int:
    """dh-group count for the int8 absmax scales: 32-channel groups when
    Dh divides, else one group per head (smoke heads are Dh=16)."""
    return d_head // 32 if d_head % 32 == 0 else 1


def kv_quantize(bits: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp (..., KVH, Dh) -> (codes, scale).

    * bits == 8: int8 codes (..., KVH, Dh), fp32 absmax scales
      (..., KVH, n_groups) per (head, dh-group) — symmetric round-half-to-
      even, absmax/127.
    * bits == 1: sign bytes (..., KVH, Dh/8) uint8 (lane i of byte w is
      element 8w+i, sign(0) = +1) + per-head fp32 alpha (..., KVH) = mean
      |x| over Dh.
    """
    xf = x.to(torch.float32)
    dh = x.shape[-1]
    if bits == 8:
        g = kv_scale_groups(dh)
        grp = xf.reshape(*x.shape[:-1], g, dh // g)
        amax = grp.abs().amax(dim=-1)
        scale = torch.clamp(amax / 127.0, min=1e-30)
        codes = torch.clamp(torch.round(grp / scale[..., None]), -127, 127)
        return codes.reshape(x.shape).to(torch.int8), scale
    if bits == 1:
        if dh % 8:
            raise ValueError(f"kv_bits=1 needs d_head % 8 == 0, got {dh}")
        alpha = xf.abs().mean(dim=-1)
        bits_ = (xf >= 0).to(torch.int32).reshape(*x.shape[:-1], dh // 8, 8)
        weights = 1 << torch.arange(8, dtype=torch.int32, device=x.device)
        return (bits_ * weights).sum(dim=-1).to(torch.uint8), alpha
    raise ValueError(f"kv_bits must be 8 or 1, got {bits}")


def kv_dequantize(bits: int, codes: torch.Tensor, scale: torch.Tensor,
                  d_head: int, dtype=torch.float32) -> torch.Tensor:
    """Invert :func:`kv_quantize`: (codes, scale) -> fp (..., KVH, Dh)."""
    if bits == 8:
        g = kv_scale_groups(d_head)
        grp = codes.to(torch.float32).reshape(*codes.shape[:-1], g, d_head // g)
        return (grp * scale[..., None]).reshape(
            *codes.shape[:-1], d_head).to(dtype)
    if bits == 1:
        shifts = torch.arange(8, dtype=torch.int32, device=codes.device)
        b = (codes.to(torch.int32)[..., None] >> shifts) & 1
        signs = (2.0 * b.to(torch.float32) - 1.0).reshape(
            *codes.shape[:-1], d_head)
        return (signs * scale[..., None]).to(dtype)
    raise ValueError(f"kv_bits must be 8 or 1, got {bits}")


def kv_code_shapes(bits: int | None, kvh: int, dh: int, dtype):
    """Per-token trailing (shape, dtype) pairs for the K (or V) leaf and
    its scale leaf under a given storage tier; scale entry is None for fp.
    Used by both cache layouts' ``init`` so allocation cannot drift from
    the codec."""
    if bits is None:
        return ((kvh, dh), dtype), None
    if bits == 8:
        return ((kvh, dh), torch.int8), ((kvh, kv_scale_groups(dh)),
                                         torch.float32)
    if bits == 1:
        if dh % 8:
            raise ValueError(f"kv_bits=1 needs d_head % 8 == 0, got {dh}")
        return ((kvh, dh // 8), torch.uint8), ((kvh,), torch.float32)
    raise ValueError(f"kv_bits must be None, 8 or 1, got {bits}")


# ---------------------------------------------------------------------------
# The plain version: the JAX kernel's recurrence, one table entry at a time
# ---------------------------------------------------------------------------


def _dequant_tile(kv_bits, codes, scale, dh):
    """Gathered (..., bs, KVH, Dh-coded) blocks -> fp32 (..., bs, KVH, Dh)."""
    if kv_bits is None:
        return codes.to(torch.float32)
    return kv_dequantize(kv_bits, codes, scale, dh, torch.float32)


def flash_decode_paged_plain(table, q, q_pos, pool_k, pool_v, pool_pos,
                             k_scale=None, v_scale=None, *,
                             kv_bits: int | None = None, sm_scale: float,
                             logit_softcap: float | None = None,
                             causal: bool = True,
                             window: int | None = None) -> torch.Tensor:
    """Online-softmax attention over the table entries in order, batched
    over slots: each mapped entry updates (m, l, acc) exactly as the JAX
    kernel's ``_accumulate`` does (masked rows score ``NEG_INF``), unmapped
    entries leave them untouched.  Returns (B, C, KVH, G, Dh) fp32."""
    b, c, kvh, g, dh = q.shape
    cg = c * g
    qt = q.to(torch.float32).permute(0, 2, 1, 3, 4).reshape(b, kvh, cg, dh)
    qp = q_pos.repeat_interleave(g, dim=1).view(b, 1, cg, 1)
    dev = q.device
    m = torch.full((b, kvh, cg, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, cg, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, cg, dh), dtype=torch.float32, device=dev)
    for jj in range(table.shape[1]):
        blk = table[:, jj]
        mapped = (blk >= 0).view(b, 1, 1, 1)
        if not bool(mapped.any()):
            continue
        safe = blk.clamp(min=0).long()
        kt = _dequant_tile(kv_bits, pool_k[safe],
                           None if k_scale is None else k_scale[safe], dh)
        vt = _dequant_tile(kv_bits, pool_v[safe],
                           None if v_scale is None else v_scale[safe], dh)
        kp = pool_pos[safe].view(b, 1, 1, -1)
        s = torch.einsum("bhrd,bkhd->bhrk", qt, kt) * sm_scale
        if logit_softcap is not None:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        valid = kp >= 0
        if causal:
            valid = valid & (kp <= qp)
        if window is not None:
            valid = valid & (kp > qp - window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bhrk,bkhd->bhrd", p, vt)
        m = torch.where(mapped, m_new, m)
        l = torch.where(mapped, l_new, l)
        acc = torch.where(mapped, acc_new, acc)
    out = acc / torch.clamp(l, min=1e-37)
    return out.view(b, kvh, c, g, dh).permute(0, 2, 1, 3, 4).contiguous()


# ---------------------------------------------------------------------------
# The decode tile's split plan and its plain counterparts
# ---------------------------------------------------------------------------


def window_tile(c: int, g: int, dh: int, pool_k: torch.Tensor,
                pool_v: torch.Tensor) -> bool:
    """True when the kernel takes its window tile, false for the split-KV
    decode tile — the C entry point's rule, from static shapes: C*G above
    ``DECODE_TILE_ROWS``, Dh a multiple of 16 up to 128, both pools 16-byte
    aligned."""
    return (c * g > DECODE_TILE_ROWS and dh % 16 == 0 and dh <= 128
            and pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0)


def split_plan(pairs: int, rows: int, span: int, sms: int,
               splits: int | None = None) -> tuple[int, int]:
    """(n_splits, keys per split) of the decode tile over a table span of
    ``span`` keys, for ``pairs`` = B*KVH and ``rows`` = C*G query rows:
    enough ranges that the grid (pairs x ranges x row groups of
    ``SPLIT_ROWS``) holds ``SPLIT_BLOCKS_PER_SM`` blocks per SM, each a
    multiple of ``SPLIT_KEY_GRAIN`` keys, at most ``MAX_SPLITS``.  Split s
    covers keys ``[s * keys, min(span, (s + 1) * keys))``.  ``splits``
    forces the count (the ranges are then ``ceil(span / splits)`` keys, as
    the tests use)."""
    if splits is None:
        blocks = pairs * -(-rows // SPLIT_ROWS)
        want = max(1, min(MAX_SPLITS, -(-SPLIT_BLOCKS_PER_SM * sms // blocks)))
        keys = -(-max(span, 1) // want)
        keys = -(-keys // SPLIT_KEY_GRAIN) * SPLIT_KEY_GRAIN
    else:
        if not 1 <= splits <= MAX_SPLITS:
            raise ValueError(f"splits must be in [1, {MAX_SPLITS}], got {splits}")
        keys = -(-max(span, 1) // splits)
    return -(-max(span, 1) // keys), keys


def split_ranges(n_splits: int, keys: int, span: int) -> list[tuple[int, int]]:
    """The key ranges ``[lo, hi)`` of a :func:`split_plan`, in split order."""
    return [(s * keys, min(span, (s + 1) * keys)) for s in range(n_splits)]


def flash_decode_split_plain(table, q, q_pos, pool_k, pool_v, pool_pos,
                             k_scale=None, v_scale=None, *,
                             keys: tuple[int, int], kv_bits: int | None = None,
                             sm_scale: float,
                             logit_softcap: float | None = None,
                             causal: bool = True, window: int | None = None):
    """One split's partial: the plain recurrence over the table span's keys
    ``[lo, hi)`` only (keys outside score ``NEG_INF``, as masked keys do).
    Returns the unnormalised (m, l, acc), (B, KVH, C*G, 1 | Dh) fp32."""
    lo, hi = keys
    b, c, kvh, g, dh = q.shape
    bs = pool_pos.shape[1]
    cg = c * g
    qt = q.to(torch.float32).permute(0, 2, 1, 3, 4).reshape(b, kvh, cg, dh)
    qp = q_pos.repeat_interleave(g, dim=1).view(b, 1, cg, 1)
    dev = q.device
    m = torch.full((b, kvh, cg, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, cg, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, cg, dh), dtype=torch.float32, device=dev)
    for jj in range(lo // bs, -(-hi // bs)):
        blk = table[:, jj]
        mapped = (blk >= 0).view(b, 1, 1, 1)
        if not bool(mapped.any()):
            continue
        safe = blk.clamp(min=0).long()
        kt = _dequant_tile(kv_bits, pool_k[safe],
                           None if k_scale is None else k_scale[safe], dh)
        vt = _dequant_tile(kv_bits, pool_v[safe],
                           None if v_scale is None else v_scale[safe], dh)
        kp = pool_pos[safe].view(b, 1, 1, -1)
        key = jj * bs + torch.arange(bs, device=dev)
        s = torch.einsum("bhrd,bkhd->bhrk", qt, kt) * sm_scale
        if logit_softcap is not None:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        valid = (kp >= 0) & ((key >= lo) & (key < hi)).view(1, 1, 1, -1)
        if causal:
            valid = valid & (kp <= qp)
        if window is not None:
            valid = valid & (kp > qp - window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bhrk,bkhd->bhrd", p, vt)
        m = torch.where(mapped, m_new, m)
        l = torch.where(mapped, l_new, l)
        acc = torch.where(mapped, acc_new, acc)
    return m, l, acc


def combine_splits_plain(parts, c: int, g: int) -> torch.Tensor:
    """Merge split partials ``[(m, l, acc), ...]`` (from
    :func:`flash_decode_split_plain`) as the kernel's combine does: M = the
    max of m over splits with l > 0, weights exp(m - M) (0 where l == 0),
    sums taken in split order; out = sum w*acc / max(sum w*l, 1e-37).
    Returns (B, C, KVH, G, Dh) fp32."""
    m = torch.stack([p[0] for p in parts])
    l = torch.stack([p[1] for p in parts])
    has = l > 0
    top = torch.where(has, m, torch.full_like(m, NEG_INF)).amax(dim=0)
    w = torch.where(has, torch.exp(m - top), torch.zeros_like(m))
    ls = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for s, part in enumerate(parts):
        ls = ls + w[s] * part[1]
        acc = acc + w[s] * part[2]
    out = acc / torch.clamp(ls, min=1e-37)
    b, kvh, _, dh = out.shape
    return out.view(b, kvh, c, g, dh).permute(0, 2, 1, 3, 4).contiguous()


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


def _check(table, q, q_pos, pool_k, pool_v, pool_pos, k_scale, v_scale,
           block_size, kv_bits, window, spb):
    """Device-independent operand checks; returns the pool kind."""
    _cuda.require(q, "q", torch.float32, 5)
    b, c, kvh, _, dh = q.shape
    _cuda.require(table, "table", torch.int32, 2)
    _cuda.require(q_pos, "q_pos", torch.int32, 2)
    _cuda.require(pool_pos, "pool_pos", torch.int32, 2)
    nb, bs = pool_pos.shape
    if bs != block_size:
        raise ValueError(f"pool_pos block size {bs} != block_size {block_size}")
    if table.shape[0] != b or tuple(q_pos.shape) != (b, c):
        raise ValueError(f"table {tuple(table.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} do not match q {tuple(q.shape)}")
    if kv_bits is None:
        if pool_k.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"fp KV pools must be float32 or bfloat16, got "
                            f"{pool_k.dtype}")
        kind, code_dh = _KIND[pool_k.dtype], dh
    elif kv_bits in (8, 1):
        if kv_bits == 1 and dh % 8:
            raise ValueError(f"kv_bits=1 needs d_head % 8 == 0, got {dh}")
        kind, code_dh = _KIND[kv_bits], dh if kv_bits == 8 else dh // 8
    else:
        raise ValueError(f"kv_bits must be None, 8 or 1, got {kv_bits}")
    dtype = pool_k.dtype if kv_bits is None else _CODE_DTYPE[kv_bits]
    for name, pool in (("pool_k", pool_k), ("pool_v", pool_v)):
        _cuda.require(pool, name, dtype, 4)
        if tuple(pool.shape) != (nb, bs, kvh, code_dh):
            raise ValueError(f"{name} {tuple(pool.shape)} != "
                             f"{(nb, bs, kvh, code_dh)}")
    if kv_bits is None:
        if k_scale is not None or v_scale is not None:
            raise ValueError("fp KV pools take no scales")
    else:
        want = ((nb, bs, kvh, kv_scale_groups(dh)) if kv_bits == 8
                else (nb, bs, kvh))
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc is None:
                raise ValueError(f"kv_bits={kv_bits} needs {name}")
            _cuda.require(sc, name, torch.float32, len(want))
            if tuple(sc.shape) != want:
                raise ValueError(f"{name} {tuple(sc.shape)} != {want}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if spb < 1:
        raise ValueError(f"blocks_per_step must be >= 1, got {spb}")
    if pool_k.numel() >= 2**31:
        raise ValueError(f"pool of {pool_k.numel()} elements exceeds the "
                         "kernel's int32 indices")
    return kind


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(table, q, q_pos, pool_k, pool_v, pool_pos, k_scale, v_scale,
            kind, sm_scale, cap, causal, window) -> torch.Tensor:
    b, c, kvh, g, dh = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    nb, bs = pool_pos.shape
    bps = table.shape[1]
    ws = None
    if window_tile(c, g, dh, pool_k, pool_v):
        n_splits = keys = 0
    else:
        n_splits, keys = split_plan(b * kvh, c * g, bs * bps,
                                    _sm_count(q.device.index))
        if n_splits > 1:  # the per-split partials: (m, l) then acc
            ws = torch.empty(b * kvh * n_splits * c * g * (dh + 2),
                             dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _cuda.lib().repro_flash_decode(
            table.data_ptr(), q.data_ptr(), q_pos.data_ptr(),
            pool_k.data_ptr(), pool_v.data_ptr(),
            0 if k_scale is None else k_scale.data_ptr(),
            0 if v_scale is None else v_scale.data_ptr(),
            pool_pos.data_ptr(), out.data_ptr(),
            0 if ws is None else ws.data_ptr(),
            b, c, kvh, g, dh, nb, bs, bps, n_splits, keys,
            kind, sm_scale, 0.0 if cap is None else cap, int(causal),
            0 if window is None else window,
            _cuda.stream_handle(q.device))
    _cuda.check(rc, "flash_decode")
    _cuda.LAUNCHES["flash_decode"] += 1
    return out


def flash_decode_paged(
    table: torch.Tensor,  # (B, bps) int32 block ids, -1 = unmapped
    q: torch.Tensor,  # (B, C, KVH, G, Dh) float32
    q_pos: torch.Tensor,  # (B, C) int32 absolute query positions
    pool_k: torch.Tensor,  # (nb, bs, KVH, Dh) fp | int8 codes | uint8 signs
    pool_v: torch.Tensor,
    pool_pos: torch.Tensor,  # (nb, bs) int32, -1 = empty
    k_scale: torch.Tensor | None = None,  # (nb, bs, KVH[, groups]) fp32
    v_scale: torch.Tensor | None = None,
    *,
    block_size: int,
    kv_bits: int | None = None,
    sm_scale: float,
    logit_softcap: float | None = None,
    causal: bool = True,
    window: int | None = None,
    blocks_per_step: int | None = None,
) -> torch.Tensor:
    """Fused paged flash-decode attention: (B, C, KVH, G, Dh) fp32 out.

    Reads the paged pool through ``table`` — no dense gather.  At C*G <=
    ``DECODE_TILE_ROWS`` the CUDA kernel splits the table span into the
    key ranges of :func:`split_plan` (sized from B*KVH and the span, never
    from lengths), each walked straight through the table, and merges the
    ranges in split order; above it, one block per 64 query rows walks the
    whole span.  ``blocks_per_step`` (default ``min(DEFAULT_PGD_SPB,
    bps)``) is the JAX kernel's split knob, table entries per grid step: it
    is validated for API parity and does not reach the kernel, whose
    ranges are whole keys, not table entries."""
    spb = blocks_per_step or min(DEFAULT_PGD_SPB, table.shape[1])
    kind = _check(table, q, q_pos, pool_k, pool_v, pool_pos, k_scale, v_scale,
                  block_size, kv_bits, window, spb)
    operands = [table, q, q_pos, pool_k, pool_v, pool_pos]
    operands += [t for t in (k_scale, v_scale) if t is not None]
    if _cuda.on_cpu(*operands):
        return flash_decode_paged_plain(
            table, q, q_pos, pool_k, pool_v, pool_pos, k_scale, v_scale,
            kv_bits=kv_bits, sm_scale=sm_scale, logit_softcap=logit_softcap,
            causal=causal, window=window)
    return _launch(table, q, q_pos, pool_k, pool_v, pool_pos, k_scale,
                   v_scale, kind, sm_scale, logit_softcap, causal, window)


def contig_tile(cache_len: int, kv_tile: int | None = None) -> int:
    """The contiguous layout's pool block: ``kv_tile`` (default
    ``DEFAULT_CTG_TILE``) halved until it divides the slab length."""
    t = kv_tile or DEFAULT_CTG_TILE
    while cache_len % t:
        t //= 2
    return t


def _contig_pool(k, v, slot_pos, k_scale, v_scale, kv_tile):
    """The per-slot ``(B, L, ...)`` slabs as a pool of ``L / t`` tiles per
    slot under an arange block table — free views.  Returns (table,
    pool_k, pool_v, pool_pos, k_scale, v_scale, t)."""
    b, l = slot_pos.shape
    t = contig_tile(l, kv_tile)
    nt = l // t

    def pooled(x):
        return None if x is None else x.reshape(b * nt, t, *x.shape[2:])

    table = torch.arange(b * nt, dtype=torch.int32,
                         device=slot_pos.device).view(b, nt)
    return (table, pooled(k), pooled(v), pooled(slot_pos), pooled(k_scale),
            pooled(v_scale), t)


def flash_decode_contig(
    q: torch.Tensor,  # (B, C, KVH, G, Dh)
    q_pos: torch.Tensor,  # (B, C)
    k: torch.Tensor,  # (B, L, KVH, Dh) fp | codes
    v: torch.Tensor,
    slot_pos: torch.Tensor,  # (B, L) int32
    k_scale: torch.Tensor | None = None,  # (B, L, KVH[, groups])
    v_scale: torch.Tensor | None = None,
    *,
    kv_bits: int | None = None,
    sm_scale: float,
    logit_softcap: float | None = None,
    causal: bool = True,
    window: int | None = None,
    kv_tile: int | None = None,
) -> torch.Tensor:
    """Contiguous-slab variant: the slab viewed as an identity-table pool
    of ``kv_tile``-token blocks (:func:`contig_tile`), after which the SAME
    paged kernel runs."""
    table, pk, pv, pp, ks, vs, t = _contig_pool(k, v, slot_pos, k_scale,
                                                v_scale, kv_tile)
    return flash_decode_paged(
        table, q, q_pos, pk, pv, pp, ks, vs, block_size=t, kv_bits=kv_bits,
        sm_scale=sm_scale, logit_softcap=logit_softcap, causal=causal,
        window=window)


def flash_decode_contig_plain(q, q_pos, k, v, slot_pos, k_scale=None,
                              v_scale=None, *, kv_tile: int | None = None,
                              **opts) -> torch.Tensor:
    """Plain version of :func:`flash_decode_contig` on any device."""
    table, pk, pv, pp, ks, vs, _ = _contig_pool(k, v, slot_pos, k_scale,
                                                v_scale, kv_tile)
    return flash_decode_paged_plain(table, q, q_pos, pk, pv, pp, ks, vs,
                                    **opts)


def select_attn_tiles(b: int, c: int, cache_len: int, dh: int,
                      layout: str) -> int:
    """The split knob for a decode shape: ``layout`` "ctg" returns the
    contiguous tile (the identity table's block, which does reach the
    kernel), "pgd" the JAX kernel's paged table entries per split step
    (kept for API parity: the CUDA kernel takes its split ranges from
    :func:`split_plan` instead).  The port has no tuned-tile cache yet (the
    autotune is ROADMAP slice 7), so these are the defaults."""
    del b, c, cache_len, dh
    if layout not in ("ctg", "pgd"):
        raise ValueError(f"layout must be 'ctg' or 'pgd', got {layout!r}")
    return DEFAULT_CTG_TILE if layout == "ctg" else DEFAULT_PGD_SPB
