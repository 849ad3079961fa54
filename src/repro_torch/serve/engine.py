"""Serving engine: a continuous-batching scheduler over the packed-GEMM
decode step, with a contiguous OR block-table paged KV cache (PyTorch port of
the lm path of ``repro.serve.engine``).

``Scheduler`` owns a FIFO request queue and ``EngineConfig.batch`` KV-cache
slots.  The **contiguous** loop (``EngineConfig.kv_block_size=None``):

* **admission** — free slots are filled from the queue head: the maximal
  run of queued requests with the same prompt length prefills together
  (one call), each request's cache rows land in its slot through
  ``models/lm.cache_insert`` (a full-slot overwrite whose ``slot_pos = -1``
  rows past the prompt hide the previous occupant), and the first token is
  sampled from the prefill logits.  Each slot runs its own position stream
  from 0.
* **decode** — ONE step for the whole batch (fixed ``batch`` x
  ``cache_len``); retired slots decode junk pinned to token 0 and masked out
  of emission.
* **retirement** — the step a sequence emits its ``eos_id`` (at or past
  ``min_tokens``) or exhausts ``max_new_tokens``, its slot is reset and
  becomes eligible for the next queued request.

The **paged** loop (``EngineConfig.kv_block_size=bs``) swaps the per-slot
slabs for one shared pool of ``batch * cache_len/bs`` blocks plus per-slot
int32 block tables (``nn/attention.PagedKVCache``), with prefix sharing and
chunked prefill on top.  ``BlockAllocator`` is the single owner of block
lifetime; the model only FOLLOWS the tables:

* every block is free, cached (refcount 0, contents kept under its prefix
  chain hash, LRU-evictable) or active (refcount >= 1); shared prefix
  blocks are never written, because chunked prefill starts at the first
  novel token and decode writes at ``pos >= prompt_len``, both strictly past
  every shared full block (admission caps sharing at ``(prompt_len - 1) //
  bs`` blocks);
* freshly allocated blocks get ``pool_pos = -1`` BEFORE their table row
  lands (``Engine._map_slot``), so a previous occupant's stale keys are
  invisible;
* retired, idle and still-prefilling slots ride through the batch-wide
  decode step with ``write_mask=False``: their junk writes are DROPPED,
  because their blocks may already belong to another slot;
* retirement releases each held block exactly once (``SlotState.blocks`` is
  cleared as it is released); a shared block returns to the free list only
  when its LAST holder retires, and registered prefix blocks retire into the
  cached state, so a later identical-prefix request skips their prefill —
  ``SchedulerStats.shared_tokens`` counts the skipped tokens.

**Chunked prefill**: admission is per request; each scheduler iteration
advances every prefilling slot by one window of up to
``EngineConfig.prefill_chunk`` tokens (``models/lm.decode_window``) and THEN
runs one decode step for the decoding slots, so batchmates' inter-token
latency is bounded by one chunk instead of one whole prompt.  A slot samples
its first token from the window that ends on its last prompt token — the
position the contiguous prefill samples from.

**Quantized KV** (``EngineConfig.kv_bits``): the pool (or slab) stores int8
codes or 1-bit sign bytes, with the scales beside the blocks in leaves
indexed by the same flat indices, so nothing above ``nn/attention`` knows
the tier exists.  **Fused attention** (``EngineConfig.fused_attn``) reads
that storage in place through the tables with the flash-decode kernel
instead of gathering it (``kernels/attn_decode.py``).

Greedy outputs are bit-identical to per-request generation because every
per-token op is batch-row independent, and the paged gather reassembles
each slot's tokens in exactly the contiguous position order.  Sampling at
temperature > 0 draws from a ``torch.Generator`` seeded per request from
``(seed, rid)`` and advanced once per emitted token, so a request's stream
does not depend on its batchmates; it cannot reproduce the JAX package's
threefry streams.

**Speculative decoding** (``EngineConfig.draft`` + ``spec_len``): a second,
cheap model — the target's leading layers packed to the w1a1 xnor tier
(``core/converter.derive_draft``) — proposes ``spec_len`` greedy tokens per
round for every decoding slot, and the target scores all of them in ONE
``models/lm.decode_window(..., logits_all=True)`` call.  A row accepts the
leading run ``n`` of proposals that match the target's own greedy picks and
emits ``n + 1`` tokens (the target's pick after the run rides along).  The
invariants:

* **lossless** — logit row c of the verify window conditions exactly on
  window tokens ``< c``, so every emitted token is the target's greedy pick
  given the emitted prefix: the stream equals target-only greedy decoding
  for ANY draft; the draft only sets the acceptance rate.  In floating
  point that needs the same bits, not only the same function: the verify
  window runs its fp32 reductions one position at a time at a decode
  step's shapes (``decode_window(logits_all=True)``), and its packed GEMMs,
  exact at any row count, over the whole window;
* **rollback** — the verify window writes positions ``p..p+s`` into the
  target cache and the draft wrote ``p..p+s-1`` into its own; one per-row
  ``lengths = p + n + 1`` rolls BOTH back (``KVCache.truncate``: contiguous
  flips ``slot_pos``, paged flips ``pool_pos`` through the table; block
  ownership stays with the allocator), and the next round's window rewrites
  the rolled-back rows before they are read;
* **the draft's restart window** — each round the draft starts with the
  width-2 window ``[t_{p-1}, t_p]`` at ``(p-1, p)``: re-feeding the previous
  token writes the one position the draft never saw when the last round
  accepted everything, and one shape serves every outcome.  Its float
  recomputation of position ``p-1`` can round differently from the prefill's
  and so move proposals, never output;
* **write masks** — rows not decoding (idle, prefilling, retired) ride
  through the batch-wide draft and verify calls with ``write_mask=False``
  and carry ``NO_TRUNC``, so the batch-wide truncate leaves them alone (a
  retired slot's blocks may be shared: truncating them would corrupt the
  surviving holder); slots that retire in a round are truncated (no-op),
  then reset or released.

Proposals stay on the device: one host read per round brings back the
proposals and the target's picks together.  Greedy only (accepting sampled
tokens needs the rejection-sampling correction).  The draft keeps its own
CONTIGUOUS fp cache whatever the target's layout, and its config is the one
the caller passed: ``fused_attn`` / ``kv_bits`` reach the target's only, so
the draft attends by gather + ``_sdpa``.

The whisper family is not in the port yet.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.configs.common import ArchSpec
from repro_torch.kernels.dispatch import GemmConfig
from repro_torch.models import lm as lm_model
from repro_torch.nn import attention as attn_lib
from repro_torch.nn.common import QCtx

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.  ``None`` = inherit the next level down
    (request override > request legacy fields > ``EngineConfig.sampling``
    > EngineConfig legacy fields)."""

    temperature: float | None = None  # 0 = greedy
    seed: int | None = None  # per-request generator root
    eos_id: int | None = None  # stop token (resolved None = budget-only)
    min_tokens: int | None = None  # suppress eos before this many tokens
    max_new_tokens: int | None = None  # emission budget


def resolve_sampling(req: "Request", ecfg: "EngineConfig") -> SamplingParams:
    """Concrete sampling parameters for one request (no Nones except a
    genuinely-unset ``eos_id``)."""
    base = ecfg.sampling if ecfg.sampling is not None else SamplingParams()
    sp = req.sampling if req.sampling is not None else SamplingParams()

    def pick(*vals):
        for v in vals:
            if v is not None:
                return v
        return None

    return SamplingParams(
        temperature=pick(sp.temperature, base.temperature, ecfg.temperature),
        seed=pick(sp.seed, base.seed, ecfg.seed),
        eos_id=pick(sp.eos_id, req.eos_id, base.eos_id, ecfg.eos_id),
        min_tokens=pick(sp.min_tokens,
                        req.min_tokens if req.min_tokens else None,
                        base.min_tokens, 0),
        max_new_tokens=pick(sp.max_new_tokens, req.max_new_tokens,
                            base.max_new_tokens, ecfg.max_new_tokens),
    )


@dataclasses.dataclass
class DraftModel:
    """The speculative draft: a second LM with its own contiguous KV cache.
    The intended pairing is ``core/converter.derive_draft`` (the target's
    leading layers packed to w1a1), but any attention LM with the target's
    vocabulary works.  ``ctx`` carries the draft's own quant policy and
    ``GemmConfig``; its params must live on the target's device."""

    cfg: Any  # the draft's LMConfig
    params: Params  # packed (or float) draft weights
    ctx: QCtx


@dataclasses.dataclass
class EngineConfig:
    batch: int  # KV-cache slots == the decode width
    cache_len: int
    max_new_tokens: int = 32  # per-request default budget
    temperature: float = 0.0  # 0 = greedy
    # sequence stop token: a slot retires (and recycles) the step it emits
    # this id.  None = budget-only retirement.
    eos_id: int | None = None
    seed: int = 0  # generator root for sampled decoding
    sampling: SamplingParams | None = None  # engine-level defaults
    # per-engine override of how quantized GEMMs execute; None inherits
    # the QCtx's gemm_config
    gemm_config: GemmConfig | None = None
    # None = contiguous per-slot KV slabs.  An int selects the block-table
    # paged pool with this block size; cache_len must divide.
    kv_block_size: int | None = None
    # max tokens per prefill window in paged mode (None = whole prompt in
    # one window); smaller chunks bound batchmates' inter-token latency
    prefill_chunk: int | None = None
    # paged mode: hash full prompt blocks at admission and reuse
    # already-prefilled blocks across identical-prefix requests
    shared_prefix: bool = False
    # route decode / window attention through the flash-decode kernel
    # (kernels/attn_decode.py) instead of gather + _sdpa: reads the KV
    # storage in place through the block tables (paged) or as a tiled slab
    # (contiguous).  False keeps the gather oracle.
    fused_attn: bool = False
    # KV-cache storage tier: None = fp compute dtype; 8 = int8 codes + per-
    # (head, dh-group) absmax scales; 1 = sign bytes + per-head alpha (the
    # XNOR tier).  Scale leaves live beside the code leaves and ride the
    # same writes.  The draft cache stays fp.
    kv_bits: int | None = None
    # speculative decoding: the draft proposes `spec_len` greedy tokens per
    # round per decoding slot and the target verifies them in one window
    # (module docstring).  Greedy only; cache_len must cover prompt + budget
    # + spec_len per request (checked at admission).
    draft: DraftModel | None = None
    spec_len: int = 2  # proposals per round (used when draft is set)


@dataclasses.dataclass
class Request:
    """One generation request for the scheduler queue."""

    prompt: np.ndarray  # (S,) int32
    rid: int | None = None  # assigned by Scheduler.submit when None
    sampling: SamplingParams | None = None
    max_new_tokens: int | None = None
    eos_id: int | None = None
    min_tokens: int = 0


@dataclasses.dataclass
class SlotState:
    """Host-side mirror of one occupied KV-cache slot."""

    rid: int
    prompt_len: int
    budget: int  # tokens still allowed (including not-yet-emitted)
    eos_id: int | None
    min_tokens: int = 0
    temperature: float = 0.0
    seed: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    generator: torch.Generator | None = None  # sampled requests only
    # -- paged-mode fields --
    phase: str = "decode"  # "prefill" until the whole prompt is in-cache
    prompt: np.ndarray | None = None  # kept for chunked prefill windows
    prefill_done: int = 0  # prompt tokens already in-cache (incl. shared)
    n_shared: int = 0  # leading blocks reused from the prefix index
    blocks: list = dataclasses.field(default_factory=list)  # held block ids
    block_hashes: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SchedulerStats:
    steps: int = 0  # decode steps executed
    prefills: int = 0  # prefill (admission / chunk window) calls
    prefill_tokens: int = 0  # prompt tokens actually prefilled (paged)
    shared_tokens: int = 0  # prompt tokens skipped via prefix sharing
    admissions: list = dataclasses.field(default_factory=list)  # (rid, slot)
    t_first: dict = dataclasses.field(default_factory=dict)  # rid -> s
    t_done: dict = dataclasses.field(default_factory=dict)  # rid -> s
    # per-request emission timestamps (rid -> [s], run-relative); in spec
    # mode an accepted run lands in one burst
    t_tokens: dict = dataclasses.field(default_factory=dict)
    # speculative-mode counters (zero when no draft is configured)
    spec_rounds: int = 0  # per-slot verify outcomes scored
    spec_proposed: int = 0  # draft tokens proposed (spec_len * rounds)
    spec_accepted: int = 0  # draft tokens the target agreed with

    def ttfts(self) -> list:
        """Per-request time-to-first-token (seconds, run-relative)."""
        return [v[0] for v in self.t_tokens.values() if v]

    def tpots(self) -> list:
        """Per-token inter-emission gaps (seconds), pooled over requests."""
        return [b - a for v in self.t_tokens.values()
                for a, b in zip(v, v[1:])]

    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft proposals the target accepted."""
        return self.spec_accepted / max(self.spec_proposed, 1)


def _request_generator(seed: int, rid: int, device) -> torch.Generator:
    """The per-request sampling stream, rooted at (seed, rid)."""
    state = np.random.SeedSequence([seed, rid]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


class BlockAllocator:
    """Host-side owner of paged-pool block lifetime.

    States: **free** (on the free list), **active** (refcount >= 1, held
    by at least one slot), **cached** (refcount 0 but contents retained
    under a prompt-prefix chain hash; reusable by ``lookup`` or evicted
    LRU-first when the free list runs dry).  The pool holds exactly
    ``batch * cache_len / block_size`` blocks — every slot maps at most
    ``cache_len / block_size`` distinct blocks, so allocation (with
    cached-block eviction) can never fail for an admissible request.
    """

    def __init__(self, num_blocks: int, block_size: int):
        self.block_size = block_size
        self.free: list[int] = list(range(num_blocks))
        self.refs: dict[int, int] = {}  # block -> refcount (active only)
        self.hash_of: dict[int, Any] = {}  # registered block -> chain hash
        self.index: dict[Any, int] = {}  # chain hash -> block
        # refcount-0 registered blocks, insertion order == release order
        self.cached: collections.OrderedDict[int, None] = \
            collections.OrderedDict()

    def lookup(self, h) -> int | None:
        """Take a reference on the live block registered under chain hash
        ``h`` (reviving it from the cached state if needed)."""
        blk = self.index.get(h)
        if blk is None:
            return None
        self.cached.pop(blk, None)
        self.refs[blk] = self.refs.get(blk, 0) + 1
        return blk

    def alloc(self) -> int:
        """A fresh refcount-1 block; evicts the LRU cached prefix block
        when the free list is empty."""
        if self.free:
            blk = self.free.pop()
        elif self.cached:
            blk, _ = self.cached.popitem(last=False)
            del self.index[self.hash_of.pop(blk)]
        else:
            raise RuntimeError("KV block pool exhausted")
        self.refs[blk] = 1
        return blk

    def register(self, blk: int, h) -> None:
        """Publish an owned, fully-written full-prompt block under its
        chain hash (first writer wins on hash collision)."""
        if h in self.index:
            return
        self.index[h] = blk
        self.hash_of[blk] = h

    def release(self, blk: int) -> None:
        """Drop one reference; the last release frees (or, for registered
        prefix blocks, caches) the block.  Releasing a non-active block is
        a refcount bug and raises."""
        rc = self.refs.get(blk, 0)
        if rc <= 0:
            raise RuntimeError(f"double release of KV block {blk}")
        if rc > 1:
            self.refs[blk] = rc - 1
            return
        del self.refs[blk]
        if blk in self.hash_of:
            self.cached[blk] = None
        else:
            self.free.append(blk)

    def trim(self, blocks: list[int], keep: int) -> list[int]:
        """Release the tail of a slot's held-block list — one reference
        drop per tail block (the LAST holder frees, or caches registered
        prefix blocks).  Returns the kept prefix; the caller MUST adopt
        it as its new held list, which is what makes a second trim/release
        of the same tail a loud ``release`` error instead of silent
        corruption.  ``keep=0`` is full retirement."""
        for blk in blocks[keep:]:
            self.release(blk)
        return blocks[:keep]

    @property
    def live_blocks(self) -> int:
        return len(self.refs)


class Engine:
    """Owns the model entry points + the QCtx/GemmConfig wiring for one
    lm-family model.  Request-level serving goes through
    :class:`Scheduler`; ``generate`` is the deprecated fixed-batch
    surface."""

    def __init__(self, spec: ArchSpec, cfg, ctx: QCtx, params: Params,
                 ecfg: EngineConfig):
        if spec.family != "lm":
            raise NotImplementedError(
                f"the port serves the lm family only (got {spec.family!r})")
        if ecfg.gemm_config is not None:
            ctx = dataclasses.replace(ctx, gemm_config=ecfg.gemm_config)
        if ecfg.fused_attn or ecfg.kv_bits is not None:
            if ecfg.kv_bits not in (None, 8, 1):
                raise ValueError(
                    f"kv_bits must be None, 8 or 1, got {ecfg.kv_bits}")
            # thread the execution / storage tier into the model's
            # attention config
            cfg = dataclasses.replace(
                cfg, attn=dataclasses.replace(
                    cfg.attn, fused_attn=ecfg.fused_attn,
                    kv_bits=ecfg.kv_bits))
        self.spec, self.cfg, self.ctx, self.ecfg = spec, cfg, ctx, ecfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.kv: attn_lib.KVCache = attn_lib.CONTIGUOUS
        if ecfg.kv_bits is not None:
            self.kv = attn_lib.ContiguousKVCache(kv_bits=ecfg.kv_bits)
        if ecfg.kv_block_size is not None:
            if ecfg.cache_len % ecfg.kv_block_size:
                raise ValueError(
                    f"cache_len {ecfg.cache_len} is not a multiple of "
                    f"kv_block_size {ecfg.kv_block_size}")
            self.kv = attn_lib.PagedKVCache(block_size=ecfg.kv_block_size,
                                            kv_bits=ecfg.kv_bits)
        if ecfg.draft is not None:
            self._init_spec(ecfg.draft)

    def _init_spec(self, draft: DraftModel) -> None:
        """Validate the speculative configuration (module docstring: the
        invariants)."""
        ecfg = self.ecfg
        if ecfg.spec_len < 1:
            raise ValueError(f"spec_len must be >= 1, got {ecfg.spec_len}")
        t = ecfg.temperature
        if ecfg.sampling is not None and ecfg.sampling.temperature is not None:
            t = ecfg.sampling.temperature
        if t and t > 0:
            raise ValueError(
                "speculative decoding is greedy-only (temperature 0): "
                "accepting sampled proposals needs the rejection-sampling "
                "correction, which this engine does not implement")
        if draft.cfg.padded_vocab != self.cfg.padded_vocab:
            raise ValueError(
                f"the draft's vocabulary ({draft.cfg.padded_vocab}) is not "
                f"the target's ({self.cfg.padded_vocab})")
        self.dcfg, self.dctx, self.dparams = draft.cfg, draft.ctx, draft.params

    @property
    def speculative(self) -> bool:
        return self.ecfg.draft is not None

    def d_init_cache(self) -> Params:
        """A fresh all-slots-empty DRAFT cache (always contiguous fp)."""
        return lm_model.init_cache(self.dcfg, self.ecfg.batch,
                                   self.ecfg.cache_len,
                                   self.dctx.compute_dtype, self.device,
                                   kv=attn_lib.CONTIGUOUS)

    def _verify(self, cache: Params, tokens: torch.Tensor,
                pos_start: torch.Tensor, write_mask: torch.Tensor):
        return lm_model.decode_window(self.params, self.cfg, self.ctx, cache,
                                      tokens, pos_start, self.kv,
                                      write_mask=write_mask, logits_all=True)

    def _truncate(self, cache: Params, lengths: torch.Tensor) -> Params:
        return lm_model.cache_truncate(self.cfg, cache, lengths, self.kv)

    def _d_prefill(self, tokens: torch.Tensor):
        return lm_model.prefill(self.dparams, self.dcfg, self.dctx, tokens,
                                cache_len=self.ecfg.cache_len)

    def _d_insert(self, dcache: Params, sub: Params, slots: torch.Tensor):
        return lm_model.cache_insert(dcache, sub, slots, attn_lib.CONTIGUOUS)

    def _d_window(self, dcache: Params, tokens: torch.Tensor,
                  pos_start: torch.Tensor, write_mask: torch.Tensor):
        """The draft's restart window, computed per position as a decode
        step would (``logits_all``), so that a draft equal to the target
        proposes the target's own picks bit for bit; returns the last
        position's logits."""
        logits, dcache = lm_model.decode_window(
            self.dparams, self.dcfg, self.dctx, dcache, tokens, pos_start,
            attn_lib.CONTIGUOUS, write_mask=write_mask, logits_all=True)
        return logits[:, -1:], dcache

    def _d_step(self, dcache: Params, tokens: torch.Tensor, pos: torch.Tensor,
                write_mask: torch.Tensor):
        return lm_model.decode_step(self.dparams, self.dcfg, self.dctx, dcache,
                                    tokens, pos, kv=attn_lib.CONTIGUOUS,
                                    write_mask=write_mask)

    def _d_truncate(self, dcache: Params, lengths: torch.Tensor) -> Params:
        return lm_model.cache_truncate(self.dcfg, dcache, lengths,
                                       attn_lib.CONTIGUOUS)

    def _d_reset(self, dcache: Params, slot: int) -> Params:
        return lm_model.cache_reset(self.dcfg, dcache, slot,
                                    attn_lib.CONTIGUOUS)

    @property
    def paged(self) -> bool:
        return isinstance(self.kv, attn_lib.PagedKVCache)

    def _prefill(self, tokens: torch.Tensor):
        return lm_model.prefill(self.params, self.cfg, self.ctx, tokens,
                                cache_len=self.ecfg.cache_len)

    def _decode(self, cache: Params, tokens: torch.Tensor, pos: torch.Tensor,
                write_mask: torch.Tensor | None = None):
        return lm_model.decode_step(self.params, self.cfg, self.ctx, cache,
                                    tokens, pos, kv=self.kv,
                                    write_mask=write_mask)

    def _window(self, cache: Params, tokens: torch.Tensor,
                pos_start: torch.Tensor, write_mask: torch.Tensor):
        return lm_model.decode_window(self.params, self.cfg, self.ctx, cache,
                                      tokens, pos_start, self.kv,
                                      write_mask=write_mask)

    def _map_slot(self, cache: Params, slot: int, row: list[int],
                  fresh: list[int]) -> Params:
        """Point slot ``slot``'s table row at blocks ``row`` in every layer,
        after resetting the freshly allocated blocks ``fresh`` to empty."""
        row_t = torch.as_tensor(row, dtype=torch.int32, device=self.device)
        fresh_t = torch.as_tensor(fresh, dtype=torch.long, device=self.device)
        for lc in cache["layers"]:
            lc["pool_pos"][fresh_t] = -1
            lc["table"][slot] = row_t
        return cache

    def _insert(self, cache: Params, sub: Params, slots: torch.Tensor):
        return lm_model.cache_insert(cache, sub, slots, self.kv)

    def _reset(self, cache: Params, slot: int):
        return lm_model.cache_reset(self.cfg, cache, slot, self.kv)

    def init_cache(self) -> Params:
        """A fresh all-slots-empty serving cache (batch x cache_len)."""
        return lm_model.init_cache(self.cfg, self.ecfg.batch,
                                   self.ecfg.cache_len,
                                   self.ctx.compute_dtype, self.device,
                                   kv=self.kv)

    def _sample(self, logits: torch.Tensor, gens, temps,
                active: torch.Tensor | None = None) -> torch.Tensor:
        """Per-row sampling: greedy rows (temp <= 0) take the argmax (the
        first maximum, as ``jnp.argmax``), sampled rows draw from their own
        generator.  ``gens=None`` is the all-greedy fast path."""
        last = logits[:, -1, :]
        tok = torch.argmax(last, dim=-1)
        if gens is not None:
            for r, (g, t) in enumerate(zip(gens, temps)):
                if t > 0:
                    probs = torch.softmax(last[r].to(torch.float32) / t, dim=-1)
                    tok[r] = torch.multinomial(probs, 1, generator=g)[0]
        if active is not None:
            # retired slots decode junk; pin them to 0
            tok = torch.where(active, tok, torch.zeros_like(tok))
        return tok.to(torch.int32)

    def generate(self, prompts: np.ndarray) -> np.ndarray:
        """prompts: (B, S_prompt) int32 -> (B, max_new_tokens) int32.

        .. deprecated::
            the legacy fixed-batch surface; submit :class:`Request` objects
            to a :class:`Scheduler` instead.  Rows that stop early on
            ``eos_id`` are padded with the stop token."""
        warnings.warn(
            "Engine.generate is the deprecated fixed-batch surface; "
            "submit Request objects to a Scheduler instead",
            DeprecationWarning, stacklevel=2)
        prompts = np.asarray(prompts)
        b, _ = prompts.shape
        sched = Scheduler(self)
        for i in range(b):
            sched.submit(Request(prompt=prompts[i], rid=i))
        results = sched.run()
        self.last_stats = sched.stats
        n = self.ecfg.max_new_tokens
        out = np.zeros((b, n), np.int32)
        for i in range(b):
            toks = results[i]
            out[i, :len(toks)] = toks
            if 0 < len(toks) < n:  # early EOS: pad with the stop token
                out[i, len(toks):] = toks[-1]
        return out


class Scheduler:
    """Continuous-batching scheduler over an :class:`Engine`.

    ``submit`` queues requests; ``run`` drives admission / decode /
    retirement until queue and batch drain, returning ``{rid: (n_tokens,)
    int32}`` (the emitted stream, ending with the eos token when one
    triggered retirement).  With a paged engine the loop swaps grouped
    prefill for per-request chunked prefill + prefix sharing (module
    docstring has the invariants)."""

    # per-row `lengths` for rows the batch-wide truncate must not touch
    # (idle / prefilling / just-retired rows: a retired slot's blocks may be
    # shared, and truncating them would corrupt the surviving holder)
    NO_TRUNC = 1 << 30

    def __init__(self, engine: Engine):
        self.eng = engine
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[SlotState | None] = [None] * engine.ecfg.batch
        self.stats = SchedulerStats()
        self.last_stats = self.stats  # the same object, as run() leaves it
        self._results: dict[int, np.ndarray] = {}
        self._next_rid = 0
        # spec mode: the token at pos-1 per slot (the draft's restart window
        # re-feeds it) and the draft's own contiguous cache
        self._prev = np.zeros((engine.ecfg.batch,), np.int32)
        self._dcache: Params | None = None
        if engine.paged:
            bs = engine.kv.block_size
            self.bps = engine.ecfg.cache_len // bs
            self.alloc = BlockAllocator(engine.ecfg.batch * self.bps, bs)

    def submit(self, request: Request) -> int:
        if request.rid is None:
            request.rid = self._next_rid
        taken = ({r.rid for r in self.queue} | set(self._results)
                 | {s.rid for s in self.slots if s is not None})
        if request.rid in taken:
            raise ValueError(f"duplicate rid {request.rid}: results are "
                             "keyed by rid, a collision would drop one "
                             "request's stream")
        self._next_rid = max(self._next_rid, request.rid) + 1
        self.queue.append(request)
        return request.rid

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _retire(self, i: int, st: SlotState) -> None:
        self._results[st.rid] = np.asarray(st.tokens, np.int32)
        self.stats.t_done[st.rid] = self._now()
        self.slots[i] = None

    def _emit(self, i: int, st: SlotState, token: int) -> bool:
        """Record one emitted token; retire the slot on eos / budget
        exhaustion.  Returns True when the slot retired."""
        now = self._now()
        if not st.tokens:
            self.stats.t_first[st.rid] = now
        self.stats.t_tokens.setdefault(st.rid, []).append(now)
        st.tokens.append(token)
        st.budget -= 1
        if st.budget <= 0 or (st.eos_id is not None and token == st.eos_id
                              and len(st.tokens) >= st.min_tokens):
            self._retire(i, st)
            return True
        return False

    def _sample_for(self, logits, states, active=None) -> np.ndarray:
        """Sample one token per row; all-greedy batches take the argmax
        fast path."""
        temps = [float(st.temperature) if st is not None else 0.0
                 for st in states]
        gens = None
        if any(t > 0 for t in temps):
            gens = [st.generator if st is not None else None for st in states]
        return self.eng._sample(logits, gens, temps, active).cpu().numpy()

    def _new_state(self, r: Request) -> SlotState:
        ecfg = self.eng.ecfg
        sp = resolve_sampling(r, ecfg)
        if self.eng.speculative:
            if sp.temperature and sp.temperature > 0:
                raise ValueError(
                    f"rid {r.rid}: speculative decoding is greedy-only "
                    f"(got temperature {sp.temperature})")
            need = len(r.prompt) + sp.max_new_tokens + ecfg.spec_len
            if need > ecfg.cache_len:
                raise ValueError(
                    f"rid {r.rid}: cache_len {ecfg.cache_len} < prompt "
                    f"({len(r.prompt)}) + budget ({sp.max_new_tokens}) + "
                    f"spec_len ({ecfg.spec_len}): the verify window would "
                    f"write past the cache")
        gen = None
        if sp.temperature and sp.temperature > 0:
            gen = _request_generator(sp.seed, r.rid, self.eng.device)
        return SlotState(
            rid=r.rid, prompt_len=len(r.prompt), budget=sp.max_new_tokens,
            eos_id=sp.eos_id, min_tokens=sp.min_tokens,
            temperature=sp.temperature, seed=sp.seed, generator=gen)

    def _admit(self, cache, tok, pos):
        """Fill free slots from the queue head.  The maximal FIFO run of
        same-prompt-length requests prefills as ONE call; each request's
        cache rows land in its slot via ``cache_insert`` and its first token
        comes from the prefill logits."""
        eng = self.eng
        free = [i for i, s in enumerate(self.slots) if s is None]
        while free and self.queue:
            head_len = len(self.queue[0].prompt)
            group: list[Request] = [self.queue.popleft()]
            while (self.queue and len(group) < len(free)
                   and len(self.queue[0].prompt) == head_len):
                group.append(self.queue.popleft())
            taken, free = free[:len(group)], free[len(group):]

            prompts = np.stack([np.asarray(r.prompt) for r in group])
            states = [self._new_state(r) for r in group]
            tokens = self._device(prompts, torch.long)
            logits, sub_cache = eng._prefill(tokens)
            self.stats.prefills += 1
            first = self._sample_for(logits, states)
            cache = eng._insert(cache, sub_cache, self._device(taken))
            if eng.speculative:
                # the draft prefills the same group into the same slots of
                # its own cache; its first proposal comes from the next
                # round's restart window
                _, d_sub = eng._d_prefill(tokens)
                self._dcache = eng._d_insert(self._dcache, d_sub,
                                             self._device(taken))
            start_pos = prompts.shape[1]
            for g, i in enumerate(taken):
                st = states[g]
                self.slots[i] = st
                self.stats.admissions.append((st.rid, i))
                if st.budget <= 0:  # zero-token request: empty stream
                    self._retire(i, st)
                    free.append(i)
                elif self._emit(i, st, int(first[g])):
                    free.append(i)  # eos/budget hit on the first token
                else:
                    tok[i] = first[g]
                    pos[i] = start_pos
                    self._prev[i] = prompts[g, -1]
        return cache, tok, pos

    def _device(self, x: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.eng.device)

    @torch.inference_mode()
    def run(self) -> dict[int, np.ndarray]:
        if self.eng.paged:
            return self._run_paged()
        eng, ecfg = self.eng, self.eng.ecfg
        self._t0 = time.perf_counter()
        cache = eng.init_cache()
        if eng.speculative:
            self._dcache = eng.d_init_cache()
        b = ecfg.batch
        tok = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)

        while self.queue or any(s is not None for s in self.slots):
            cache, tok, pos = self._admit(cache, tok, pos)
            active = np.array([s is not None for s in self.slots])
            if not active.any():
                continue  # everything admitted retired on its first token
            if eng.speculative:
                cache, tok, pos = self._spec_round(cache, tok, pos, active)
                continue
            logits, cache = eng._decode(
                cache, self._device(tok, torch.long)[:, None],
                self._device(pos))
            sampled = self._sample_for(logits, self.slots,
                                       self._device(active))
            self.stats.steps += 1
            pos = np.where(active, pos + 1, pos).astype(np.int32)
            tok = np.where(active, sampled, tok).astype(np.int32)
            for i in range(b):
                st = self.slots[i]
                if st is not None and self._emit(i, st, int(sampled[i])):
                    cache = eng._reset(cache, i)
        self.last_stats = self.stats
        return self._results

    # -- speculative rounds (both cache layouts) ---------------------------

    def _spec_round(self, cache, tok, pos, dec):
        """One speculative round for every decoding row (``dec``).

        Draft: the width-2 restart window ``[prev, tok]`` at ``(pos-1,
        pos)``, then ``spec_len - 1`` single steps, its proposals kept on
        the device.  Target: ONE ``logits_all`` verify window over ``[tok,
        d_1..d_s]``, then one host read of the proposals and the target's
        picks.  Per row the leading run of proposals that match the
        target's picks is accepted and ``n + 1`` tokens emit; both caches
        roll back to the shared per-row ``lengths = pos + n + 1`` (skipped
        when no row rolled back), and then the rows that retired are reset
        or released.  Module docstring: the invariants."""
        eng, ecfg = self.eng, self.eng.ecfg
        b, s_len = ecfg.batch, ecfg.spec_len
        dm = self._device(dec)

        d_logits, self._dcache = eng._d_window(
            self._dcache, self._device(np.stack([self._prev, tok], axis=1),
                                       torch.long),
            self._device(pos - 1), dm)
        cur = eng._sample(d_logits, None, None, dm)
        props = [cur]
        dpos = self._device(pos + 1)
        for _ in range(1, s_len):
            d_logits, self._dcache = eng._d_step(
                self._dcache, cur.long()[:, None], dpos, dm)
            cur = eng._sample(d_logits, None, None, dm)
            props.append(cur)
            dpos = dpos + 1
        props_d = torch.stack(props, dim=1).long()  # (B, s)
        win = torch.cat([self._device(tok, torch.long)[:, None], props_d], 1)
        logits, cache = eng._verify(cache, win, self._device(pos), dm)
        self.stats.steps += 1
        picks = torch.cat([props_d, torch.argmax(logits, dim=-1)], 1)
        picks = picks.cpu().numpy().astype(np.int32)  # the round's host read
        props, greedy = picks[:, :s_len], picks[:, s_len:]

        lengths = np.full((b,), self.NO_TRUNC, np.int32)
        rolled = False
        retired: list[tuple[int, SlotState]] = []
        for i in range(b):
            st = self.slots[i]
            if not dec[i] or st is None:
                continue
            n = 0
            while n < s_len and props[i, n] == greedy[i, n]:
                n += 1
            self.stats.spec_rounds += 1
            self.stats.spec_proposed += s_len
            self.stats.spec_accepted += n
            done = False
            for j in range(n + 1):  # the target's pick rides along free
                if self._emit(i, st, int(greedy[i, j])):
                    done = True
                    break
            if done:
                retired.append((i, st))
                rolled = True  # the slot's window tail must not survive
            else:
                self._prev[i] = props[i, n - 1] if n > 0 else tok[i]
                tok[i] = greedy[i, n]
                pos[i] = pos[i] + n + 1
                lengths[i] = pos[i]
                rolled = rolled or n < s_len
        if rolled:
            # one per-row rollback for both models: the target wrote
            # pos..pos+s, the draft pos..pos+s-1; rows that accepted
            # everything carry lengths past their content (no-op)
            ln = self._device(lengths)
            cache = eng._truncate(cache, ln)
            self._dcache = eng._d_truncate(self._dcache, ln)
        for i, st in retired:
            if eng.paged:
                cache = self._release_slot(cache, i, st)
            else:
                cache = eng._reset(cache, i)
            self._dcache = eng._d_reset(self._dcache, i)
        return cache, tok, pos

    # -- paged path --------------------------------------------------------

    def _release_slot(self, cache, i: int, st: SlotState):
        """Retirement bookkeeping: drop every held block reference exactly
        once, then unmap the slot's table row."""
        st.blocks = self.alloc.trim(st.blocks, 0)
        return self.eng._reset(cache, i)

    def _admit_paged(self, cache):
        """Per-request admission: allocate the slot's block-table row
        (reusing registered prefix blocks when ``shared_prefix`` is on)
        and queue the slot for chunked prefill of the novel suffix."""
        eng, ecfg = self.eng, self.eng.ecfg
        bs = eng.kv.block_size
        for i in range(ecfg.batch):
            if self.slots[i] is not None or not self.queue:
                continue
            r = self.queue.popleft()
            prompt = np.ascontiguousarray(np.asarray(r.prompt, np.int32))
            st = self._new_state(r)
            st.phase = "prefill"
            st.prompt = prompt
            self.stats.admissions.append((st.rid, i))
            if st.budget <= 0:  # zero-token request: empty stream
                self.slots[i] = st
                self._retire(i, st)
                continue
            ln = len(prompt)
            n_sh = 0
            if ecfg.shared_prefix:
                # chain hash per FULL prompt block; block j's hash pins the
                # whole prefix prompt[:(j+1)*bs], not just its own tokens
                h = 0
                for j in range(ln // bs):
                    h = hash((h, prompt[j * bs:(j + 1) * bs].tobytes()))
                    st.block_hashes.append(h)
                # cap at (ln-1)//bs: the last prompt token (and everything
                # decode writes) stays strictly past every shared block
                for j in range((ln - 1) // bs):
                    blk = self.alloc.lookup(st.block_hashes[j])
                    if blk is None:
                        break
                    st.blocks.append(blk)
                    n_sh += 1
            fresh = [self.alloc.alloc() for _ in range(self.bps - n_sh)]
            st.blocks += fresh
            st.n_shared = n_sh
            st.prefill_done = n_sh * bs
            self.stats.shared_tokens += n_sh * bs
            self.slots[i] = st
            cache = eng._map_slot(cache, i, st.blocks, fresh)
        return cache

    def _prefill_chunk(self, cache, tok, pos, pre: list[int], chunk: int):
        """Advance every prefilling slot by one window of up to ``chunk``
        tokens (width = min remaining, so no row overruns its prompt).  A
        row whose window ends on its last prompt token samples its first
        output from the window logits and flips to decode."""
        eng, ecfg = self.eng, self.eng.ecfg
        b = ecfg.batch
        c = min([self.slots[i].prompt_len - self.slots[i].prefill_done
                 for i in pre] + [chunk])
        tokens = np.zeros((b, c), np.int32)
        pos_start = np.zeros((b,), np.int32)
        wm = np.zeros((b,), bool)
        for i in pre:
            st = self.slots[i]
            tokens[i] = st.prompt[st.prefill_done:st.prefill_done + c]
            pos_start[i] = st.prefill_done
            wm[i] = True
        logits, cache = eng._window(cache, self._device(tokens, torch.long),
                                    self._device(pos_start),
                                    self._device(wm))
        self.stats.prefills += 1
        self.stats.prefill_tokens += c * len(pre)
        fin = [i for i in pre
               if self.slots[i].prefill_done + c == self.slots[i].prompt_len]
        first = None
        if fin:
            states = [self.slots[i] if i in fin else None for i in range(b)]
            first = self._sample_for(
                logits, states,
                self._device(np.array([s is not None for s in states])))
        for i in pre:
            st = self.slots[i]
            st.prefill_done += c
            if st.prefill_done < st.prompt_len:
                continue
            if ecfg.shared_prefix:
                # the slot's own full prompt blocks are now written; make
                # them discoverable for later identical-prefix requests
                for j in range(st.n_shared, len(st.block_hashes)):
                    self.alloc.register(st.blocks[j], st.block_hashes[j])
            st.phase = "decode"
            if eng.speculative:
                # the draft keeps its own contiguous prefill of the whole
                # prompt; the restart window re-syncs it every round
                _, d_sub = eng._d_prefill(self._device(st.prompt[None],
                                                       torch.long))
                self._dcache = eng._d_insert(self._dcache, d_sub,
                                             self._device([i]))
                self._prev[i] = int(st.prompt[-1])
            st.prompt = None  # the cache holds it now
            if self._emit(i, st, int(first[i])):
                cache = self._release_slot(cache, i, st)
            else:
                tok[i] = first[i]
                pos[i] = st.prompt_len
        return cache, tok, pos

    def _run_paged(self) -> dict[int, np.ndarray]:
        eng, ecfg = self.eng, self.eng.ecfg
        self._t0 = time.perf_counter()
        cache = eng.init_cache()
        if eng.speculative:
            self._dcache = eng.d_init_cache()
        b = ecfg.batch
        tok = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)
        chunk = ecfg.prefill_chunk or ecfg.cache_len

        while self.queue or any(s is not None for s in self.slots):
            cache = self._admit_paged(cache)
            pre = [i for i, s in enumerate(self.slots)
                   if s is not None and s.phase == "prefill"]
            if pre:
                cache, tok, pos = self._prefill_chunk(cache, tok, pos, pre,
                                                      chunk)
            dec = np.array([s is not None and s.phase == "decode"
                            for s in self.slots])
            if not dec.any():
                continue  # all slots still prefilling (or just drained)
            if eng.speculative:
                cache, tok, pos = self._spec_round(cache, tok, pos, dec)
                continue
            dec_t = self._device(dec)
            logits, cache = eng._decode(
                cache, self._device(tok, torch.long)[:, None],
                self._device(pos), dec_t)
            states = [s if (s is not None and s.phase == "decode") else None
                      for s in self.slots]
            sampled = self._sample_for(logits, states, dec_t)
            self.stats.steps += 1
            pos = np.where(dec, pos + 1, pos).astype(np.int32)
            tok = np.where(dec, sampled, tok).astype(np.int32)
            for i in range(b):
                st = self.slots[i]
                if (st is not None and st.phase == "decode"
                        and self._emit(i, st, int(sampled[i]))):
                    cache = self._release_slot(cache, i, st)
        self.last_stats = self.stats
        return self._results
