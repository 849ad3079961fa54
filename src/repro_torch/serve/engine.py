"""Serving engine: a continuous-batching scheduler over the packed-GEMM
decode step on the contiguous KV cache (PyTorch port of the contiguous lm
path of ``repro.serve.engine``).

``Scheduler`` owns a FIFO request queue and ``EngineConfig.batch`` KV-cache
slots:

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

Greedy outputs are bit-identical to per-request generation because every
per-token op is batch-row independent.  Sampling at temperature > 0 draws
from a ``torch.Generator`` seeded per request from ``(seed, rid)`` and
advanced once per emitted token, so a request's stream does not depend on
its batchmates; it cannot reproduce the JAX package's threefry streams.

Paged KV, speculative decoding, fused decode attention and the whisper
family are not in this slice.
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


@dataclasses.dataclass
class SchedulerStats:
    steps: int = 0  # decode steps executed
    prefills: int = 0  # prefill (admission) calls
    admissions: list = dataclasses.field(default_factory=list)  # (rid, slot)
    t_first: dict = dataclasses.field(default_factory=dict)  # rid -> s
    t_done: dict = dataclasses.field(default_factory=dict)  # rid -> s
    # per-request emission timestamps (rid -> [s], run-relative)
    t_tokens: dict = dataclasses.field(default_factory=dict)

    def ttfts(self) -> list:
        """Per-request time-to-first-token (seconds, run-relative)."""
        return [v[0] for v in self.t_tokens.values() if v]

    def tpots(self) -> list:
        """Per-token inter-emission gaps (seconds), pooled over requests."""
        return [b - a for v in self.t_tokens.values()
                for a, b in zip(v, v[1:])]


def _request_generator(seed: int, rid: int, device) -> torch.Generator:
    """The per-request sampling stream, rooted at (seed, rid)."""
    state = np.random.SeedSequence([seed, rid]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


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
        self.spec, self.cfg, self.ctx, self.ecfg = spec, cfg, ctx, ecfg
        self.params = params
        self.device = params["embed"]["table"].device

    def _prefill(self, tokens: torch.Tensor):
        return lm_model.prefill(self.params, self.cfg, self.ctx, tokens,
                                cache_len=self.ecfg.cache_len)

    def _decode(self, cache: Params, tokens: torch.Tensor, pos: torch.Tensor):
        return lm_model.decode_step(self.params, self.cfg, self.ctx, cache,
                                    tokens, pos)

    def _insert(self, cache: Params, sub: Params, slots: torch.Tensor):
        return lm_model.cache_insert(cache, sub, slots)

    def _reset(self, cache: Params, slot: int):
        return lm_model.cache_reset(self.cfg, cache, slot)

    def init_cache(self) -> Params:
        """A fresh all-slots-empty serving cache (batch x cache_len)."""
        return lm_model.init_cache(self.cfg, self.ecfg.batch,
                                   self.ecfg.cache_len,
                                   self.ctx.compute_dtype, self.device)

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
    triggered retirement)."""

    def __init__(self, engine: Engine):
        self.eng = engine
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[SlotState | None] = [None] * engine.ecfg.batch
        self.stats = SchedulerStats()
        self._results: dict[int, np.ndarray] = {}
        self._next_rid = 0

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
        sp = resolve_sampling(r, self.eng.ecfg)
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
            logits, sub_cache = eng._prefill(
                torch.as_tensor(prompts, dtype=torch.long, device=eng.device))
            self.stats.prefills += 1
            first = self._sample_for(logits, states)
            cache = eng._insert(cache, sub_cache,
                                torch.as_tensor(taken, device=eng.device))
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
        return cache, tok, pos

    @torch.inference_mode()
    def run(self) -> dict[int, np.ndarray]:
        eng, ecfg = self.eng, self.eng.ecfg
        self._t0 = time.perf_counter()
        cache = eng.init_cache()
        b = ecfg.batch
        tok = np.zeros((b,), np.int32)
        pos = np.zeros((b,), np.int32)

        while self.queue or any(s is not None for s in self.slots):
            cache, tok, pos = self._admit(cache, tok, pos)
            active = np.array([s is not None for s in self.slots])
            if not active.any():
                continue  # everything admitted retired on its first token
            logits, cache = eng._decode(
                cache,
                torch.as_tensor(tok, dtype=torch.long, device=eng.device)[:, None],
                torch.as_tensor(pos, device=eng.device))
            sampled = self._sample_for(
                logits, self.slots, torch.as_tensor(active, device=eng.device))
            self.stats.steps += 1
            pos = np.where(active, pos + 1, pos).astype(np.int32)
            tok = np.where(active, sampled, tok).astype(np.int32)
            for i in range(b):
                st = self.slots[i]
                if st is not None and self._emit(i, st, int(sampled[i])):
                    cache = eng._reset(cache, i)
        return self._results
