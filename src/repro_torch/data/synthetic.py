"""Deterministic synthetic data pipeline (a copy of ``repro.data.synthetic``;
numpy only, so the port keeps its own and imports nothing of the JAX
package).

No datasets are downloadable, so the pipeline generates a *learnable* token
stream: a noisy affine-recurrence language (``x_{t+1} = (a * x_t + b) mod
V`` with probability 1-eps, uniform noise otherwise).  A model that learns
the transition map drives CE well below ``log V``.

Batches are a pure function of ``(seed, host_id, step)``: a restarted host
replays exactly its own shard from the restored step.  ``Prefetcher``
overlaps host-side generation with device compute.  The vision and whisper
batches of the JAX module come with their model families (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of n_hosts {self.n_hosts}")
        return self.global_batch // self.n_hosts


def _mults(vocab: int) -> np.ndarray:
    # odd multipliers co-prime-ish with the vocab for varied transition maps
    return np.array([3, 5, 7, 11, 13, 17, 19, 23], np.int64)


def batch_at(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Pure (seed, host, step) -> {'tokens','targets'} with next-token
    targets.  int32, shapes (host_batch, seq_len)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, cfg.host_id, step])
    )
    b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
    # ONE transition map per dataset seed (not per sequence): the mapping is
    # then a learnable token-level function, so CE -> H(noise) < log V.
    map_rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 7]))
    mults = _mults(v)
    a = mults[map_rng.integers(0, len(mults), (1, 1))]
    off = map_rng.integers(0, v, (1, 1))
    x0 = rng.integers(0, v, (b, 1))
    seq = np.empty((b, s + 1), np.int64)
    seq[:, :1] = x0
    for t in range(1, s + 1):
        seq[:, t : t + 1] = (a * seq[:, t - 1 : t] + off) % v
    noise_mask = rng.random((b, s + 1)) < cfg.noise
    noise_tok = rng.integers(0, v, (b, s + 1))
    seq = np.where(noise_mask, noise_tok, seq)
    return {
        "tokens": seq[:, :-1].astype(np.int32),
        "targets": seq[:, 1:].astype(np.int32),
    }


class Prefetcher:
    """Background-thread prefetch of ``batch_fn(step)``; bounded queue.  An
    exception raised by ``batch_fn`` ends the thread and is raised again by
    the :meth:`next` call that would have returned its batch."""

    def __init__(self, batch_fn, start_step: int, depth: int = 2):
        self._fn = batch_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self._fn(step)
            except Exception as e:  # handed to the consumer, which re-raises
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return
            step += 1

    def next(self):
        step, batch = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
