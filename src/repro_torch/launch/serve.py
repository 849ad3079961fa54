"""Serving launcher: initialise a model from a seed, convert it to packed
1-bit words, and serve requests through the continuous-batching scheduler
on the hand-written kernels (PyTorch port of ``repro.launch.serve``'s
packed lm path).

Params come from the port's own seeded init (a ``torch.Generator`` on the
device), then ``core/converter.convert`` under ``QuantPolicy.binary()``;
compute dtype is float32.  ``--check-fakequant`` also serves the float
(fake-quant) model and asserts identical greedy tokens — paper §2.2.2.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --backend vpu --check-fakequant
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --smoke --device cpu --prompts 2 --new-tokens 8
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import converter
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels.dispatch import GemmConfig
from repro_torch.models import lm as lm_model
from repro_torch.models import registry
from repro_torch.nn.common import QCtx
from repro_torch.serve.engine import Engine, EngineConfig, Request, Scheduler


def serve(eng: Engine, prompts: list[np.ndarray]) -> tuple[dict, float]:
    """Submit ``prompts`` to a fresh Scheduler; returns (results, seconds)."""
    sched = Scheduler(eng)
    for p in prompts:
        sched.submit(Request(prompt=p))
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    results = sched.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return results, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--backend", choices=("vpu", "mxu"), default="vpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth to N layers (widths stay)")
    ap.add_argument("--prompts", type=int, default=4,
                    help="requests to serve == scheduler KV-cache slots")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the params (torch.Generator) and prompts")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check-fakequant", action="store_true",
                    help="also serve the fake-quant float model and assert "
                         "identical greedy tokens (paper §2.2.2)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = registry.get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    policy = QuantPolicy.binary()
    ctx = QCtx(policy=policy, compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend=args.backend))

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm_model.init(gen, cfg)
    packed, report = converter.convert(params, policy)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"device {dev}; packed {report.summary()}")
    if not args.check_fakequant:
        del params

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, (args.prompt_len,)).astype(np.int32)
               for _ in range(args.prompts)]
    ecfg = EngineConfig(batch=args.prompts, cache_len=args.cache_len,
                        max_new_tokens=args.new_tokens, seed=args.seed)
    results, dt = serve(Engine(spec, cfg, ctx, packed, ecfg), prompts)
    n_tok = sum(len(v) for v in results.values())
    print(f"packed ({args.backend}): {n_tok} tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} tok/s)")
    for rid in sorted(results)[:4]:
        print(f"  rid={rid}: {results[rid][:12]}")

    if args.check_fakequant:
        ref, dt_f = serve(Engine(spec, cfg, ctx, params, ecfg), prompts)
        same = all(np.array_equal(results[r], ref[r]) for r in results)
        print(f"fake-quant: {sum(len(v) for v in ref.values())} tokens in "
              f"{dt_f:.3f}s; packed == fake-quant: {same}")
        if not same:
            raise SystemExit("§2.2.2 violated: packed tokens differ from "
                             "the fake-quant tokens")
    return results


if __name__ == "__main__":
    main()
