"""Serving launcher: initialise a model from a seed, convert it to packed
words, and serve requests through the continuous-batching scheduler on the
hand-written kernels (PyTorch port of ``repro.launch.serve``'s packed lm
path).

Params come from the port's own seeded init (a ``torch.Generator`` on the
device), then ``core/converter.convert`` under the ``--quant`` policy:
``binary`` (1-bit sign words, the default) or DoReFa ``wXaY`` such as
``w4a4`` / ``w8a8`` (bit-plane stacks; ``--backend vpu`` resolves onto the
``vpu-kX`` plane kernels and ``mxu`` onto ``mxu-kX`` per layer).  Compute
dtype is float32.  ``--check-fakequant`` also serves the float (fake-quant)
model: at 1 bit it asserts identical greedy tokens (paper §2.2.2); at k
bits, where packed and fake-quant agree per GEMM to fp32 rounding only, it
reports how many tokens agree and where the streams first part.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --backend vpu --check-fakequant
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --smoke --device cpu --quant w4a4 --check-fakequant
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


def parse_quant(s: str) -> QuantPolicy:
    """``fp`` | ``binary`` | ``binary_scaled`` | ``wXaY`` (e.g. ``w4a4``)."""
    if s == "fp":
        return QuantPolicy.full_precision()
    if s == "binary":
        return QuantPolicy.binary()
    if s == "binary_scaled":
        return QuantPolicy.binary(scale=True)
    if s.startswith("w") and "a" in s:  # e.g. w2a4
        w, a = s[1:].split("a")
        return QuantPolicy.quantized(int(w), int(a))
    raise ValueError(f"bad quant {s!r}")


def stream_agreement(got: dict, want: dict) -> tuple[int, int, int | None]:
    """(tokens that agree position by position, tokens in ``want``, index of
    the first differing token in rid order then position, or None)."""
    same = total = 0
    first = None
    for rid in sorted(want):
        a, b = np.asarray(got[rid]), np.asarray(want[rid])
        eq = a[: len(b)] == b[: len(a)]
        same += int(eq.sum())
        if first is None and (not eq.all() or len(a) != len(b)):
            first = total + (int(np.argmin(eq)) if not eq.all() else len(eq))
        total += len(b)
    return same, total, first


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
    ap.add_argument("--quant", default="binary",
                    help="binary | binary_scaled | wXaY (DoReFa, e.g. w4a4)")
    ap.add_argument("--backend", choices=("vpu", "mxu", "xla"), default="vpu",
                    help="base GEMM backend; k-bit layers resolve it onto "
                         "the vpu-k*/mxu-k* plane kernels")
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
                    help="also serve the fake-quant float model: assert "
                         "identical greedy tokens at 1 bit (paper §2.2.2), "
                         "report the agreement at k bits")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = registry.get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    policy = parse_quant(args.quant)
    ctx = QCtx(policy=policy, compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend=args.backend))

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm_model.init(gen, cfg)
    packed, report = converter.convert(params, policy)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"device {dev}, quant {args.quant}; packed {report.summary()}")
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
        agree, total, first = stream_agreement(results, ref)
        print(f"fake-quant: {total} tokens in {dt_f:.3f}s; packed == "
              f"fake-quant: {first is None} ({agree} of {total} tokens "
              f"agree, first difference at {first})")
        if first is not None and policy.w_bits == 1:
            raise SystemExit("§2.2.2 violated: packed tokens differ from "
                             "the fake-quant tokens")
    return results


if __name__ == "__main__":
    main()
