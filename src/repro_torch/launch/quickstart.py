"""Quickstart: the full BMXNet lifecycle on a reduced LM, end to end — the
port's twin of ``examples/quickstart.py``, at its settings.

1. train a *binary* (1-bit weights & activations) granite-family LM (the
   smoke config, fp32 compute) on the synthetic pipeline: fake-quant
   matmuls with STE gradients, AdamW lr 5e-3, warmup 10, 120 steps of
   16 x 32 tokens, no remat;
2. convert it to packed 1-bit words with the model converter (§2.2.3);
3. serve the packed model on the xnor+popcount path and the float model on
   the fake-quant path through the continuous-batching ``Scheduler``, and
   require identical greedy tokens (§2.2.2).

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
(``--device cuda``, the default, serves on the hand-written kernels.)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import converter
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import synthetic
from repro_torch.launch.serve import serve
from repro_torch.models import registry
from repro_torch.nn.common import QCtx
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.train import trainer

ARCH = "granite-3-2b"
STEPS = 120
BATCH, SEQ = 16, 32
OPT = adamw.AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=STEPS)
POLICY = QuantPolicy.binary()
CTX = QCtx(policy=POLICY, compute_dtype=torch.float32)


def train(params, opt_state, on_step=None):
    """The quickstart's 120 steps from ``(params, opt_state)``, updated in
    place.  ``on_step(i, params, metrics)`` runs after each step."""
    spec = registry.get(ARCH)
    cfg = spec.smoke
    step_fn = trainer.make_train_step(spec, cfg, CTX, OPT, remat=False)
    dcfg = synthetic.DataConfig(cfg.vocab_size, seq_len=SEQ,
                                global_batch=BATCH)
    for i in range(STEPS):
        params, opt_state, m = step_fn(params, opt_state,
                                       synthetic.batch_at(dcfg, i))
        if on_step is not None:
            on_step(i, params, m)
    return params, opt_state


def serve_both(params, packed) -> tuple[dict, dict]:
    """Greedy streams (rid -> tokens) of the float model on the fake-quant
    path and of the packed model, two 8-token prompts, 12 new tokens."""
    spec = registry.get(ARCH)
    cfg = spec.smoke
    ecfg = EngineConfig(batch=2, cache_len=64, max_new_tokens=12)
    prompts = list(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    out_f = serve(Engine(spec, cfg, CTX, params, ecfg), prompts)[0]
    out_p = serve(Engine(spec, cfg, CTX, packed, ecfg), prompts)[0]
    return out_f, out_p


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = registry.get(ARCH)

    print(f"== 1. training binary {ARCH} (reduced config) on {dev} ==")
    params, opt_state = trainer.init_all(
        spec, spec.smoke, torch.Generator(device=dev).manual_seed(0))
    losses = []

    def log(i, _params, m):
        losses.append(float(m["loss"]))
        if (i + 1) % 20 == 0:
            print(f"  step {i + 1:4d}  loss {losses[-1]:.3f}")

    params, _ = train(params, opt_state, on_step=log)

    print("== 2. converting to packed 1-bit checkpoint ==")
    packed, report = converter.convert(params, POLICY)
    print(f"  {report.summary()}")

    print("== 3. serving packed vs fake-quant (must match exactly) ==")
    out_f, out_p = serve_both(params, packed)
    print(f"  float path : {out_f[0][:10]}")
    print(f"  packed path: {out_p[0][:10]}")
    if any(not np.array_equal(out_f[r], out_p[r]) for r in out_f):
        raise SystemExit("§2.2.2 equivalence violated!")
    print("  EXACT MATCH — train-with-floats / serve-with-bits verified.")
    return {"losses": losses, "fake_quant": out_f, "packed": out_p}


if __name__ == "__main__":
    main()
