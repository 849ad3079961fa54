"""Training launcher — the port's end-to-end entry point for one-device
training (PyTorch port of ``repro.launch.train``):

  --arch <id> --smoke            reduced config (CPU-trainable)
  --quant fp|binary|w2a2|...     BMXNet policy for every internal GEMM
  --microbatch N --remat         sequential gradient accumulation over N
                                 chunks; per-block activation recompute
  --export-packed PATH           run the model converter after training and
                                 write the packed serving checkpoint, which
                                 ``python -m repro_torch.launch.serve
                                 --packed PATH`` serves
  --device cuda|cpu              default cuda; raises without a GPU

Params come from a ``torch.Generator`` seeded with ``--seed`` on the
device, batches from ``data/synthetic.batch_at`` (prefetched on a host
thread), AdamW warms up over ``max(steps // 20, 5)`` steps and decays over
``--steps``.  Binary policies log the per-step bit-flip rate (``flip=``).
Checkpointing and resume, gradient compression and model parallelism come
with the multi-GPU slice (ROADMAP A14); ``--tracker`` and ``--two-stage``
with tooling (A15).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --smoke --device cpu --steps 6 --batch 4 --seq 16 --quant binary \\
      --export-packed /tmp/g.packed.npz
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import resolve_device
from repro_torch.ckpt.manager import export_packed
from repro_torch.data import synthetic
from repro_torch.launch.serve import parse_quant
from repro_torch.models import registry
from repro_torch.nn.common import QCtx
from repro_torch.optim import adamw
from repro_torch.train import trainer


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="fp")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--export-packed", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = registry.get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    policy = parse_quant(args.quant)
    print(f"device: {dev}; {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, quant {args.quant}")

    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 5),
        total_steps=args.steps,
    )
    params, opt_state = trainer.init_all(
        spec, cfg, torch.Generator(device=dev).manual_seed(args.seed))
    step_fn = trainer.make_train_step(
        spec, cfg, QCtx(policy=policy, compute_dtype=torch.float32), opt_cfg,
        remat=args.remat, microbatch=args.microbatch or None,
        bit_flip_metrics_on=policy.w_bits == 1,
    )
    dcfg = synthetic.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
    )
    pf = synthetic.Prefetcher(lambda step: synthetic.batch_at(dcfg, step), 0)
    losses = []
    t0 = time.time()
    t_last, i_last = t0, 0
    try:
        for i in range(args.steps):
            _, batch = pf.next()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if (i + 1) % args.log_every == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items()}
                losses.append(m["loss"])
                now = time.time()
                tok_s = m["n_tokens"] * (i + 1 - i_last) / max(now - t_last,
                                                                1e-9)
                t_last, i_last = now, i + 1
                extra = (f" flip={m['bit_flip_rate']:.4f}"
                         if "bit_flip_rate" in m else "")
                print(f"step {i + 1:5d} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                      f"tok/s={tok_s:.0f}{extra} ({now - t0:.1f}s)",
                      flush=True)
    finally:
        pf.close()

    if args.export_packed:
        report = export_packed(params, policy, args.export_packed)
        print("packed export:", report.summary())
        with open(args.export_packed + ".report.json", "w") as f:
            json.dump({"fp32_bytes": report.bytes_fp32,
                       "packed_bytes": report.bytes_after,
                       "ratio": report.ratio}, f)
    return {"losses": losses, "params": params}


if __name__ == "__main__":
    main()
