"""Paper Table 2: partially binarized ResNet-18 — keep chosen stages full
precision, binarize the rest.  Reproduces the size column exactly and the
accuracy ORDERING on synthetic data (fp >= partial >= binary).  The port's
twin of ``examples/partial_binarization.py``.

Run:  PYTHONPATH=src python -m repro_torch.launch.partial_binarization \\
          --device cpu [--train] [--steps 60]
(``--device cuda``, the default, runs on the card.)
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import converter
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import cnn, registry
from repro_torch.nn.common import QCtx
from repro_torch.optim import adamw
from repro_torch.train import trainer

STAGES = {
    "none": (),
    "1st": ("stage1",),
    "1st,2nd": ("stage1", "stage2"),
    "all": ("stage1", "stage2", "stage3", "stage4"),
}


def sizes(device="cuda") -> dict[str, int]:
    """Table 2's size column (ImageNet-head ResNet-18): bytes after
    conversion per variant."""
    print("== Table 2 size column (ImageNet-head ResNet-18) ==")
    dev = resolve_device(device)
    cfg = dataclasses.replace(registry.get("resnet18-cifar10").config,
                              n_classes=1000, stem_stride=2, in_hw=224)
    params = cnn.resnet18_init(torch.Generator(device=dev).manual_seed(0), cfg)
    out = {}
    for name, fp_stages in STAGES.items():
        pol = QuantPolicy.binary().with_fp_stages(fp_stages)
        _, rep = converter.convert(params, pol)
        out[name] = rep.bytes_after
        print(f"  fp_stages={name:<8} size={rep.bytes_after / 1e6:6.2f}MB")
    print("  (paper: none=3.6, 1st=4.1, 1st+2nd=6.2, all=47MB)")
    return out


def train_variant(fp_stages, steps=60, seed=0, device="cuda") -> float:
    """Train smoke ResNet-18 with ``fp_stages`` kept full precision;
    returns the test accuracy."""
    dev = resolve_device(device)
    cfg = registry.get("resnet18-cifar10").smoke
    pol = QuantPolicy.binary().with_fp_stages(fp_stages)
    ctx = QCtx(policy=pol, compute_dtype=torch.float32)
    params = cnn.resnet18_init(torch.Generator(device=dev).manual_seed(seed),
                               cfg)
    opt_cfg = adamw.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=steps,
                                weight_decay=0.0)
    opt = adamw.init(params)
    step = trainer.make_classifier_step(cnn.resnet18_forward, cfg, ctx,
                                        opt_cfg)
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((10, cfg.in_hw, cfg.in_hw, 3)).astype(
        np.float32)

    def data(n):
        y = rng.integers(0, 10, n)
        x = templates[y] + 0.5 * rng.standard_normal(
            (n, cfg.in_hw, cfg.in_hw, 3)).astype(np.float32)
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    for _ in range(steps):
        x, y = data(32)
        params, opt, _ = step(params, opt, x, y)
    xt, yt = data(256)
    with torch.no_grad():
        logits = cnn.resnet18_forward(params, cfg, ctx, xt)
    return float((logits.argmax(-1) == yt).to(torch.float32).mean())


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true",
                    help="also train each variant on synthetic data")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {"sizes": sizes(args.device)}
    if args.train:
        print("== accuracy ordering (synthetic; direction only) ==")
        out["accuracy"] = {}
        for name, fp_stages in STAGES.items():
            acc = train_variant(fp_stages, steps=args.steps,
                                device=args.device)
            out["accuracy"][name] = acc
            print(f"  fp_stages={name:<8} acc={acc:.3f}")
    return out


if __name__ == "__main__":
    main()
