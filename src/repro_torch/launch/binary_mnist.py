"""The paper's flagship example (smd_hpi/examples/binary_mnist): train a
binary LeNet and compare it with full precision — accuracy gap and model
size (paper Table 1: 0.97 vs 0.99, 206kB vs 4.6MB).  The port's twin of
``examples/binary_mnist.py``, with its own copies of the data and training
loop of ``benchmarks/accuracy_bench.py``.

Offline => procedurally generated MNIST-like data (10 fixed templates +
noise, from numpy seeds, the same images as the JAX example).  Absolute
accuracies differ from the paper's MNIST numbers; the *mechanism* (binary
trains about as well; 23x smaller) is the reproduction target.

Run:  PYTHONPATH=src python -m repro_torch.launch.binary_mnist --device cpu
(``--device cuda``, the default, trains and converts on the card; the
fake-quant training path runs no hand-written kernel.)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import converter
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import cnn, registry
from repro_torch.nn.common import QCtx
from repro_torch.optim import adamw
from repro_torch.train import trainer


def _data(rng, n, hw, n_classes=10, noise=0.4):
    # class templates are FIXED (own seed) — the label->image map must be
    # stationary across batches for the task to be learnable
    tmpl_rng = np.random.default_rng(42)
    templates = tmpl_rng.standard_normal((n_classes, hw, hw, 1)).astype(
        np.float32)
    labels = rng.integers(0, n_classes, n)
    imgs = templates[labels] + noise * rng.standard_normal(
        (n, hw, hw, 1)).astype(np.float32)
    return imgs, labels


def train_lenet(policy: QuantPolicy, steps=80, seed=0, device="cuda"):
    """Train smoke LeNet on synthetic MNIST; returns the test accuracy."""
    dev = resolve_device(device)
    cfg = registry.get("lenet-mnist").smoke
    ctx = QCtx(policy=policy, compute_dtype=torch.float32)
    params = cnn.lenet_init(torch.Generator(device=dev).manual_seed(seed), cfg)
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=steps,
                                weight_decay=0.0)
    opt = adamw.init(params)
    step = trainer.make_classifier_step(cnn.lenet_forward, cfg, ctx,
                                        opt_cfg)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        x, y = _data(rng, 64, cfg.in_hw)
        params, opt, _ = step(params, opt, torch.from_numpy(x).to(dev),
                              torch.from_numpy(y).to(dev))

    xt, yt = _data(np.random.default_rng(seed + 1), 512, cfg.in_hw)
    with torch.no_grad():
        logits = cnn.lenet_forward(params, cfg, ctx,
                                   torch.from_numpy(xt).to(dev))
    return float((logits.argmax(-1).cpu() == torch.from_numpy(yt))
                 .to(torch.float32).mean())


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== training LeNet fp32 vs binary (synthetic MNIST) ==")
    acc_fp = train_lenet(QuantPolicy.full_precision(), steps=args.steps,
                         device=dev)
    acc_bin = train_lenet(QuantPolicy.binary(), steps=args.steps, device=dev)
    print(f"  test accuracy  fp32={acc_fp:.3f}  binary={acc_bin:.3f} "
          f"(paper MNIST: 0.99 / 0.97)")

    cfg = registry.get("lenet-mnist").config  # full-size for the size table
    params = cnn.lenet_init(torch.Generator(device=dev).manual_seed(0), cfg)
    fp_bytes = converter.model_nbytes(params)
    _, rep = converter.convert(params, QuantPolicy.binary())
    print(f"  model size     fp32={fp_bytes / 1e6:.2f}MB  "
          f"binary={rep.bytes_after / 1e6:.3f}MB  ratio={rep.ratio:.1f}x "
          f"(paper: 4.6MB / 0.206MB)")
    return {"acc_fp32": acc_fp, "acc_binary": acc_bin, "fp32_bytes": fp_bytes,
            "binary_bytes": rep.bytes_after, "ratio": rep.ratio}


if __name__ == "__main__":
    main()
