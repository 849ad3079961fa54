"""PyTorch / CUDA port of the BMXNet reproduction (the JAX package
``repro`` is the reference it is held against).

Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
asked for the GPU on a machine without one; tests pass ``device="cpu"``,
where every hand-written kernel's plain PyTorch version runs instead."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Validate ``device``.  ``"cuda"`` without a GPU raises — the port
    never carries on on the CPU in its place.  On the GPU it also switches
    off every reduced-precision matmul mode: the fake-quant ±1 products must
    be exact integer sums (§2.2.2), which TF32 or a reduced-precision bf16
    split-K reduction would break."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA GPU is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
