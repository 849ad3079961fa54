"""Paper-fidelity CNNs: binary LeNet (Listing 2) and ResNet-18 (PyTorch
port of ``repro.models.cnn``).

These are the models BMXNet itself evaluates (Table 1/2).  Block structure
follows the paper: *QActivation -> QConv/QFC -> BatchNorm -> Pool*, with the
first conv and the last FC always full precision.  ResNet-18 keeps MXNet's
4-ResUnit-stage layout so Table 2's per-stage partial binarization maps onto
policy rules ("stage1" ... "stage4").

Activations are NHWC and conv weights HWIO, as in the JAX package, so a
param tree carries across unchanged (``interop.params_from_numpy``).
BatchNorm normalises with the batch's statistics (population variance)
and a per-channel affine; momentum-tracked running stats are orthogonal to
the paper's contribution.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import qlayers
from repro_torch.nn.common import QCtx

Params = dict[str, Any]


def _bn_init(c: int, device) -> Params:
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def _bn(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), keepdim=True, correction=0)  # population
    xn = (x - mu) * torch.rsqrt(var + eps)
    return xn * params["scale"] + params["bias"]


def _pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """Max pool over H and W of NHWC ``x``, VALID.  ``max_pool2d`` routes a
    tie's gradient to the first maximum of the window, as XLA's
    select-and-scatter does (a 1-bit conv's integer sums tie often)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window,
                        stride).permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# LeNet (Table 1, MNIST)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    name: str = "lenet"
    n_classes: int = 10
    c1: int = 64
    c2: int = 64
    fc1: int = 1000  # matches the paper's 4.6MB full-precision size
    in_hw: int = 28
    in_c: int = 1


def lenet_init(gen: torch.Generator, cfg: LeNetConfig) -> Params:
    """Params on ``gen``'s device."""
    dev = gen.device
    # VALID 5x5 convs + two 2x2 pools (MXNet LeNet): 28->24->12->8->4,
    # giving fc1 input 4*4*64=1024 and the paper's 4.6MB fp32 size.
    hw = ((cfg.in_hw - 4) // 2 - 4) // 2
    return {
        "first_conv": qlayers.conv_init(gen, 5, 5, cfg.in_c, cfg.c1),
        "bn1": _bn_init(cfg.c1, dev),
        "conv2": qlayers.conv_init(gen, 5, 5, cfg.c1, cfg.c2),
        "bn2": _bn_init(cfg.c2, dev),
        "fc1": qlayers.dense_init(gen, hw * hw * cfg.c2, cfg.fc1),
        "bn3": _bn_init(cfg.fc1, dev),
        "head": qlayers.dense_init(gen, cfg.fc1, cfg.n_classes),
    }


def lenet_forward(params: Params, cfg: LeNetConfig, ctx: QCtx,
                  images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, n_classes) float32.

    Paper Listing 2: conv1 (fp) -> pool -> bn -> QConv -> bn -> pool ->
    QFC -> bn -> tanh -> FC (fp).
    """
    x = images.to(ctx.compute_dtype)
    x = ctx.conv(params["first_conv"], x, "first_conv", padding="VALID")
    x = torch.tanh(x)
    x = _pool(x)
    x = _bn(params["bn1"], x)
    x = ctx.conv(params["conv2"], x, "conv2", padding="VALID")
    x = _bn(params["bn2"], x)
    x = _pool(x)
    x = x.reshape(x.shape[0], -1)  # NHWC flatten: (h, w, c) order
    x = ctx.dense(params["fc1"], x, "fc1")
    x = _bn(params["bn3"], x[:, None, None, :])[:, 0, 0, :]
    x = torch.tanh(x)
    return ctx.dense(params["head"], x, "head").to(torch.float32)


# --------------------------------------------------------------------------
# ResNet-18 (Table 1 CIFAR-10 / Table 2 ImageNet)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResNet18Config:
    name: str = "resnet18"
    n_classes: int = 10
    widths: tuple[int, ...] = (64, 128, 256, 512)
    in_hw: int = 32
    in_c: int = 3
    stem_stride: int = 1  # 1 for CIFAR, 2 (+maxpool) for ImageNet


def _unit_stride(si: int, bi: int) -> int:
    return 2 if (bi == 0 and si > 0) else 1


def resnet18_init(gen: torch.Generator, cfg: ResNet18Config) -> Params:
    """Params on ``gen``'s device."""
    dev = gen.device
    p: Params = {
        "first_conv": qlayers.conv_init(gen, 3, 3, cfg.in_c, cfg.widths[0]),
        "bn0": _bn_init(cfg.widths[0], dev),
    }
    c_in = cfg.widths[0]
    for si, c_out in enumerate(cfg.widths):
        stage: Params = {}
        for bi in range(2):  # ResNet-18: two units per stage
            unit: Params = {
                "bn1": _bn_init(c_in, dev),
                "conv1": qlayers.conv_init(gen, 3, 3, c_in, c_out),
                "bn2": _bn_init(c_out, dev),
                "conv2": qlayers.conv_init(gen, 3, 3, c_out, c_out),
            }
            if _unit_stride(si, bi) != 1 or c_in != c_out:
                unit["proj"] = qlayers.conv_init(gen, 1, 1, c_in, c_out)
            stage[f"unit{bi}"] = unit
            c_in = c_out
        p[f"stage{si + 1}"] = stage
    p["bn_final"] = _bn_init(c_in, dev)
    p["head"] = qlayers.dense_init(gen, c_in, cfg.n_classes)
    return p


def _res_unit(unit: Params, x: torch.Tensor, stride: int, ctx: QCtx,
              path: str) -> torch.Tensor:
    h = _bn(unit["bn1"], x)
    h = ctx.conv(unit["conv1"], h, f"{path}/conv1", stride=stride,
                 padding="SAME")
    h = _bn(unit["bn2"], h)
    h = ctx.conv(unit["conv2"], h, f"{path}/conv2", stride=1, padding="SAME")
    if "proj" in unit:
        x = ctx.conv(unit["proj"], x, f"{path}/proj", stride=stride,
                     padding="SAME")
    return x + h


def resnet18_forward(params: Params, cfg: ResNet18Config, ctx: QCtx,
                     images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, n_classes) float32."""
    x = images.to(ctx.compute_dtype)
    x = ctx.conv(params["first_conv"], x, "first_conv",
                 stride=cfg.stem_stride, padding="SAME")
    x = _bn(params["bn0"], x)
    x = F.relu(x)
    for si in range(4):
        stage = params[f"stage{si + 1}"]
        for bi in range(2):
            x = _res_unit(stage[f"unit{bi}"], x, _unit_stride(si, bi), ctx,
                          f"stage{si + 1}/unit{bi}")
    x = _bn(params["bn_final"], x)
    x = F.relu(x)
    x = x.mean(dim=(1, 2))
    return ctx.dense(params["head"], x, "head").to(torch.float32)
