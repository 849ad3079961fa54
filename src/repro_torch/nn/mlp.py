"""Feed-forward block: the gated MLP of the llama/gemma family (PyTorch port
of the dense part of ``repro.nn.mlp``; MoE waits for slice 4)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import qlayers
from repro_torch.nn.common import ACTIVATIONS, QCtx

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    act: str = "silu"
    gated: bool = True


def mlp_init(gen: torch.Generator, cfg: MLPConfig, *,
             dtype=torch.float32) -> Params:
    p = {
        "up": qlayers.dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
        "down": qlayers.dense_init(gen, cfg.d_ff, cfg.d_model, dtype=dtype),
    }
    if cfg.gated:
        p["gate"] = qlayers.dense_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype)
    return p


def mlp_apply(params: Params, x: torch.Tensor, cfg: MLPConfig, ctx: QCtx,
              path: str) -> torch.Tensor:
    act = ACTIVATIONS[cfg.act]
    up = ctx.dense(params["up"], x, f"{path}/up")
    if cfg.gated:
        gate = ctx.dense(params["gate"], x, f"{path}/gate")
        h = act(gate) * up
    else:
        h = act(up)
    return ctx.dense(params["down"], h, f"{path}/down")
