"""Shared NN building blocks: norms, RoPE, activations, the QCtx handle
(PyTorch port of ``repro.nn.common``).

Every internal GEMM in every model goes through ``QCtx.dense`` (or
``QCtx.conv``) so the BMXNet quantization policy (core/policy.py) applies
uniformly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import qlayers
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels.dispatch import GemmConfig

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class QCtx:
    """Carries the quantization policy, compute dtype and ``gemm_config``
    (how every packed GEMM executes) through a model.  ``mesh`` is the
    device mesh of an expert-parallel MoE (slice 6); the port runs on one
    device and leaves it None."""

    policy: QuantPolicy
    compute_dtype: Any = torch.bfloat16
    gemm_config: GemmConfig = GemmConfig()
    mesh: Any = None

    def dense(self, params: Params, x: torch.Tensor, path: str) -> torch.Tensor:
        return qlayers.qdense(params, x, self.policy.spec(path),
                              compute_dtype=self.compute_dtype,
                              gemm_config=self.gemm_config)

    def conv(self, params: Params, x: torch.Tensor, path: str,
             **kw) -> torch.Tensor:
        return qlayers.qconv(params, x, self.policy.spec(path),
                             compute_dtype=self.compute_dtype,
                             gemm_config=self.gemm_config, **kw)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device="cuda") -> Params:
    # gemma-style (1 + scale): scale starts at zeros
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device="cuda") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


def norm_init(kind: str, d: int, device="cuda") -> Params:
    return (rmsnorm_init(d, device=device) if kind == "rmsnorm"
            else layernorm_init(d, device=device))


def norm_apply(kind: str, params: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over concatenated halves (not interleaved pairs).
    x: (B, S, H, Dh); positions: (B, S) int."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "relu": F.relu,
    "tanh": torch.tanh,
}


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> Params:
    return {"table": torch.randn((vocab, d), generator=gen, dtype=dtype,
                                 device=gen.device)}


def embed_lookup(params: Params, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    return params["table"].to(compute_dtype)[tokens]
