"""Quantizers — BMXNet §2.1 (Eq. 1), §2.2 (binarization), §2.2.2 (Eq. 2),
PyTorch port of ``repro.core.quant``.

All quantizers are straight-through-estimator (STE) functions: forward is the
discrete map, backward passes the gradient through (clipped for sign, as in
XNOR-Net / BinaryConnect, which BMXNet follows).

``act_bit`` semantics follow the paper exactly:
  * 32      -> identity (full precision)
  * 1       -> binarization with ``sign`` into {-1, +1}
  * 2..31   -> DoReFa linear quantization (Eq. 1) on the appropriate range
"""

from __future__ import annotations

import torch

FULL_PRECISION = 32


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Forward ``q``, gradient of identity w.r.t. ``x``."""
    return x + (q - x).detach()


class _SignSTE(torch.autograd.Function):
    """sign into {-1,+1} with sign(0)=+1; clipped STE: dy/dx = 1[|x|<=1]."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        one = torch.ones((), dtype=x.dtype, device=x.device)
        return torch.where(x >= 0, one, -one)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """sign into {-1,+1} with sign(0)=+1; clipped STE: dy/dx = 1[|x|<=1]."""
    return _SignSTE.apply(x)


def quantize_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Paper Eq. 1: quantize ``x`` in [0,1] onto the k-bit grid, with STE.

        quantize(input, k) = round((2^k - 1) * input) / (2^k - 1)
    """
    n = float(2**k - 1)
    return _ste(x, torch.round(x * n) / n)


def _act_unit(x: torch.Tensor) -> torch.Tensor:
    """DoReFa activation pre-transform: clip into the [0, 1] grid domain.
    Shared by :func:`quantize_act` and :func:`act_codes`."""
    return torch.clamp(x, 0.0, 1.0)


def _weight_unit(w: torch.Tensor) -> torch.Tensor:
    """DoReFa weight pre-transform: ``tanh(w)/(2 max|tanh(w)|) + 1/2`` into
    [0, 1].  The max runs over the WHOLE tensor."""
    t = torch.tanh(w)
    return t / (2.0 * t.abs().max() + 1e-12) + 0.5


def quantize_act(x: torch.Tensor, bits: int) -> torch.Tensor:
    """QActivation: binarize (1 bit) or DoReFa-quantize activations.

    1 bit  -> sign(x) in {-1,+1}   (xnor-compatible)
    k bits -> quantize_k(clip(x, 0, 1), k)   (DoReFa activation quantizer)
    32     -> identity
    """
    if bits >= FULL_PRECISION:
        return x
    if bits == 1:
        return sign_ste(x)
    return quantize_k(_act_unit(x), bits)


def quantize_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Weight quantizer used by QConvolution / QFullyConnected.

    1 bit  -> sign(w) in {-1,+1}
    k bits -> DoReFa: 2 * quantize_k(tanh(w)/(2 max|tanh(w)|) + 1/2, k) - 1
    32     -> identity
    """
    if bits >= FULL_PRECISION:
        return w
    if bits == 1:
        return sign_ste(w)
    return 2.0 * quantize_k(_weight_unit(w), bits) - 1.0


def act_codes(x: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa activation codes: ``round(clip(x, 0, 1) * (2^bits - 1))`` as
    int64 in [0, 2^bits - 1].  ``quantize_act(x, bits) == codes / n``."""
    n = float(2**bits - 1)
    return torch.round(_act_unit(x) * n).to(torch.int64)


def weight_codes(w: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa weight codes (int64 in [0, 2^bits - 1]):

        quantize_weight(w, bits) == (2 * codes - n) / n,  n = 2^bits - 1.
    """
    n = float(2**bits - 1)
    return torch.round(_weight_unit(w) * n).to(torch.int64)


def weight_scale(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Per-output-channel alpha = mean|W| (XNOR-Net style, optional in BMXNet).

    ``axis`` is the contraction (input) axis of the weight.
    """
    return w.abs().mean(dim=axis, keepdim=True)


def xnor_range_map(dot: torch.Tensor, n: int) -> torch.Tensor:
    """Paper Eq. 2: map a ±1 dot product in [-n, n] (step 2) to the
    xnor+popcount count in [0, n] (step 1): out = (dot + n) / 2."""
    return (dot + n) / 2


def dot_range_map(counts: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of Eq. 2: xnor match count -> ±1 dot product."""
    return 2 * counts - n
