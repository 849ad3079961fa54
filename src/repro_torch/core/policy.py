"""Quantization policy — which layers compute at which bit width (PyTorch
port of ``repro.core.policy``; framework-free dataclasses).

BMXNet exposes ``act_bit`` per layer and follows two structural rules the
paper validates experimentally:

* never binarize the first and the last layer (§2, confirming XNOR-Net);
* optionally keep whole *stages* full precision (Table 2's partially
  binarized ResNet-18).

A :class:`QuantPolicy` is an ordered list of (regex, spec) rules over layer
*paths* (e.g. ``"layers/17/mlp/up"``), with a default spec and a set of
always-full-precision patterns.  Models query ``policy.spec(path)`` for
every internal GEMM.
"""

from __future__ import annotations

import dataclasses
import re

from repro_torch.core.quant import FULL_PRECISION


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Bit widths for one GEMM: weights / activations (paper's act_bit)."""

    w_bits: int = FULL_PRECISION
    a_bits: int = FULL_PRECISION
    scale: bool = False  # XNOR-Net per-output-channel alpha (opt-in)
    xnor_range: bool = False  # apply Eq. 2 map to the layer output

    @property
    def is_binary(self) -> bool:
        return self.w_bits == 1

    @property
    def is_fp(self) -> bool:
        return self.w_bits >= FULL_PRECISION and self.a_bits >= FULL_PRECISION


FP32_SPEC = QuantSpec()


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-path quantization rules.  First matching rule wins; ``fp_patterns``
    beat everything (the paper's first/last-layer rule)."""

    w_bits: int = FULL_PRECISION
    a_bits: int = FULL_PRECISION
    scale: bool = False
    xnor_range: bool = False
    rules: tuple[tuple[str, QuantSpec], ...] = ()
    # first conv / embedding / classifier head stay full precision (paper §2);
    # router + elementwise-recurrence auxiliaries are not GEMMs
    fp_patterns: tuple[str, ...] = ("embed", "lm_head", "head", "first",
                                    "frontend", "router", "rglru/conv")

    def spec(self, path: str) -> QuantSpec:
        for pat in self.fp_patterns:
            if re.search(pat, path):
                return FP32_SPEC
        for pat, spec in self.rules:
            if re.search(pat, path):
                return spec
        return QuantSpec(
            w_bits=self.w_bits,
            a_bits=self.a_bits,
            scale=self.scale,
            xnor_range=self.xnor_range,
        )

    @classmethod
    def full_precision(cls) -> "QuantPolicy":
        return cls()

    @classmethod
    def binary(cls, scale: bool = False, xnor_range: bool = False) -> "QuantPolicy":
        """The paper's BNN: 1-bit weights and activations everywhere except
        first/last."""
        return cls(w_bits=1, a_bits=1, scale=scale, xnor_range=xnor_range)

    @classmethod
    def quantized(cls, w_bits: int, a_bits: int | None = None) -> "QuantPolicy":
        """DoReFa-style k-bit (paper §2.1, 2 <= k <= 31)."""
        return cls(w_bits=w_bits, a_bits=a_bits if a_bits is not None else w_bits)

    def with_fp_stages(self, stage_patterns: tuple[str, ...]) -> "QuantPolicy":
        """Table 2: keep given stages full precision (e.g. ``("stage1",)``)."""
        rules = tuple((p, FP32_SPEC) for p in stage_patterns) + self.rules
        return dataclasses.replace(self, rules=rules)
