"""Model converter — BMXNet §2.2.3 (PyTorch port of the dense part of
``repro.core.converter``).

Walks a float checkpoint (a nested dict/list of tensors) and, for every
dense layer the :class:`QuantPolicy` marks packable, replaces the float
weight ``w (d_in, d_out)`` with ``w_packed`` packed along the contraction
axis (the layout the GEMM kernels want): ``(d_out, Kw)`` int32 sign words at
1 bit, or a ``(w_bits, d_out, Kw)`` int32 bit-plane stack of DoReFa weight
codes at 2..8 bits (the codes of the whole layer tensor, as the fake-quant
path quantizes it).  An optional per-output-channel ``scale`` (XNOR-Net
alpha) rides along.  Everything else (embedding, norms, biases) is left
untouched.  ``convert`` returns the new tree and a :class:`SizeReport` with
the paper's accounting (k/32 of the fp32 bytes at k bits).

Expert stacks and conv weights wait for slices 4 and 5.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import bitpack, quant
from repro_torch.core.policy import QuantPolicy, QuantSpec

Pytree = Any


@dataclasses.dataclass
class LeafReport:
    path: str
    shape: tuple[int, ...]
    bytes_fp32: int
    bytes_after: int
    packed: bool


@dataclasses.dataclass
class SizeReport:
    leaves: list[LeafReport]

    @property
    def bytes_fp32(self) -> int:
        return sum(l.bytes_fp32 for l in self.leaves)

    @property
    def bytes_after(self) -> int:
        return sum(l.bytes_after for l in self.leaves)

    @property
    def ratio(self) -> float:
        return self.bytes_fp32 / max(self.bytes_after, 1)

    @property
    def n_packed(self) -> int:
        return sum(1 for l in self.leaves if l.packed)

    def summary(self) -> str:
        return (
            f"fp32={self.bytes_fp32 / 1e6:.2f}MB "
            f"packed={self.bytes_after / 1e6:.2f}MB "
            f"ratio={self.ratio:.1f}x ({self.n_packed} layers packed)"
        )


def _fp32_bytes(x: torch.Tensor) -> int:
    return x.numel() * 4  # the paper counts fp32 storage


def _packable(spec: QuantSpec) -> bool:
    """Does a packed serving layout exist for this spec?  1-bit (xnor) or
    the plane-packed DoReFa family (both widths in 2..8; wider stays
    fake-quantized)."""
    if spec.is_binary and spec.a_bits == 1:
        return True
    return 2 <= spec.w_bits <= 8 and 2 <= spec.a_bits <= 8


def _pack_flat(flat: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """(d_out, K) float -> packed words: sign bits at 1 bit, a (w_bits,
    d_out, Kw) plane stack of DoReFa weight codes at k bits."""
    if spec.is_binary:
        return bitpack.pack_sign(flat)
    return bitpack.pack_planes(quant.weight_codes(flat, spec.w_bits),
                               spec.w_bits)


def convert(params: Pytree, policy: QuantPolicy, *,
            keep_float: bool = False) -> tuple[Pytree, SizeReport]:
    """Pack all packable-policy dense weights.  ``keep_float`` additionally
    retains the float weight next to the packed one."""
    report = SizeReport(leaves=[])

    def rec(node: Pytree, path: str) -> Pytree:
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(node))
        if not isinstance(node, dict):
            report.leaves.append(LeafReport(
                path, tuple(node.shape), _fp32_bytes(node),
                node.numel() * node.element_size(), False))
            return node
        spec = policy.spec(path) if path else None
        w = node.get("w")
        if isinstance(w, torch.Tensor) and spec is not None and _packable(spec):
            if w.ndim != 2:
                raise NotImplementedError(
                    f"{path}: packing {w.ndim}-d weights (conv) comes with a "
                    "later slice of the port")
            return _pack_layer(node, path, spec, report, keep_float)
        return {k: rec(v, f"{path}/{k}" if path else k) for k, v in node.items()}

    return rec(params, ""), report


def _pack_layer(node, path, spec: QuantSpec, report: SizeReport,
                keep_float: bool):
    w = node["w"]  # (d_in, d_out)
    w_packed = _pack_flat(w.to(torch.float32).T, spec)  # (.., d_out, Kw)
    out = {"w_packed": w_packed}
    if spec.scale:
        out["scale"] = w.abs().mean(dim=0)
    if keep_float:
        out["w"] = w
    if "b" in node:
        out["b"] = node["b"]
    after = w_packed.numel() * 4
    if spec.scale:
        after += out["scale"].numel() * 4
    if "b" in node:
        after += _fp32_bytes(node["b"])
    report.leaves.append(LeafReport(
        f"{path}/w", tuple(w.shape),
        _fp32_bytes(w) + (_fp32_bytes(node["b"]) if "b" in node else 0),
        after, True))
    return out
