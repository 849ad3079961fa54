"""Model converter — BMXNet §2.2.3 (PyTorch port of
``repro.core.converter``).

Walks a float checkpoint (a nested dict/list of tensors) and, for every
dense or conv layer the :class:`QuantPolicy` marks packable, replaces the
float weight with ``w_packed`` packed along the contraction axis (the
layout the GEMM kernels want): ``(d_out, Kw)`` int32 sign words at 1 bit,
or a ``(w_bits, d_out, Kw)`` int32 bit-plane stack of DoReFa weight codes
at 2..8 bits (the codes of the whole layer tensor, as the fake-quant path
quantizes it).  A dense ``w (d_in, d_out)`` packs its transpose; a conv
``w (h, w, c_in, c_out)`` packs ``(c_out, h*w*c_in)``, the flattened patch
axis of the im2col path, and adds ``shape_hwio``, an int64 tensor on the
host (four numbers the packed conv reads on every call without a device
synchronisation).  An optional per-output-channel ``scale`` (XNOR-Net
alpha, over every axis but ``c_out`` for a conv) rides along.  Everything
else (embedding, first conv, norms, biases, head) is left untouched.
``convert`` returns the new tree and a :class:`SizeReport` with the paper's
accounting (k/32 of the fp32 bytes at k bits); :func:`model_nbytes` sizes
a whole checkpoint; :func:`derive_draft` cuts and packs a speculative draft
from a target LM.  ``convert(..., prefix=path)`` converts one subtree as it
would inside the whole model, which ``models/lm.init_packed`` uses to pack
a model one layer at a time.

MoE expert stacks (a dict of ``up`` / ``gate`` / ``down`` tensors of shape
``(E, d_in, d_out)``) pack per expert along ``d_in`` into ``{name}_packed``
``(E, d_out, Kw)`` sign words at 1 bit, or ``(E, w_bits, d_out, Kw)`` plane
stacks of the DoReFa codes of the whole stack at k bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import bitpack, quant
from repro_torch.core.policy import QuantPolicy, QuantSpec
from repro_torch.tree import tree_leaves

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
            keep_float: bool = False,
            prefix: str = "") -> tuple[Pytree, SizeReport]:
    """Pack all packable-policy dense and conv weights.  ``keep_float``
    additionally retains the float weight next to the packed one.
    ``prefix`` is the path of ``params`` inside its model (e.g.
    ``"layers/3"``): a subtree converted under its path converts as it
    would inside the whole tree."""
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
        if (isinstance(w, torch.Tensor) and w.ndim in (2, 4)
                and spec is not None and _packable(spec)):
            return _pack_layer(node, path, spec, report, keep_float)
        up = node.get("up")
        if (isinstance(up, torch.Tensor) and up.ndim == 3 and spec is not None
                and _packable(spec)):
            return _pack_experts(node, path, spec, report, keep_float)
        return {k: rec(v, f"{path}/{k}" if path else k) for k, v in node.items()}

    return rec(params, prefix), report


def _pack_experts(node, path, spec: QuantSpec, report: SizeReport,
                  keep_float: bool):
    """MoE expert stack: each ``(E, d_in, d_out)`` tensor -> ``(E, d_out,
    Kw)`` sign words at 1 bit, or an ``(E, w_bits, d_out, Kw)`` plane stack
    at k bits, packed per expert along the contraction axis.  The k-bit
    codes are taken over the whole stack: the DoReFa weight transform
    normalises by the tensor's global tanh-max, as the fake-quant path does
    (per-expert codes would drift from it)."""
    out = {}
    for name, w in node.items():  # up / gate / down
        flat = w.to(torch.float32).transpose(1, 2)  # (E, d_out, d_in)
        if spec.is_binary:
            w_packed = bitpack.pack_sign(flat)
        else:
            codes = quant.weight_codes(flat, spec.w_bits)
            w_packed = bitpack.pack_planes(codes, spec.w_bits).transpose(
                0, 1).contiguous()
        out[name + "_packed"] = w_packed
        if keep_float:
            out[name] = w
        report.leaves.append(LeafReport(f"{path}/{name}", tuple(w.shape),
                                        _fp32_bytes(w), w_packed.numel() * 4,
                                        True))
    return out


def _pack_layer(node, path, spec: QuantSpec, report: SizeReport,
                keep_float: bool):
    w = node["w"]
    if w.ndim == 2:  # (d_in, d_out)
        flat = w.T  # (d_out, d_in): pack along the contraction axis
        out = {}
        alpha_dims = (0,)
    else:  # (h, w, c_in, c_out)
        h, ww, c_in, c_out = w.shape
        flat = w.reshape(h * ww * c_in, c_out).T
        # int64 on the host, as the JAX converter's np.array
        out = {"shape_hwio": torch.tensor([h, ww, c_in, c_out],
                                          dtype=torch.int64, device="cpu")}
        alpha_dims = (0, 1, 2)
    w_packed = _pack_flat(flat.to(torch.float32), spec)  # (.., d_out, Kw)
    out["w_packed"] = w_packed
    if spec.scale:
        out["scale"] = w.abs().mean(dim=alpha_dims)
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


def derive_draft(params: Pytree, cfg, *, n_layers: int | None = None,
                 policy: QuantPolicy | None = None,
                 keep_float: bool = False) -> tuple[Pytree, Any, SizeReport]:
    """A speculative draft from a target LM checkpoint: the leading
    ``n_layers`` blocks (default a quarter of the stack, at least one),
    packed under ``policy`` (default ``QuantPolicy.binary()``, the paper's
    w1a1 xnor tier).  The draft keeps the target's embedding, final norm
    and head, so it is the target's early exit through the packed GEMMs.
    Greedy speculative output equals the target's whatever the draft; the
    draft only sets the acceptance rate.  ``cfg`` is any config with an
    ``n_layers`` field.  Returns ``(draft_params, draft_cfg, report)``."""
    policy = QuantPolicy.binary() if policy is None else policy
    total = len(params["layers"])
    n = draft_depth(total, n_layers)
    sliced = {k: v for k, v in params.items() if k != "layers"}
    sliced["layers"] = list(params["layers"][:n])
    draft_params, report = convert(sliced, policy, keep_float=keep_float)
    return draft_params, dataclasses.replace(cfg, n_layers=n), report


def draft_depth(total: int, n_layers: int | None = None) -> int:
    """A draft's layer count: ``n_layers``, by default a quarter of the
    target's ``total`` (at least one); raises outside ``[1, total]``."""
    n = max(1, total // 4) if n_layers is None else n_layers
    if not 1 <= n <= total:
        raise ValueError(f"draft n_layers {n} not in [1, {total}]")
    return n


def model_nbytes(params: Pytree) -> int:
    """Size of a checkpoint in bytes (the paper counts fp32 storage:
    floating leaves at 4 bytes an element, others at their own size)."""
    total = 0
    for leaf in tree_leaves(params):
        if leaf.is_floating_point():
            total += _fp32_bytes(leaf)
        else:
            total += leaf.numel() * leaf.element_size()
    return total
