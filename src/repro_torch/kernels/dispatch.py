"""Quantized-GEMM dispatch — the single execution path for every binary GEMM
(PyTorch port of ``repro.kernels.dispatch``, single-device 1-bit part).

It owns the four concerns of the JAX module, for 1-bit layers:

1. the **activation prologue** (:class:`PrologueSpec`, kind ``pack_sign``):
   float activations -> packed sign words through the sign-pack kernel
   (``kernels/pack_bits.py``), or the plain ``bitpack`` reference when
   ``fused_prologue`` is off;
2. **backend selection** via a registry (``vpu``, ``mxu``);
3. **pad-correction arithmetic**: ``k_true - 2·mismatch`` for ``vpu`` and
   ``padded_dot - mxu_pad_inflation(Kw, k_true)`` for ``mxu``, where Kw is
   the word count the kernel actually contracted (the CUDA kernels take the
   operands unpadded, so it is the operands' own Kw);
4. the **fused epilogue** (:class:`EpilogueSpec`: alpha scale, Eq. 2 range
   map, bias, output dtype — in that order), shared with the fake-quant
   path, which is what keeps packed serving exact (§2.2.2).

Not carried over: the TPU tile table, ``select_tiles`` and its autotune
cache (each CUDA kernel picks its own tiles); the k-bit plane backends and
grouped/MoE entry points (slices 2 and 4); the ``shard-*`` family
(slice 6); the ``xla`` dequant backend (queued in ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import bitpack, quant
from repro_torch.core.policy import QuantSpec
from repro_torch.kernels.pack_bits import pack_sign
from repro_torch.kernels.xnor_gemm import (mxu_pad_inflation, xnor_dot_mxu,
                                           xnor_mismatch)


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    """How a quantized GEMM executes.

    ``backend``: a registry name (``"vpu"`` | ``"mxu"``).
    ``fused_prologue``: pack activations with the sign-pack kernel; False
    runs the plain ``bitpack.pack_sign`` reference instead (bit-identical,
    kept as the equivalence oracle)."""

    backend: str = "vpu"
    fused_prologue: bool = True


DEFAULT_GEMM_CONFIG = GemmConfig()


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """What is fused after the ±1 dot: XNOR-Net per-channel alpha, the
    paper's Eq. 2 range map, bias add, and the output cast — in that
    order."""

    scale: bool = False
    xnor_range: bool = False
    bias: bool = False
    out_dtype: torch.dtype = torch.float32


def epilogue_from_spec(qspec: QuantSpec, *, bias: bool,
                       out_dtype) -> EpilogueSpec:
    """Map a layer's :class:`QuantSpec` to the fused epilogue it implies.
    The Eq. 2 range map only applies to true 1-bit GEMMs, and the alpha
    scale never applies to full-precision layers."""
    return EpilogueSpec(
        scale=qspec.scale and not qspec.is_fp,
        xnor_range=qspec.xnor_range and qspec.is_binary and qspec.a_bits == 1,
        bias=bias,
        out_dtype=out_dtype,
    )


def apply_epilogue(y: torch.Tensor, *, k_true: int, epilogue: EpilogueSpec,
                   scale: torch.Tensor | None = None,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """THE epilogue: ``((y * scale) |> Eq.2(k_true)) + bias -> out_dtype``.
    Both execution paths (fake-quant and packed) call this."""
    if epilogue.scale:
        if scale is None:
            raise ValueError("epilogue.scale set but no scale operand")
        y = y * scale
    if epilogue.xnor_range:
        y = quant.xnor_range_map(y, k_true)
    if epilogue.bias:
        if bias is None:
            raise ValueError("epilogue.bias set but no bias operand")
        y = y + bias
    return y.to(epilogue.out_dtype)


@dataclasses.dataclass(frozen=True)
class PrologueSpec:
    """What happens to float activations before the packed kernel runs
    (paper Fig. 1's "binarize input").  ``kind`` is the executing backend's
    declared operand preparation; this slice has ``"pack_sign"`` only.
    ``fused=False`` routes through the plain ``bitpack`` reference."""

    kind: str = "pack_sign"
    a_bits: int = 1
    fused: bool = True


@dataclasses.dataclass(frozen=True)
class Backend:
    """One way to execute the packed 1-bit GEMM.

    ``gemm(a_packed, b_packed, k_true) -> (M, N) int32`` returns the EXACT
    ±1 dot (pad correction included); ``prologue`` declares how float
    operands are prepared (a :class:`PrologueSpec` kind)."""

    name: str
    gemm: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
    prologue: str = "pack_sign"


def _vpu_gemm(ap, bp, k_true):
    # Eq. 2 inverse on the raw mismatch count (pad bits are 0 in both
    # operands -> 0 mismatches, so no per-call term exists)
    return k_true - 2 * xnor_mismatch(ap, bp)


def _mxu_gemm(ap, bp, k_true):
    # the kernel contracts exactly the operands' Kw words
    return xnor_dot_mxu(ap, bp) - mxu_pad_inflation(ap.shape[1], k_true)


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend) -> None:
    _REGISTRY[backend.name] = backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown gemm backend {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None


register_backend(Backend("vpu", _vpu_gemm))
register_backend(Backend("mxu", _mxu_gemm))


def resolve_backend(name: str, w_bits: int) -> str:
    """The registry entry that executes a ``w_bits`` layer under base name
    ``name``.  This slice serves 1-bit layers only."""
    if w_bits > 1:
        raise NotImplementedError(
            f"{w_bits}-bit packed GEMMs (the vpu-k*/mxu-k* plane backends) "
            "come with slice 2 of the port")
    return get_backend(name).name


def resolve_prologue(name: str, w_bits: int, a_bits: int,
                     config: GemmConfig | None = None) -> PrologueSpec:
    """The prologue the (backend, bit widths, config) combination implies,
    resolved against the registry entry that will execute the GEMM."""
    config = config if config is not None else DEFAULT_GEMM_CONFIG
    be = get_backend(resolve_backend(name, w_bits))
    return PrologueSpec(kind=be.prologue, a_bits=a_bits,
                        fused=config.fused_prologue)


def prologue_from_spec(qspec: QuantSpec, *,
                       config: GemmConfig | None = None) -> PrologueSpec:
    """Map a layer's :class:`QuantSpec` + :class:`GemmConfig` to the
    activation prologue the packed path runs."""
    config = config if config is not None else DEFAULT_GEMM_CONFIG
    wb = 1 if qspec.is_fp else qspec.w_bits
    ab = 1 if qspec.is_fp else qspec.a_bits
    return resolve_prologue(config.backend, wb, ab, config)


def pack_activations(x: torch.Tensor, *, fused: bool = True) -> torch.Tensor:
    """Binarize+pack (M, K) float32 -> (M, ceil(K/32)) int32 words; K tail
    bits are 0.  ``fused=False`` is the plain ``bitpack.pack_sign``
    reference (bit-identical)."""
    if not fused:
        return bitpack.pack_sign(x)
    return pack_sign(x)


def packed_gemm(a_packed: torch.Tensor, b_packed: torch.Tensor, *,
                k_true: int,
                config: GemmConfig = DEFAULT_GEMM_CONFIG) -> torch.Tensor:
    """Exact ±1 dot product (M, N) int32 from packed operands."""
    be = get_backend(resolve_backend(config.backend, 1))
    return be.gemm(a_packed, b_packed, k_true)


def quant_gemm(
    x: torch.Tensor,  # (..., K) float activations
    w_packed: torch.Tensor,  # (N, Kw) int32 1-bit words
    *,
    k_true: int,
    config: GemmConfig = DEFAULT_GEMM_CONFIG,
    epilogue: EpilogueSpec = EpilogueSpec(),
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    w_bits: int = 1,
    a_bits: int = 1,
    prologue: PrologueSpec | None = None,
) -> torch.Tensor:
    """The quantized GEMM: activation prologue (sign+pack x), packed GEMM
    against packed w, fused epilogue.  Returns (..., N) in
    ``epilogue.out_dtype`` — numerically identical to the fake-quant path
    plus the same epilogue (``sign(x) @ sign(W)``, paper §2.2.2)."""
    if x.shape[-1] != k_true:
        raise ValueError(f"x has K={x.shape[-1]}, expected k_true={k_true}")
    if w_bits != 1 or a_bits != 1:
        resolve_backend(config.backend, max(w_bits, a_bits))  # raises
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_true).to(torch.float32).contiguous()
    fused = prologue.fused if prologue is not None else config.fused_prologue
    be = get_backend(resolve_backend(config.backend, 1))
    xp = pack_activations(x2, fused=fused)
    dot = be.gemm(xp, w_packed, k_true)
    y = apply_epilogue(dot.to(torch.float32), k_true=k_true,
                       epilogue=epilogue, scale=scale, bias=bias)
    return y.reshape(*lead, w_packed.shape[0])


@dataclasses.dataclass(frozen=True)
class QuantGemmCall:
    """A fully-specified quantized GEMM: shape contract + bit widths +
    backend config + prologue + epilogue.  Layers build one of these and
    apply it; packing, backend resolution, pad correction and epilogue
    order are owned here."""

    k_true: int
    config: GemmConfig = DEFAULT_GEMM_CONFIG
    epilogue: EpilogueSpec = EpilogueSpec()
    w_bits: int = 1
    a_bits: int = 1
    prologue: PrologueSpec | None = None

    def __call__(self, x: torch.Tensor, w_packed: torch.Tensor, *,
                 scale: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
        return quant_gemm(
            x, w_packed, k_true=self.k_true, config=self.config,
            epilogue=self.epilogue, scale=scale, bias=bias,
            w_bits=self.w_bits, a_bits=self.a_bits, prologue=self.prologue)
