"""Quantized-GEMM dispatch — the single execution path for every packed GEMM
(PyTorch port of ``repro.kernels.dispatch``, single-device dense part).

It owns the four concerns of the JAX module:

1. the **activation prologue** (:class:`PrologueSpec`): float activations
   -> packed sign words (kind ``pack_sign``, ``kernels/pack_bits.pack_sign``)
   at 1 bit, or DoReFa codes -> an (a_bits, M, Kw) plane stack plus the
   code row-sums T (kind ``pack_planes``,
   ``kernels/pack_bits.quant_pack_planes``) at k bits; ``fused_prologue``
   off runs the plain ``bitpack`` / ``quant`` reference instead;
2. **backend selection** via a registry and :func:`resolve_backend`:

   ===========  ==================  ==============================  =========
   backend      operands            kernel                          prologue
   ===========  ==================  ==============================  =========
   ``vpu``      1-bit words         xnor+popcount (K2; K7 for the   pack_sign
                                    expert-batched buckets)
   ``mxu``      1-bit words         ±1 int8 ``mma`` (K3; K8         pack_sign
                                    batched)
   ``xla``      float acts, any     unpack / dequant the weights,   float
                packed weights      ``torch.matmul`` (no kernel;
                                    :func:`ragged_dot` grouped)
   ``vpu-kN``   N-bit plane stacks  AND+popcount per plane pair     pack_planes
                (N = 2, 4, 8)       (K5; K9 batched)
   ``mxu-kN``   N-bit plane stacks  u8 code lanes, one ``mma``      pack_planes
                                    (K6; K10 batched)
   ===========  ==================  ==============================  =========

   Base names resolve per layer by weight width: ``vpu`` at 4 bits runs
   ``vpu-k4``; widths without a plane entry (3, 5, 6, 7) fall back to
   ``xla``;
3. **pad-correction arithmetic**: ``k_true - 2·mismatch`` for ``vpu`` and
   ``padded_dot - mxu_pad_inflation(Kw, k_true)`` for ``mxu``, where Kw is
   the word count the kernel actually contracted (the CUDA kernels take the
   operands unpadded, so it is the operands' own Kw); the k-bit kernels
   need none (zero tail bits AND to 0, and absent lanes are code 0);
4. the **fused epilogue** (:class:`EpilogueSpec`: alpha scale, Eq. 2 range
   map, bias, output dtype — in that order), shared with the fake-quant
   path, which is what keeps packed serving exact (§2.2.2).

The k-bit dot is recovered from the integer GEMM S and the row-sums T as
``(2*S - Nw*T) / (Na*Nw)``: the numerator stays int32 and is scaled once in
fp32, by the fp32 reciprocal of Na*Nw as XLA compiles the JAX package's
divide, so the two packages give the same bits.

The grouped (MoE) entry point :func:`quant_gemm_grouped` runs the same
prologue once over the expert-sorted rows, scatters the packed words into
dense per-expert buckets on the device (no host sync), and contracts them
on the expert-batched kernels: at 1 bit ``(E, capacity, Kw)`` sign words
against ``(E, N, Kw)`` stacks (``vpu`` K7, ``mxu`` K8); at k bits ``(E,
a_bits, capacity, Kw)`` plane buckets against ``(E, w_bits, N, Kw)`` plane
stacks (``vpu-kN`` K9, ``mxu-kN`` K10), dequantized with the per-row code
sums as in the dense path.  ``xla`` takes the float rows to
:func:`ragged_dot` over the unpacked (1 bit) or dequantized (k bits)
stacks.

Not carried over: the TPU tile table, ``select_tiles`` and its autotune
cache (each CUDA kernel picks its own tiles); the ``shard-*`` family and
the expert-parallel grouped layout (slice 6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import bitpack, quant
from repro_torch.core.policy import QuantSpec
from repro_torch.kernels.kbit_gemm import (kbit_plane_gemm,
                                           kbit_plane_gemm_batched)
from repro_torch.kernels.kbit_mxu import (kbit_mxu_gemm, kbit_mxu_gemm_batched,
                                          kbit_mxu_gemm_plain)
from repro_torch.kernels.pack_bits import (pack_sign, quant_pack_planes,
                                           quant_pack_planes_plain)
from repro_torch.kernels.xnor_gemm import (mxu_pad_inflation, xnor_dot_mxu,
                                           xnor_dot_mxu_batched, xnor_mismatch,
                                           xnor_mismatch_batched)

WORD_BITS = bitpack.WORD_BITS


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    """How a quantized GEMM executes.

    ``backend``: a BASE registry name (``"vpu"`` | ``"mxu"`` | ``"xla"``, or
    a plane entry such as ``"vpu-k4"``); layer calls carry their bit widths
    and :func:`resolve_backend` maps e.g. ``("vpu", w_bits=4)`` onto
    ``"vpu-k4"``.  ``fused_prologue``: quantize+pack activations with the
    prologue kernels; False runs the plain ``bitpack`` / ``quant``
    reference instead (bit-identical, kept as the equivalence oracle)."""

    backend: str = "vpu"
    fused_prologue: bool = True


DEFAULT_GEMM_CONFIG = GemmConfig()


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """What is fused after the dot: XNOR-Net per-channel alpha, the
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
    declared operand preparation:

    * ``"pack_sign"``   — 1-bit: sign -> packed words (``pack_sign``);
    * ``"pack_planes"`` — k-bit DoReFa: clip -> Eq. 1 codes ->
      (a_bits, M, Kw) plane stack plus the code row-sums T, one pass
      (``quant_pack_planes``);
    * ``"float"``       — operands stay float; the ``xla`` backend
      quantizes them itself.

    ``fused=False`` routes through the plain ``bitpack`` / ``quant``
    reference."""

    kind: str = "pack_sign"
    a_bits: int = 1
    fused: bool = True


@dataclasses.dataclass(frozen=True)
class Backend:
    """One way to execute the packed quantized GEMM.

    1-bit surface: ``gemm(a_packed, b_packed, k_true) -> (M, N) int32``
    returns the EXACT ±1 dot (pad correction included); ``from_float(x2,
    w_packed, k_true)`` is the shortcut of backends that take float
    activations (``xla``).

    k-bit surface (``bits > 1`` plane entries, or ``xla``'s fallbacks):
    ``gemm_kbit(a_planes, b_planes) -> (M, N) int32`` returns the raw
    weighted-plane S (plane counts read off the stacks' leading dims);
    ``from_float_kbit(x2, w_planes, a_bits, w_bits, k_true)`` returns the
    fake-quant DoReFa dot straight from float activations.

    Grouped (MoE) surface: ``gemm_grouped(buckets, w_stack, k_true) ->
    (E, capacity, N) int32`` returns the exact ±1 dots of packed
    ``(E, capacity, Kw)`` buckets against ``(E, N, Kw)`` packed stacks;
    ``from_float_grouped(x_sorted, w_stack, group_sizes, k_true)`` is the
    float-activation shortcut (``xla``).  At k bits
    ``gemm_kbit_grouped(buckets, w_stack) -> (E, capacity, N) int32`` is
    the raw S of ``(E, a_bits, capacity, Kw)`` plane buckets against
    ``(E, w_bits, N, Kw)`` plane stacks, and ``from_float_kbit_grouped(
    x_sorted, w_stack, group_sizes, a_bits, w_bits, k_true)`` the
    fake-quant DoReFa dots straight from float rows (``xla``).

    ``prologue`` declares how float operands are prepared (a
    :class:`PrologueSpec` kind)."""

    name: str
    gemm: Callable
    from_float: Callable | None = None
    bits: int = 1
    gemm_kbit: Callable | None = None
    from_float_kbit: Callable | None = None
    prologue: str = "pack_sign"
    gemm_grouped: Callable | None = None
    from_float_grouped: Callable | None = None
    gemm_kbit_grouped: Callable | None = None
    from_float_kbit_grouped: Callable | None = None


def _vpu_gemm(ap, bp, k_true):
    # Eq. 2 inverse on the raw mismatch count (pad bits are 0 in both
    # operands -> 0 mismatches, so no per-call term exists)
    return k_true - 2 * xnor_mismatch(ap, bp)


def _mxu_gemm(ap, bp, k_true):
    # the kernel contracts exactly the operands' Kw words
    return xnor_dot_mxu(ap, bp) - mxu_pad_inflation(ap.shape[1], k_true)


def _vpu_gemm_grouped(buckets, w_stack, k_true):
    return k_true - 2 * xnor_mismatch_batched(buckets, w_stack)


def _mxu_gemm_grouped(buckets, w_stack, k_true):
    # corrected by the operands' own Kw, the words the kernel contracted
    return (xnor_dot_mxu_batched(buckets, w_stack)
            - mxu_pad_inflation(buckets.shape[-1], k_true))


# --- xla: plain ops, no kernel (the JAX package leaves these to XLA) -------


def _xla_gemm(ap, bp, k_true):
    """±1 dot from packed operands: unpack both and contract in float32,
    exact for ±1 sums below 2^24."""
    ua = bitpack.unpack_sign(ap, k_true)
    ub = bitpack.unpack_sign(bp, k_true)
    return (ua @ ub.T).to(torch.int32)


def _xla_from_float(x2, w_packed, k_true):
    """Weights stay bit-packed, unpack to ±1 in the graph and contract in
    float32 (exact for ±1 up to 2^24 terms)."""
    w_pm1 = bitpack.unpack_sign(w_packed, k_true)  # (N, K)
    one = torch.ones((), dtype=torch.float32, device=x2.device)
    return torch.where(x2 >= 0, one, -one) @ w_pm1.T


def ragged_dot(x: torch.Tensor, w: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """``lax.ragged_dot``: rows ``[start_i, start_i + group_sizes[i])`` of
    ``x`` (T, K) times ``w[i]`` (K, N); rows past ``sum(group_sizes)`` are
    zeros.  Plain ``torch.matmul`` per group, with the group sizes read on
    the host — the fake-quant oracle's contraction and the ``xla``
    backend's, never a packed kernel path."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.result_type(x, w),
                      device=x.device)
    start = 0
    for i, size in enumerate(group_sizes.tolist()):
        if size:
            out[start:start + size] = x[start:start + size] @ w[i]
        start += size
    return out


def _xla_from_float_grouped(x_sorted, w_stack, group_sizes, k_true):
    """Grouped ``xla``: the packed stacks unpack to ±1 (E, K, N) and
    :func:`ragged_dot` contracts the signs of the rows in float32 (exact
    for ±1 sums below 2^24)."""
    w_ekn = bitpack.unpack_sign(w_stack, k_true).transpose(1, 2)
    one = torch.ones((), dtype=torch.float32, device=x_sorted.device)
    return ragged_dot(torch.where(x_sorted >= 0, one, -one), w_ekn,
                      group_sizes)


def _dequant_weight_planes(w_planes, k_true, w_bits):
    """(…, kb, N, Kw) plane stack -> (…, N, K) float32 DoReFa weight
    values."""
    codes = bitpack.unpack_planes(torch.movedim(w_planes, -3, 0),
                                  k_true).to(torch.float32)
    nw = float((1 << w_bits) - 1)
    return (2.0 * codes - nw) / nw


def _xla_kbit_from_float(x2, w_planes, a_bits, w_bits, k_true):
    """Weights stay plane-packed (k/32 of the fp32 bytes), dequantized to
    float32 and contracted with ``torch.matmul`` — the k-bit analogue of
    ``_xla_from_float``, and the fallback for widths with no plane entry."""
    wq = _dequant_weight_planes(w_planes, k_true, w_bits)  # (N, K)
    xq = quant.quantize_act(x2.to(torch.float32), a_bits)
    return xq @ wq.T


def _xla_kbit_from_float_grouped(x_sorted, w_stack, group_sizes, a_bits,
                                 w_bits, k_true):
    """Grouped ``xla`` at k bits: the (E, w_bits, N, Kw) plane stack
    dequantized to (E, K, N) float32 and :func:`ragged_dot` over the
    quantized rows (the k-bit analogue of ``_xla_from_float_grouped``)."""
    wq = _dequant_weight_planes(w_stack, k_true, w_bits)  # (E, N, K)
    xq = quant.quantize_act(x_sorted.to(torch.float32), a_bits)
    return ragged_dot(xq, wq.transpose(1, 2), group_sizes)


def _kbit_only(*_args, **_kw):
    raise ValueError(
        "k-bit plane backends execute k-bit GEMMs only; call the entry "
        "points with w_bits/a_bits (or use a 1-bit backend)")


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend) -> None:
    _REGISTRY[backend.name] = backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown gemm backend {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None


def backend_names() -> list[str]:
    """The registered backend names, sorted (the launchers' choices)."""
    return sorted(_REGISTRY)


register_backend(Backend("vpu", _vpu_gemm, gemm_grouped=_vpu_gemm_grouped))
register_backend(Backend("mxu", _mxu_gemm, gemm_grouped=_mxu_gemm_grouped))
register_backend(Backend("xla", _xla_gemm, from_float=_xla_from_float,
                         from_float_grouped=_xla_from_float_grouped,
                         # S from reassembled codes, a float64 matmul:
                         # the code-lane kernel's plain version
                         gemm_kbit=kbit_mxu_gemm_plain,
                         from_float_kbit=_xla_kbit_from_float,
                         from_float_kbit_grouped=_xla_kbit_from_float_grouped,
                         prologue="float"))
for _fam, _kernel, _grouped in (
        ("vpu", kbit_plane_gemm, kbit_plane_gemm_batched),
        ("mxu", kbit_mxu_gemm, kbit_mxu_gemm_batched)):
    for _k in (2, 4, 8):
        register_backend(Backend(f"{_fam}-k{_k}", _kbit_only, bits=_k,
                                 gemm_kbit=_kernel, gemm_kbit_grouped=_grouped,
                                 prologue="pack_planes"))


def _family(base: str) -> str:
    """The kernel family of a backend name: ``"mxu-k4"`` -> ``"mxu"``,
    ``"vpu"`` -> ``"vpu"`` (plane entries are ``family-kN``)."""
    return base.split("-k", 1)[0]


def resolve_backend(name: str, w_bits: int) -> str:
    """Map a base backend name + the layer's weight bit width onto the
    registry entry that executes it.  Resolution is FAMILY-aware: ``"mxu"``
    resolves onto the ``mxu-k*`` code-lane entries and ``"vpu"`` onto the
    plane popcount entries:

    * ``w_bits == 1`` — the name as it is, except that a plane entry
      down-resolves to its family's 1-bit entry (``"mxu-k4"`` -> ``"mxu"``);
    * an entry that already handles ``w_bits`` (a matching ``*-kN``, or
      ``"xla"``) — as it is;
    * otherwise ``{family}-k{w_bits}`` when registered, then
      ``vpu-k{w_bits}``, else the ``"xla"`` dequant fallback (w3/w5/...
      stay correct, just not plane-packed)."""
    fam = _family(name)
    if w_bits <= 1:
        be = _REGISTRY.get(name)
        if be is not None and be.bits > 1:
            return fam if fam in _REGISTRY else "vpu"
        return name
    be = get_backend(name)  # unknown base names raise here, not fall back
    if be.bits == w_bits or be.from_float_kbit is not None:
        return name
    for fallback_fam in (fam, "vpu"):
        kname = f"{fallback_fam}-k{w_bits}"
        if kname in _REGISTRY:
            return kname
    return "xla"


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


# --- k-bit arithmetic and refusals ----------------------------------------


def _kbit_dequant(s, t_sum, a_bits, w_bits):
    """Integer plane GEMM -> fake-quant DoReFa dot (float32):

        a_q = n_a/Na,  w_q = (2*n_w - Nw)/Nw
        =>  dot = (2*S - Nw*T) / (Na*Nw)

    with S the code dot and T the activation code row-sums.  The numerator
    stays int32 (an fp32 cast of S loses bits past 2^24, and the
    subtraction cancels); the one fp32 operation after it is the only
    rounding.  That operation is a multiply by the fp32 reciprocal of
    Na*Nw: XLA rewrites the JAX package's divide by that constant into
    exactly this multiply, so the two packages give the same bits.
    ``_check_kbit_accumulator`` bounds every term below 2^31."""
    na = (1 << a_bits) - 1
    nw = (1 << w_bits) - 1
    num = 2 * s - nw * t_sum
    return num.to(torch.float32) * float(np.float32(1.0 / (na * nw)))


def _check_kbit_widths(w_bits: int, a_bits: int) -> None:
    """Reject width combinations the packed path has no semantics for: 1-bit
    sign values have no unsigned plane form, so mixing a 1-bit side with a
    k-bit side would silently compute the wrong quantizer."""
    if w_bits > 1 and a_bits > 1:
        if not (2 <= w_bits <= 8 and 2 <= a_bits <= 8):
            raise ValueError(
                f"packed k-bit GEMM supports widths 2..8, got "
                f"w{w_bits}a{a_bits}")
    elif w_bits > 1 or a_bits > 1:
        raise ValueError(
            f"mixed 1-bit/k-bit widths unsupported: w{w_bits}a{a_bits} "
            "(use both widths 1, or both in 2..8)")


def _check_kbit_accumulator(k_true: int, a_bits: int, w_bits: int) -> None:
    """The plane kernel accumulates S <= K * Na * Nw in int32 (and the
    dequant numerator 2S - Nw*T has the same bound): an oversized
    contraction fails here instead of silently wrapping (w8a8 caps K at
    ~16k, w4a4 at ~4.7M).  The ``"xla"`` fallback contracts in float and
    needs no check."""
    bound = 2 * k_true * ((1 << a_bits) - 1) * ((1 << w_bits) - 1)
    if bound >= 2**31:
        raise ValueError(
            f"k-bit GEMM overflows its int32 accumulator: K={k_true} at "
            f"w{w_bits}a{a_bits} needs 2*K*Na*Nw = {bound} >= 2^31; split "
            "the contraction or reduce the bit width")


def _check_kbit_accumulator_mxu(k_true: int, a_bits: int,
                                w_bits: int) -> None:
    """The same ceiling for the code-lane tensor-core path, which sums the
    FULL code dot ``S <= K * Na * Nw`` in ONE int32 partial per output
    element (not the popcount path's per-pass counts); checked separately
    so the failure names the single-partial accumulation."""
    bound = 2 * k_true * ((1 << a_bits) - 1) * ((1 << w_bits) - 1)
    if bound >= 2**31:
        raise ValueError(
            f"k-bit MXU GEMM overflows its int32 accumulator: the int8 "
            f"code-lane path sums the full code dot in ONE int32 partial "
            f"per element, and K={k_true} at w{w_bits}a{a_bits} needs "
            f"2*K*Na*Nw = {bound} >= 2^31; split the contraction, reduce "
            "the bit width, or use the plane popcount backend with a "
            "sharded K split")


def _accum_check_for(name: str):
    """The int32 bound check matching a RESOLVED backend name: the
    ``mxu-k*`` family accumulates the full code dot per partial and gets
    the re-derived check; everything else keeps the plane-pair one."""
    return (_check_kbit_accumulator_mxu if _family(name) == "mxu"
            else _check_kbit_accumulator)


# --- entry points ---------------------------------------------------------


def pack_activations(x: torch.Tensor, *, fused: bool = True) -> torch.Tensor:
    """Binarize+pack (M, K) float32 -> (M, ceil(K/32)) int32 words; K tail
    bits are 0.  ``fused=False`` is the plain ``bitpack.pack_sign``
    reference (bit-identical)."""
    if not fused:
        return bitpack.pack_sign(x)
    return pack_sign(x)


def pack_act_planes(x: torch.Tensor, a_bits: int, *,
                    fused: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The k-bit activation prologue: (M, K) float32 -> ((a_bits, M,
    ceil(K/32)) int32 planes, (M, 1) int32 code row-sums) in one kernel
    pass.  ``fused=False`` is the plain ``quant.act_codes`` ->
    ``bitpack.pack_planes`` round trip (bit-identical)."""
    if not fused:
        return quant_pack_planes_plain(x, a_bits)
    return quant_pack_planes(x, a_bits)


def packed_gemm(a_packed: torch.Tensor, b_packed: torch.Tensor, *,
                k_true: int,
                config: GemmConfig = DEFAULT_GEMM_CONFIG) -> torch.Tensor:
    """Exact ±1 dot product (M, N) int32 from packed operands."""
    be = get_backend(resolve_backend(config.backend, 1))
    return be.gemm(a_packed, b_packed, k_true)


def packed_kbit_gemm(a_planes: torch.Tensor, b_planes: torch.Tensor, *,
                     config: GemmConfig = DEFAULT_GEMM_CONFIG) -> torch.Tensor:
    """Raw weighted-plane S (M, N) int32 from (ka, M, Kw) x (kb, N, Kw)
    plane stacks (plane counts read off the leading dims)."""
    name = resolve_backend(config.backend, b_planes.shape[0])
    be = get_backend(name)
    if be.gemm_kbit is None:
        raise ValueError(f"backend {name!r} has no k-bit kernel")
    _accum_check_for(name)(a_planes.shape[2] * WORD_BITS,
                           a_planes.shape[0], b_planes.shape[0])
    return be.gemm_kbit(a_planes, b_planes)


def _kbit_dot_from_float(x2, w_planes, *, k_true, config, w_bits, a_bits,
                         fused=True):
    """(M, K) float acts x (w_bits, N, Kw) plane-packed weights -> the
    fake-quant DoReFa dot (M, N) float32, before the epilogue."""
    name = resolve_backend(config.backend, w_bits)
    be = get_backend(name)
    if w_planes.ndim != 3 or w_planes.shape[0] != w_bits:
        raise ValueError(f"k-bit weights must be a ({w_bits}, N, Kw) plane "
                         f"stack, got {tuple(w_planes.shape)}")
    if be.from_float_kbit is not None:
        return be.from_float_kbit(x2, w_planes, a_bits, w_bits, k_true)
    _accum_check_for(name)(k_true, a_bits, w_bits)
    a_planes, t_sum = pack_act_planes(x2, a_bits, fused=fused)
    s = be.gemm_kbit(a_planes, w_planes)
    return _kbit_dequant(s, t_sum, a_bits, w_bits)


def quant_gemm(
    x: torch.Tensor,  # (..., K) float activations
    w_packed: torch.Tensor,  # (N, Kw) 1-bit words or (w_bits, N, Kw) planes
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
    """The quantized GEMM: activation prologue (quantize+pack x), packed GEMM
    against packed w, fused epilogue.  Returns (..., N) in
    ``epilogue.out_dtype`` — the fake-quant path's values plus the same
    epilogue (``sign(x) @ sign(W)`` exactly at 1 bit, paper §2.2.2; the
    DoReFa Eq. 1 dot to fp32 rounding at k bits)."""
    if x.shape[-1] != k_true:
        raise ValueError(f"x has K={x.shape[-1]}, expected k_true={k_true}")
    if w_bits > 1 or a_bits > 1:
        _check_kbit_widths(w_bits, a_bits)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_true).to(torch.float32).contiguous()
    fused = prologue.fused if prologue is not None else config.fused_prologue
    if w_bits > 1:
        dot = _kbit_dot_from_float(x2, w_packed, k_true=k_true, config=config,
                                   w_bits=w_bits, a_bits=a_bits, fused=fused)
        n_out = w_packed.shape[-2]
    else:
        be = get_backend(resolve_backend(config.backend, 1))
        if be.from_float is not None:
            dot = be.from_float(x2, w_packed, k_true)
        else:
            dot = be.gemm(pack_activations(x2, fused=fused), w_packed, k_true)
        n_out = w_packed.shape[0]
    y = apply_epilogue(dot.to(torch.float32), k_true=k_true,
                       epilogue=epilogue, scale=scale, bias=bias)
    return y.reshape(*lead, n_out)


@dataclasses.dataclass(frozen=True)
class QuantGemmCall:
    """A fully-specified quantized GEMM: shape contract + bit widths +
    backend config + prologue + epilogue.  Layers build one of these and
    apply it; packing, backend resolution, pad correction, dequant and
    epilogue order are owned here."""

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


def quant_gemm_grouped(
    x_sorted: torch.Tensor,  # (T, K) float rows, sorted by group
    w_stack,  # (E, N, Kw) words / (E, w_bits, N, Kw) planes, or a tuple
    group_sizes: torch.Tensor,  # (E,) int, sum <= T
    *,
    k_true: int,
    config: GemmConfig = DEFAULT_GEMM_CONFIG,
    expert_capacity: int | None = None,
    out_dtype=torch.float32,
    w_bits: int | None = None,
    a_bits: int | None = None,
):
    """Grouped (MoE expert-stacked) packed GEMM.

    Row ``i`` of ``x_sorted`` is contracted against the packed weights of
    its group (groups are contiguous: the first ``group_sizes[0]`` rows
    belong to expert 0, ...).  Rows beyond ``sum(group_sizes)`` return
    zeros, and rows overflowing a bucket (``expert_capacity``, default T:
    no drops) are dropped (zeros) on every backend.

    ``w_stack`` may be a tuple of same-shape stacks (MoE up + gate): the
    activations are quantized, packed and bucketed once and contracted
    against each stack, returning a tuple.

    ``vpu`` / ``mxu`` scatter the packed words into dense per-expert
    buckets ``(E, capacity, Kw)`` and run the expert-batched kernel (K7 /
    K8), so only packed words reach it; the dense bucket form computes
    every bucket row, E-fold the ragged work at full capacity.  With
    ``w_bits`` > 1 the same happens to DoReFa bit planes (``vpu-kN`` K9,
    ``mxu-kN`` K10; see :func:`_kbit_grouped`).  Group sizes, bucket
    indices and the validity mask stay on the device: the packed path reads
    nothing back to the host.  ``xla`` contracts the float rows with
    :func:`ragged_dot` over the unpacked or dequantized stacks."""
    stacks = w_stack if isinstance(w_stack, tuple) else (w_stack,)
    t, k = x_sorted.shape
    e = stacks[0].shape[0]
    if k != k_true:
        raise ValueError(f"x has K={k}, expected k_true={k_true}")
    wb, ab = w_bits or 1, a_bits or 1
    if wb > 1 or ab > 1:
        _check_kbit_widths(wb, ab)
    ndim, what = (4, f"(E, {wb}, N, Kw)") if wb > 1 else (3, "(E, N, Kw)")
    if any(w.ndim != ndim or w.shape != stacks[0].shape
           or (wb > 1 and w.shape[1] != wb) for w in stacks):
        raise ValueError(f"expert stacks must share one {what} shape: "
                         f"{[tuple(w.shape) for w in stacks]}")

    ec = expert_capacity or t
    group_sizes = group_sizes.to(device=x_sorted.device, dtype=torch.int64)
    dest, cell, valid = _bucket_cells(group_sizes, t, ec)

    x_sorted = x_sorted.to(torch.float32).contiguous()
    if wb > 1:
        outs = _kbit_grouped(x_sorted, stacks, group_sizes, dest, cell, valid,
                             ec=ec, k_true=k_true, config=config,
                             out_dtype=out_dtype, w_bits=wb, a_bits=ab)
        return outs if isinstance(w_stack, tuple) else outs[0]
    be = get_backend(resolve_backend(config.backend, 1))
    if be.from_float_grouped is not None:
        outs = tuple(
            torch.where(valid[:, None],
                        be.from_float_grouped(x_sorted, w, group_sizes,
                                              k_true), 0.0).to(out_dtype)
            for w in stacks)
        return outs if isinstance(w_stack, tuple) else outs[0]
    if be.gemm_grouped is None:
        raise ValueError(f"backend {be.name!r} has no grouped GEMM")

    buckets = _pack_sign_buckets(x_sorted, dest, e, ec, config.fused_prologue)
    outs = []
    for w in stacks:
        dots = be.gemm_grouped(buckets, w, k_true)  # (E, ec, N)
        y = dots.reshape(e * ec, -1)[cell]
        outs.append(torch.where(valid[:, None], y, 0).to(out_dtype))
    return tuple(outs) if isinstance(w_stack, tuple) else outs[0]


def _bucket_cells(group_sizes: torch.Tensor, t: int, ec: int):
    """Where each of the ``t`` expert-sorted rows goes, on the device: row
    ``i`` is position ``pos`` of group ``g`` (the groups are contiguous runs
    of ``group_sizes``), valid when ``g < E`` (not past the sizes' sum) and
    ``pos < ec`` (not dropped by the capacity).  Returns ``(dest, cell,
    valid)``: the flat bucket cell ``g * ec + pos`` a row scatters to (the
    extra cell ``E * ec``, cut off after the scatter, for invalid rows), the
    cell it reads its result back from (clamped into the buckets; the
    validity mask zeroes what invalid rows read) and the mask."""
    e = group_sizes.numel()
    ends = torch.cumsum(group_sizes, 0)
    row = torch.arange(t, device=group_sizes.device)
    g = torch.searchsorted(ends, row, right=True)
    g_safe = g.clamp(max=e - 1)
    pos = row - (ends - group_sizes)[g_safe]
    valid = (g < e) & (pos < ec)
    return (torch.where(valid, g * ec + pos, e * ec),
            g_safe * ec + pos.clamp(max=ec - 1), valid)


def _pack_sign_buckets(x_sorted, dest, e, ec, fused):
    """The grouped 1-bit prologue: route rows into (E, capacity, Kw) packed
    buckets.  When the capacity bound shrinks the bucket total below the
    row count (E * ec < T, a tight ``expert_capacity``), the float rows are
    routed first and only the bucket cells run through the pack kernel:
    rows dropped by the capacity bound are never packed, and empty cells
    hold -1.0 (bit 0).  Otherwise the T rows pack once and the packed words
    scatter into zero buckets.  Invalid rows write to one extra cell that
    is cut off, so the scatter needs no host-side count (``dest``:
    :func:`_bucket_cells`)."""
    t, k = x_sorted.shape
    if e * ec < t:
        xb = torch.full((e * ec + 1, k), -1.0, dtype=x_sorted.dtype,
                        device=x_sorted.device)
        xb[dest] = x_sorted
        return pack_activations(xb[:-1], fused=fused).reshape(e, ec, -1)
    xp = pack_activations(x_sorted, fused=fused)
    buckets = torch.zeros((e * ec + 1, xp.shape[1]), dtype=xp.dtype,
                          device=xp.device)
    buckets[dest] = xp
    return buckets[:-1].reshape(e, ec, -1)


def _pack_plane_buckets(x_sorted, a_bits, dest, cell, e, ec, fused):
    """The grouped k-bit prologue: quantize + plane-pack, bucketed.  Returns
    ((E, a_bits, capacity, Kw) int32 plane buckets, contiguous for the
    kernel, and the (T, 1) int32 code sums of the rows).  The same
    route-first rule as :func:`_pack_sign_buckets`: when E * ec < T the
    float rows are routed first (slack rows are -1.0, code 0) and only the
    bucket cells run through the prologue, and each row reads its cell's
    code sum (dropped rows read a clamped cell; the validity mask zeroes
    them); otherwise the T rows pack once and their planes scatter into
    zero buckets (``dest``, ``cell``: :func:`_bucket_cells`)."""
    t, k = x_sorted.shape
    if e * ec < t:
        xb = torch.full((e * ec + 1, k), -1.0, dtype=x_sorted.dtype,
                        device=x_sorted.device)
        xb[dest] = x_sorted
        planes, ts = pack_act_planes(xb[:-1], a_bits, fused=fused)
        buckets = planes.reshape(a_bits, e, ec, -1).transpose(0, 1)
        return buckets.contiguous(), ts[cell]
    planes, ts = pack_act_planes(x_sorted, a_bits, fused=fused)  # (ka, T, Kw)
    kw = planes.shape[-1]
    buckets = torch.zeros((e * ec + 1, a_bits, kw), dtype=planes.dtype,
                          device=planes.device)
    buckets[dest] = planes.transpose(0, 1)
    return (buckets[:-1].reshape(e, ec, a_bits, kw).transpose(1, 2)
            .contiguous(), ts)


def _kbit_grouped(x_sorted, stacks, group_sizes, dest, cell, valid, *, ec,
                  k_true, config, out_dtype, w_bits, a_bits):
    """k-bit arm of :func:`quant_gemm_grouped`: the quantize -> plane-pack
    prologue runs once (per bucket cell under a tight capacity, see
    :func:`_pack_plane_buckets`), then each (E, w_bits, N, Kw) expert plane
    stack contracts on the expert-batched kernel (K9 / K10) and every row's
    S dequantizes with its code sum as in the dense path; ``xla`` (and
    widths without a plane entry) goes to :func:`ragged_dot` over the
    dequantized stacks.  The capacity / validity contract of the 1-bit arm.
    Returns a tuple, one output per stack."""
    e = stacks[0].shape[0]
    name = resolve_backend(config.backend, w_bits)
    be = get_backend(name)
    if be.from_float_kbit_grouped is not None:
        return tuple(
            torch.where(valid[:, None],
                        be.from_float_kbit_grouped(x_sorted, w, group_sizes,
                                                   a_bits, w_bits, k_true),
                        0.0).to(out_dtype)
            for w in stacks)
    if be.gemm_kbit_grouped is None:
        raise ValueError(f"backend {name!r} has no grouped k-bit GEMM")
    _accum_check_for(name)(k_true, a_bits, w_bits)
    buckets, t_sum = _pack_plane_buckets(x_sorted, a_bits, dest, cell, e, ec,
                                         config.fused_prologue)
    outs = []
    for w in stacks:
        s = be.gemm_kbit_grouped(buckets, w)  # (E, ec, N)
        dot = _kbit_dequant(s.reshape(e * ec, -1)[cell], t_sum, a_bits,
                            w_bits)
        outs.append(torch.where(valid[:, None], dot, 0.0).to(out_dtype))
    return tuple(outs)
