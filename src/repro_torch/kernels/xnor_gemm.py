"""Packed binary GEMM kernels — the PyTorch port of
``repro.kernels.xnor_gemm`` (BMXNet §2.2.1, Listing 3).

Both consume packed operands ((M, Kw) activations, (N, Kw) weights, int32
words packed along K — core/bitpack.py) and return raw int32 outputs that
:mod:`repro_torch.kernels.dispatch` turns into the exact ±1 dot:

``xnor_mismatch`` (backend ``vpu``)
    ``sum_w popcount(a ^ b)``; ``dot = k_true - 2 * mismatches``.
    CUDA: ``csrc/xnor_mismatch.cu`` (shared-memory word tiles + ``__popc``).

``xnor_dot_mxu`` (backend ``mxu``)
    unpack every word to ±1 int8 and contract: the *padded* dot, inflated
    by ``mxu_pad_inflation(Kw, k_true)`` because zero pad bits unpack to
    (-1)·(-1).  CUDA: ``csrc/xnor_dot_mxu.cu`` (±1 int8 tiles in shared
    memory, ``mma.sync`` m16n8k32 s8 on the tensor cores); it contracts
    exactly the Kw words it is given.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs its ``*_plain`` version, which repeats the kernel's integer
algorithm in PyTorch ops (int64 SWAR popcount / ±1 unpack).  Both raw
outputs are K-partial-safe: integer partials over disjoint Kw slices sum
exactly.  The expert-batched variants wait for slice 4.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _cuda

WORD_BITS = bitpack.WORD_BITS
_PLAIN_CHUNK_WORDS = 8  # bounds the (M, N, chunk) int64 temporaries


def mxu_pad_inflation(total_words: int, k_true: int) -> int:
    """Pad-bit inflation of the raw MXU dot: every zero pad bit unpacks to
    ``(-1)·(-1) = +1``, so a contraction over ``total_words`` packed words
    of a ``k_true``-bit operand overshoots the true ±1 dot by this many."""
    return total_words * WORD_BITS - k_true


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of the low 32 bits of an int64 tensor (SWAR)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def xnor_mismatch_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the vpu kernel: (M, Kw) x (N, Kw) int32 words ->
    (M, N) int32 ``sum_w popcount(a ^ b)``."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64,
                      device=a.device)
    for w0 in range(0, a.shape[1], _PLAIN_CHUNK_WORDS):
        sl = slice(w0, w0 + _PLAIN_CHUNK_WORDS)
        x = a64[:, None, sl] ^ b64[None, :, sl]
        acc += _popcount32(x).sum(dim=-1)
    return acc.to(torch.int32)


def xnor_dot_mxu_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the mxu kernel: unpack all Kw words of both operands
    to ±1 (pad bits included) and contract -> (M, N) int32 padded dot.  The
    contraction runs in float64, where every partial sum (|s| <= Kw*32) is
    an exact integer, so the result equals the int8 x int8 -> int32 dot."""
    k_all = a.shape[1] * WORD_BITS
    ua = bitpack.unpack_sign(a, k_all, torch.float64)
    ub = bitpack.unpack_sign(b, k_all, torch.float64)
    return (ua @ ub.T).to(torch.int32)


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    _cuda.require(a, "a_packed", torch.int32, 2)
    _cuda.require(b, "b_packed", torch.int32, 2)
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"Kw mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")


def _launch(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m, kw = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        rc = getattr(_cuda.lib(), f"repro_{name}")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, kw,
            _cuda.stream_handle(a.device))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


def xnor_mismatch(a_packed: torch.Tensor,
                  b_packed: torch.Tensor) -> torch.Tensor:
    """VPU popcount path: raw xor-mismatch counts (M, N) int32.
    ``dot = k_true - 2 * mismatches`` (pad bits match, contributing 0)."""
    _check_operands(a_packed, b_packed)
    if _cuda.on_cpu(a_packed, b_packed):
        return xnor_mismatch_plain(a_packed, b_packed)
    return _launch("xnor_mismatch", a_packed, b_packed)


def xnor_dot_mxu(a_packed: torch.Tensor,
                 b_packed: torch.Tensor) -> torch.Tensor:
    """MXU path: the *padded* ±1 dot (M, N) int32 over exactly Kw words.
    True dot = result - mxu_pad_inflation(Kw, k_true)."""
    _check_operands(a_packed, b_packed)
    if _cuda.on_cpu(a_packed, b_packed):
        return xnor_dot_mxu_plain(a_packed, b_packed)
    return _launch("xnor_dot_mxu", a_packed, b_packed)
