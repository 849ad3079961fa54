"""Bit-packing utilities — BMXNet §2.2 / §2.2.3, PyTorch port.

Conventions (shared with the JAX package's ``repro.core.bitpack``, the CUDA
kernels and the model converter — tests enforce them):

* a binary value is ``+1`` iff the stored bit is ``1``; ``-1`` iff ``0``.
* ``sign(0) == +1`` (the bit for ``x >= 0`` is 1; ``-0.0`` gives 1, NaN 0).
* packing is always along the **last** axis, LSB first; for a GEMM
  ``A(M,K) @ B(K,N)`` both operands are packed along K, with B stored
  transposed as ``(N, Kw)``.
* when K is not a multiple of 32 the tail bits are **0 in both operands**, so
  they contribute 0 to the xor-mismatch count and ``dot = K_true - 2 *
  mismatches`` stays exact.  ``K_true`` travels with packed tensors.

Words are ``int32`` tensors holding the same 32 bits as the JAX package's
``uint32`` words (bit 31 is the int32 sign bit): PyTorch on the CPU has no
``uint32`` shifts.  The arithmetic here runs in ``int64`` and wraps to
``int32`` explicitly.
"""

from __future__ import annotations

import torch

WORD_BITS = 32
WORD_DTYPE = torch.int32


def packed_width(k: int) -> int:
    """Number of 32-bit words needed to store ``k`` bits."""
    return (k + WORD_BITS - 1) // WORD_BITS


def to_int32_words(words64: torch.Tensor) -> torch.Tensor:
    """Wrap unsigned 32-bit values held in int64 onto int32 (same bits)."""
    return torch.where(words64 >= 2**31, words64 - 2**32, words64).to(WORD_DTYPE)


def to_uint_words(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 values in [0, 2^32) (same bits)."""
    return words.to(torch.int64) & 0xFFFFFFFF


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a boolean tensor along its last axis into int32 words.

    ``bits[..., k]`` becomes bit ``k % 32`` of word ``k // 32``.  The tail of
    the final word is zero-padded.
    """
    *lead, k = bits.shape
    kw = packed_width(k)
    pad = kw * WORD_BITS - k
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(*lead, kw, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    return to_int32_words((b << shifts).sum(dim=-1))


def unpack_bits(words: torch.Tensor, k_true: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns bool ``(..., k_true)``.  The
    words' bytes, least significant first (the little-endian layout of
    every CPU and GPU PyTorch runs on), index a 256-entry table of their 8
    bits: one pass and no int64 bit tensor, which the plain versions of
    the expert-batched kernels need at 64 experts' planes per call."""
    dev = words.device
    table = ((torch.arange(256, device=dev)[:, None]
              >> torch.arange(8, device=dev)) & 1).to(torch.bool)
    bits = table[words.contiguous().view(torch.uint8).to(torch.int64)]
    *lead, kw = words.shape
    return bits.reshape(*lead, kw * WORD_BITS)[..., :k_true]


def pack_sign(x: torch.Tensor) -> torch.Tensor:
    """Binarize ``x`` with sign (>= 0 -> +1) and pack along the last axis."""
    return pack_bits(x >= 0)


def unpack_sign(words: torch.Tensor, k_true: int,
                dtype=torch.float32) -> torch.Tensor:
    """Unpack to ±1 values of ``dtype``."""
    bits = unpack_bits(words, k_true)
    one = torch.ones((), dtype=dtype, device=words.device)
    return torch.where(bits, one, -one)


def pack_planes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Split k-bit unsigned ``codes`` (..., K) into ``bits`` bit planes and
    pack each along the last axis: returns (bits, ..., Kw) int32 words.
    Plane ``i`` holds bit ``i`` of every code (LSB first), packed exactly
    like the 1-bit operands."""
    codes = codes.to(torch.int64)
    return torch.stack([pack_bits(((codes >> i) & 1).to(torch.bool))
                        for i in range(bits)], dim=0)


def unpack_planes(planes: torch.Tensor, k_true: int) -> torch.Tensor:
    """Inverse of :func:`pack_planes`: (bits, ..., Kw) -> (..., k_true)
    int64 codes."""
    codes = None
    for i in range(planes.shape[0]):
        b = unpack_bits(planes[i], k_true).to(torch.int64) << i
        codes = b if codes is None else codes + b
    return codes


def packed_nbytes(shape: tuple[int, ...]) -> int:
    """Bytes used by a packed tensor whose *unpacked* shape is ``shape``."""
    *lead, k = shape
    n = 1
    for d in lead:
        n *= d
    return n * packed_width(k) * 4
