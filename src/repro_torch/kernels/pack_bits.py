"""The activation prologues (paper Fig. 1's "binarize input"), PyTorch port
of ``repro.kernels.pack_bits``:

``pack_sign`` (1 bit, port of ``pack_sign_pallas``)
    (M, K) float32 -> (M, Kw) int32 words, ``x >= 0`` -> bit 1, LSB first.
    CUDA: ``csrc/pack_sign.cu`` (a warp's 16-byte loads all issued before
    the pack, four ballots per 128 floats interleaved into their four words,
    one coalesced store; the plan from M and Kw).

``quant_pack_planes`` (k bits, port of ``quant_pack_planes_pallas``)
    (M, K) float32 -> DoReFa codes ``round(clip(x, 0, 1) * (2^a_bits - 1))``
    packed as an (a_bits, M, Kw) int32 plane stack, plus the (M, 1) int32
    code row-sums T, in one pass.  CUDA: ``csrc/quant_pack_planes.cu`` (a
    bit transpose across each warp, integer row-sum in the same block).

On a CUDA tensor each wrapper launches its hand-written Hopper kernel (or
raises), and the kernel masks the ragged K edge itself; on a CPU tensor it
runs its ``*_plain`` version.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack, quant
from repro_torch.kernels import _cuda

# The plain version is the bitpack reference itself: the kernel's words are
# exactly ``pack_bits(x >= 0)`` with 0 tail bits.
pack_sign_plain = bitpack.pack_sign


def pack_sign(x: torch.Tensor) -> torch.Tensor:
    """(M, K) float32 -> (M, ceil(K/32)) int32 sign words (tail bits 0)."""
    _cuda.require(x, "x", torch.float32, 2)
    if _cuda.on_cpu(x):
        return pack_sign_plain(x)
    m, k = x.shape
    kw = bitpack.packed_width(k)
    out = torch.empty((m, kw), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _cuda.lib().repro_pack_sign(
            x.data_ptr(), out.data_ptr(), m, k, kw,
            _cuda.stream_handle(x.device))
    _cuda.check(rc, "pack_sign")
    _cuda.LAUNCHES["pack_sign"] += 1
    return out


def quant_pack_planes_plain(x: torch.Tensor,
                            a_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the k-bit prologue: the JAX package's unfused route
    (``quant.act_codes`` -> ``bitpack.pack_planes``, plus the code
    row-sums)."""
    codes = quant.act_codes(x, a_bits)
    return (bitpack.pack_planes(codes, a_bits),
            codes.sum(dim=-1, keepdim=True).to(torch.int32))


def quant_pack_planes(x: torch.Tensor,
                      a_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float32 -> ((a_bits, M, ceil(K/32)) int32 plane words with 0
    tail bits, (M, 1) int32 code row-sums), 2 <= a_bits <= 8."""
    _cuda.require(x, "x", torch.float32, 2)
    if not 2 <= a_bits <= 8:
        raise ValueError(f"a_bits must be in 2..8, got {a_bits}")
    if _cuda.on_cpu(x):
        return quant_pack_planes_plain(x, a_bits)
    m, k = x.shape
    kw = bitpack.packed_width(k)
    planes = torch.empty((a_bits, m, kw), dtype=torch.int32, device=x.device)
    t_sum = torch.empty((m, 1), dtype=torch.int32, device=x.device)
    if planes.numel() == 0:  # no rows, or K = 0 (every row sums to 0)
        return planes, t_sum.zero_()
    with torch.cuda.device(x.device):
        rc = _cuda.lib().repro_quant_pack_planes(
            x.data_ptr(), planes.data_ptr(), t_sum.data_ptr(), m, k, kw,
            a_bits, _cuda.stream_handle(x.device))
    _cuda.check(rc, "quant_pack_planes")
    _cuda.LAUNCHES["quant_pack_planes"] += 1
    return planes, t_sum
