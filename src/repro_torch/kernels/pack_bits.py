"""The sign-pack activation prologue (paper Fig. 1's "binarize input"):
(M, K) float32 -> (M, Kw) int32 words, ``x >= 0`` -> bit 1, LSB first.

PyTorch port of ``repro.kernels.pack_bits.pack_sign_pallas``.  On a CUDA
tensor :func:`pack_sign` launches the hand-written Hopper kernel
(``csrc/pack_sign.cu``: one warp ballot per word, ragged K masked in the
kernel); on a CPU tensor it runs :func:`pack_sign_plain`.  The k-bit
plane-pack prologue waits for slice 2.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _cuda

# The plain version is the bitpack reference itself: the kernel's ballot
# word is exactly ``pack_bits(x >= 0)`` with 0 tail bits.
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
