"""k-bit packed GEMM on the tensor cores — the code-lane contraction of the
DoReFa bit planes behind ``mxu-k2/k4/k8``; PyTorch port of
``repro.kernels.kbit_mxu``.

The weighted plane sum of :mod:`repro_torch.kernels.kbit_gemm` is the
integer dot of the reassembled codes ``n = sum_i 2^i * plane_i``:
``S[m, n] = sum_k n_a[m, k] * n_w[n, k]``.  So this kernel streams the same
packed plane words, reassembles one byte-wide code lane per bit position
on chip, and contracts once on the int8 tensor cores instead of ``ka*kb``
popcount passes.

The TPU kernel contracts signed offset codes ``n - 2^(k-1)`` and restores
S with a rank-1 binomial correction (``_offset_rowsum`` / ``_restore_s``)
because the TPU's int8 matrix unit is signed.  Hopper's ``mma`` takes
unsigned 8-bit operands, so the CUDA kernel (``csrc/kbit_mxu_gemm.cu``,
``mma.sync`` m16n8k32 u8 x u8 -> s32) contracts the raw codes and returns S
directly: there is no offset, no restore and no pad term, and absent words
are code 0.  It equals :func:`kbit_gemm.kbit_plane_gemm` bit for bit.

On a CUDA tensor :func:`kbit_mxu_gemm` launches the kernel (or raises); on
a CPU tensor it runs :func:`kbit_mxu_gemm_plain`.  The expert-batched
variant waits for slice 4.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _cuda
from repro_torch.kernels.kbit_gemm import check_planes, launch_planes


def kbit_mxu_gemm_plain(a_planes: torch.Tensor,
                        b_planes: torch.Tensor) -> torch.Tensor:
    """Plain version of the code-lane kernel: reassemble the codes of all
    ``Kw*32`` lanes of both operands and contract in float64, where every
    partial sum (at most K*255*255 < 2^53) is an exact integer, so the
    result equals the u8 x u8 -> int32 dot."""
    k_all = a_planes.shape[2] * bitpack.WORD_BITS
    ua = bitpack.unpack_planes(a_planes, k_all).to(torch.float64)
    ub = bitpack.unpack_planes(b_planes, k_all).to(torch.float64)
    return (ua @ ub.T).to(torch.int32)


def kbit_mxu_gemm(a_planes: torch.Tensor,
                  b_planes: torch.Tensor) -> torch.Tensor:
    """Code-lane tensor-core GEMM: the same S (M, N) int32 as
    ``kbit_plane_gemm`` from (ka, M, Kw) x (kb, N, Kw) plane stacks."""
    check_planes(a_planes, b_planes)
    if _cuda.on_cpu(a_planes, b_planes):
        return kbit_mxu_gemm_plain(a_planes, b_planes)
    return launch_planes("kbit_mxu_gemm", a_planes, b_planes)
