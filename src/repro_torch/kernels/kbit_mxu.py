"""k-bit packed GEMM on the tensor cores — the code-lane contraction of the
DoReFa bit planes behind ``mxu-k2/k4/k8``; PyTorch port of
``repro.kernels.kbit_mxu``.

The weighted plane sum of :mod:`repro_torch.kernels.kbit_gemm` is the
integer dot of the reassembled codes ``n = sum_i 2^i * plane_i``:
``S[m, n] = sum_k n_a[m, k] * n_w[n, k]``.  So this kernel streams the same
packed plane words, builds one byte-wide code lane per bit position in
registers, and contracts once on the int8 tensor cores instead of ``ka*kb``
popcount passes.

The TPU kernel contracts signed offset codes ``n - 2^(k-1)`` and restores
S with a rank-1 binomial correction (``_offset_rowsum`` / ``_restore_s``)
because the TPU's int8 matrix unit is signed.  Hopper's ``mma`` takes
unsigned 8-bit operands, so the CUDA kernel (``csrc/kbit_mxu_gemm.cu``,
``mma.sync`` m16n8k32 u8 x u8 -> s32) contracts the raw codes and returns S
directly: there is no offset, no restore and no pad term, and absent words
are code 0.  It equals :func:`kbit_gemm.kbit_plane_gemm` bit for bit.

The kernel picks one of two tiles from the shapes and the SM count: a
swap-AB decode tile for M <= 32 (weight rows in the tensor core's 16-row
slot, so each weight plane word is read and built into codes once per
call whatever M is; the activation codes are built once per block into
shared memory; split over K where N is small; also taken, in row groups of
32, past 32 rows where the prefill grid would leave most SMs idle) and a
128 x 64 prefill tile that builds each code once per tile and chunk.  A
transpose network builds the codes from the plane words (byte j of
register s holds the code of bit 8j + s), the same for both operands
whatever their plane counts, so ``ka != kb`` share one lane order.  Both
tiles skip activation rows whose planes are all zero: such a row's codes
are 0, so its S is exactly 0 and the output keeps every bit, and a block
with no other row stores zeros and reads no weight word.

On a CUDA tensor :func:`kbit_mxu_gemm` launches the kernel (or raises); on
a CPU tensor it runs :func:`kbit_mxu_gemm_plain`.

:func:`kbit_mxu_gemm_batched` is the same function over a leading expert
axis, ``(E, ka, M, Kw) x (E, kb, N, Kw) -> (E, M, N)`` (K10, the MoE
expert buckets of the ``mxu-k*`` backends): the same two tiles with
``blockIdx.z`` = expert under its own C entry point.  The buckets hold
each expert's rows at the front and zero planes (or code-0 rows) behind,
so at decode only the experts that received a token, and only the 8-row
fragments that hold their rows, are contracted.  The TPU's batched kernel
applies the rank-1 restore per expert; here, as in 2-D, the raw codes give
S directly, equal to ``kbit_plane_gemm_batched`` bit for bit.
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


def kbit_mxu_gemm_batched_plain(a_planes: torch.Tensor,
                                b_planes: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched code-lane kernel: every expert's codes
    reassembled from (E, ka, M, Kw) / (E, kb, N, Kw) planes and contracted
    in float64 (exact, as in the 2-D form) -> (E, M, N) int32."""
    return torch.bmm(_codes(a_planes), _codes(b_planes).transpose(1, 2)).to(
        torch.int32)


def _codes(planes: torch.Tensor) -> torch.Tensor:
    """(E, k, rows, Kw) plane words -> (E, rows, Kw*32) float64 codes
    ``sum_i 2^i * plane_i``, summed in float32 (exact: codes <= 255)."""
    k_all = planes.shape[-1] * bitpack.WORD_BITS
    codes = bitpack.unpack_bits(planes[:, 0], k_all).to(torch.float32)
    for i in range(1, planes.shape[1]):
        codes += bitpack.unpack_bits(planes[:, i], k_all) * float(1 << i)
    return codes.to(torch.float64)


def kbit_mxu_gemm(a_planes: torch.Tensor,
                  b_planes: torch.Tensor) -> torch.Tensor:
    """Code-lane tensor-core GEMM: the same S (M, N) int32 as
    ``kbit_plane_gemm`` from (ka, M, Kw) x (kb, N, Kw) plane stacks.  On
    the card the swap-AB decode tile (M <= 32) or the 128 x 64 prefill tile
    runs; rows zero in every plane are skipped and give S = 0."""
    check_planes(a_planes, b_planes)
    if _cuda.on_cpu(a_planes, b_planes):
        return kbit_mxu_gemm_plain(a_planes, b_planes)
    return launch_planes("kbit_mxu_gemm", a_planes, b_planes)


def kbit_mxu_gemm_batched(a_planes: torch.Tensor,
                          b_planes: torch.Tensor) -> torch.Tensor:
    """Expert-batched code-lane tensor-core GEMM (K10): the same S (E, M, N)
    int32 as ``kbit_plane_gemm_batched``, on the same two tiles with one
    expert per grid slice; bucket rows zero in every plane are skipped
    (S = 0), so experts that received no token read no weight word."""
    check_planes(a_planes, b_planes, 4)
    if _cuda.on_cpu(a_planes, b_planes):
        return kbit_mxu_gemm_batched_plain(a_planes, b_planes)
    return launch_planes("kbit_mxu_gemm_batched", a_planes, b_planes)
