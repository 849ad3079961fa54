"""k-bit packed GEMM as bit-plane popcount — the DoReFa (paper Eq. 1)
serving path behind ``vpu-k2/k4/k8``; PyTorch port of
``repro.kernels.kbit_gemm``.

A k-bit unsigned code ``n = sum_i 2^i b_i`` splits into k bit planes, each
packed into 32-bit words like the 1-bit operands (weights by
``core/bitpack.pack_planes`` at convert time, activations by the
``quant_pack_planes`` prologue).  The integer dot of activation codes with
weight codes then decomposes into plane-pair AND+popcount passes:

    S[m, n] = sum_{i < ka, j < kb} 2^(i+j) * popcount(A_i[m] & B_j[n])

and :mod:`repro_torch.kernels.dispatch` recovers the fake-quant DoReFa dot
as ``(2*S - Nw*T) / (Na*Nw)``.  Tail bits are 0 in every plane of both
operands, so no pad correction exists, and S over disjoint Kw slices sums
exactly.

On a CUDA tensor :func:`kbit_plane_gemm` launches the hand-written Hopper
kernel (``csrc/kbit_plane_gemm.cu``, AND + ``__popc`` on the CUDA cores)
or raises; on a CPU tensor it runs :func:`kbit_plane_gemm_plain`, which
repeats the kernel's integer algorithm in PyTorch ops (int64 SWAR
popcount).  The kernel picks one of two tiles from the shapes and the SM
count: a decode tile for M <= 32 (each weight word read from device memory
once per call into registers and met by all M*ka activation words, split
over K where N is small; also taken, in row groups of 32, past 32 rows
where the prefill grid would leave most SMs idle) and a 64 x 64 prefill
tile of 4 x 4 sums per thread.  Both skip activation rows whose planes are
all zero: such a row's S is exactly 0 (x & 0 = 0), so the output keeps
every bit, and a block with no other row stores zeros and reads no weight
word.

:func:`kbit_plane_gemm_batched` is the same function over a leading expert
axis, ``(E, ka, M, Kw) x (E, kb, N, Kw) -> (E, M, N)`` — the MoE expert
buckets of ``dispatch.quant_gemm_grouped`` at k bits (K9).  Its CUDA
kernels are the same two tiles with ``blockIdx.z`` = expert, in the same
source under its own C entry point (so launch counts and profiler names
tell it from K5).  The buckets hold each expert's rows at the front and
zero planes behind, so at decode the zero-row skip leaves only the experts
that received a token, and only their rows.  Its plain version counts
each plane pair's common set bits as an exact float32 ``bmm`` of the
unpacked 0/1 planes (every partial sum is an integer below 2^24), which
the serving shapes' ``ka*kb`` passes over 64 experts need: the SWAR form
would take seconds per call.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _cuda
from repro_torch.kernels.xnor_gemm import _PLAIN_CHUNK_WORDS, _popcount32


def kbit_plane_gemm_plain(a_planes: torch.Tensor,
                          b_planes: torch.Tensor) -> torch.Tensor:
    """Plain version of the plane kernel: (ka, M, Kw) x (kb, N, Kw) int32
    words -> (M, N) int32 weighted plane popcount S."""
    a64, b64 = a_planes.to(torch.int64), b_planes.to(torch.int64)
    acc = torch.zeros((a_planes.shape[1], b_planes.shape[1]),
                      dtype=torch.int64, device=a_planes.device)
    for w0 in range(0, a_planes.shape[2], _PLAIN_CHUNK_WORDS):
        sl = slice(w0, w0 + _PLAIN_CHUNK_WORDS)
        for i in range(a64.shape[0]):
            for j in range(b64.shape[0]):
                x = a64[i, :, None, sl] & b64[j, None, :, sl]
                acc += _popcount32(x).sum(dim=-1) << (i + j)
    return acc.to(torch.int32)


def kbit_plane_gemm_batched_plain(a_planes: torch.Tensor,
                                  b_planes: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched plane kernel: (E, ka, M, Kw) x (E, kb,
    N, Kw) int32 words -> (E, M, N) int32, per expert
    ``sum_{i,j} 2^(i+j) * popcount(A_i & B_j)``.  Each plane pair's popcount
    summed over the words is the number of bit positions set in both rows:
    a float32 ``bmm`` of the unpacked 0/1 planes, exact because every
    partial sum is an integer below 2^24 (K <= 2^24)."""
    k_all = a_planes.shape[-1] * bitpack.WORD_BITS
    if k_all >= 2**24:
        raise ValueError(f"Kw {a_planes.shape[-1]}: the float32 popcount is "
                         "exact below 2^24 bits")
    ua = [bitpack.unpack_bits(a_planes[:, i], k_all).to(torch.float32)
          for i in range(a_planes.shape[1])]
    acc = torch.zeros((a_planes.shape[0], a_planes.shape[2],
                       b_planes.shape[2]), dtype=torch.int64,
                      device=a_planes.device)
    for j in range(b_planes.shape[1]):
        ubt = bitpack.unpack_bits(b_planes[:, j], k_all).to(
            torch.float32).transpose(1, 2)
        for i, uai in enumerate(ua):
            acc += torch.bmm(uai, ubt).to(torch.int64) << (i + j)
    return acc.to(torch.int32)


def check_planes(a_planes: torch.Tensor, b_planes: torch.Tensor,
                 ndim: int = 3) -> None:
    """The operand checks every k-bit GEMM wrapper runs: 2-D plane stacks
    (``ndim`` 3) or expert-batched ones (4, the expert count first)."""
    _cuda.require(a_planes, "a_planes", torch.int32, ndim)
    _cuda.require(b_planes, "b_planes", torch.int32, ndim)
    if (a_planes.shape[-1] != b_planes.shape[-1]
            or a_planes.shape[:-3] != b_planes.shape[:-3]):
        raise ValueError(f"Kw mismatch or expert counts differ: "
                         f"{tuple(a_planes.shape)} vs {tuple(b_planes.shape)}")
    for name, t in (("a_planes", a_planes), ("b_planes", b_planes)):
        if not 1 <= t.shape[-3] <= 8:
            raise ValueError(f"{name}: 1..8 planes, got {t.shape[-3]}")


def launch_planes(name: str, a_planes: torch.Tensor,
                  b_planes: torch.Tensor) -> torch.Tensor:
    """Launch a k-bit GEMM kernel ``repro_<name>`` on checked CUDA operands
    (2-D plane stacks, or expert stacks for the ``*_batched`` entry points,
    which take the expert count first) and count it."""
    *lead, ka, m, kw = a_planes.shape
    kb, n, _ = b_planes.shape[-3:]
    out = torch.empty((*lead, m, n), dtype=torch.int32,
                      device=a_planes.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a_planes.device):
        rc = getattr(_cuda.lib(), f"repro_{name}")(
            a_planes.data_ptr(), b_planes.data_ptr(), out.data_ptr(), *lead,
            m, n, kw, ka, kb, _cuda.stream_handle(a_planes.device))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


def kbit_plane_gemm(a_planes: torch.Tensor,
                    b_planes: torch.Tensor) -> torch.Tensor:
    """Weighted bit-plane AND popcount GEMM: S (M, N) int32 from (ka, M, Kw)
    activation and (kb, N, Kw) weight plane stacks (ka != kb allowed).  On
    the card the decode tile (M <= 32) or the prefill tile runs; rows zero
    in every plane are skipped and give S = 0."""
    check_planes(a_planes, b_planes)
    if _cuda.on_cpu(a_planes, b_planes):
        return kbit_plane_gemm_plain(a_planes, b_planes)
    return launch_planes("kbit_plane_gemm", a_planes, b_planes)


def kbit_plane_gemm_batched(a_planes: torch.Tensor,
                            b_planes: torch.Tensor) -> torch.Tensor:
    """Expert-batched weighted plane popcount GEMM (K9): (E, ka, M, Kw)
    activation buckets x (E, kb, N, Kw) expert plane stacks -> S (E, M, N)
    int32.  On the card the decode or prefill tile runs per expert; bucket
    rows zero in every plane (the tails behind each expert's rows, experts
    with no row) are skipped and give S = 0."""
    check_planes(a_planes, b_planes, 4)
    if _cuda.on_cpu(a_planes, b_planes):
        return kbit_plane_gemm_batched_plain(a_planes, b_planes)
    return launch_planes("kbit_plane_gemm_batched", a_planes, b_planes)
