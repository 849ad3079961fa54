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
kernel (``csrc/kbit_plane_gemm.cu``: shared-memory plane-word tiles +
``__popc``) or raises; on a CPU tensor it runs
:func:`kbit_plane_gemm_plain`, which repeats the kernel's integer algorithm
in PyTorch ops (int64 SWAR popcount).  The expert-batched variant waits for
slice 4.
"""

from __future__ import annotations

import torch

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


def check_planes(a_planes: torch.Tensor, b_planes: torch.Tensor) -> None:
    """The operand checks both k-bit GEMM wrappers run."""
    _cuda.require(a_planes, "a_planes", torch.int32, 3)
    _cuda.require(b_planes, "b_planes", torch.int32, 3)
    if a_planes.shape[2] != b_planes.shape[2]:
        raise ValueError(f"Kw mismatch: {tuple(a_planes.shape)} vs "
                         f"{tuple(b_planes.shape)}")
    for name, t in (("a_planes", a_planes), ("b_planes", b_planes)):
        if not 1 <= t.shape[0] <= 8:
            raise ValueError(f"{name}: 1..8 planes, got {t.shape[0]}")


def launch_planes(name: str, a_planes: torch.Tensor,
                  b_planes: torch.Tensor) -> torch.Tensor:
    """Launch a k-bit GEMM kernel ``repro_<name>`` on checked CUDA operands
    and count it."""
    ka, m, kw = a_planes.shape
    kb, n, _ = b_planes.shape
    out = torch.empty((m, n), dtype=torch.int32, device=a_planes.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a_planes.device):
        rc = getattr(_cuda.lib(), f"repro_{name}")(
            a_planes.data_ptr(), b_planes.data_ptr(), out.data_ptr(), m, n, kw,
            ka, kb, _cuda.stream_handle(a_planes.device))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


def kbit_plane_gemm(a_planes: torch.Tensor,
                    b_planes: torch.Tensor) -> torch.Tensor:
    """Weighted bit-plane AND popcount GEMM: S (M, N) int32 from (ka, M, Kw)
    activation and (kb, N, Kw) weight plane stacks (ka != kb allowed)."""
    check_planes(a_planes, b_planes)
    if _cuda.on_cpu(a_planes, b_planes):
        return kbit_plane_gemm_plain(a_planes, b_planes)
    return launch_planes("kbit_plane_gemm", a_planes, b_planes)
