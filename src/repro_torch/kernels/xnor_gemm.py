"""Packed binary GEMM kernels — the PyTorch port of
``repro.kernels.xnor_gemm`` (BMXNet §2.2.1, Listing 3).

Both consume packed operands ((M, Kw) activations, (N, Kw) weights, int32
words packed along K — core/bitpack.py) and return raw int32 outputs that
:mod:`repro_torch.kernels.dispatch` turns into the exact ±1 dot:

``xnor_mismatch`` (backend ``vpu``)
    ``sum_w popcount(a ^ b)``; ``dot = k_true - 2 * mismatches``.
    CUDA: ``csrc/xnor_mismatch.cu`` (XOR + ``__popc`` on the CUDA cores,
    carry-save: 8 words in 4 popcounts).  Two tiles, chosen by the C entry
    point (:func:`tile_plan` reads its plan back): up to 32 activation rows a decode tile (16
    weight rows a warp, each weight word read once per call through a
    ``cp.async`` ring, K split among a block's warps where N is small),
    above that a 64 x 64 prefill tile of 4 x 4 sums per thread.

``xnor_dot_mxu`` (backend ``mxu``)
    unpack every word to ±1 int8 and contract: the *padded* dot, inflated
    by ``mxu_pad_inflation(Kw, k_true)`` because zero pad bits unpack to
    (-1)·(-1); it equals ``32 * Kw - 2 * xnor_mismatch``.  CUDA:
    ``csrc/xnor_dot_mxu.cu`` (``mma.sync`` m16n8k32 s8 on the tensor cores,
    ±1 int8 fragments unpacked from the words in registers, words streamed
    through a ``cp.async`` ring); it contracts exactly the Kw words it is
    given.  Two tiles: up to 32 activation rows a swap-AB decode tile
    (weight rows in the m16 slot, each weight word read and unpacked once
    per call, K split among a block's warps where N is small), above that
    a prefill tile of 128 weight rows x 64 activation rows per block.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs its ``*_plain`` version, which repeats the kernel's integer
algorithm in PyTorch ops (int64 SWAR popcount / ±1 unpack).  Both raw outputs are K-partial-safe: integer partials over
disjoint Kw slices sum exactly.

``xnor_mismatch_batched`` / ``xnor_dot_mxu_batched`` are the same two
functions over a leading expert axis, ``(E, M, Kw) x (E, N, Kw) -> (E, M,
N)`` — the MoE expert buckets of ``dispatch.quant_gemm_grouped``.  Their
CUDA kernels are the 2-D tiles with ``blockIdx.z`` = expert, in the same
sources under their own C entry points (so launch counts and profiler
names tell them from the 2-D kernels).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _cuda

WORD_BITS = bitpack.WORD_BITS
_PLAIN_CHUNK_WORDS = 8  # bounds the (M, N, chunk) int64 temporaries
# csrc/xnor_mismatch.cu's plan, as repro_xnor_mismatch_plan reports it
_PLAN_FIELDS = ("decode", "grid_x", "grid_y", "grid_z", "threads", "smem",
                "rows", "row_groups", "row_tiles", "splits", "pieces")


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


def _full_add(x, y, z):
    """Full adder on 32 bit lanes: ``x + y + z = sum + 2 * carry``."""
    return x ^ y ^ z, (x & y) | (z & (x ^ y))


def popc8(w: torch.Tensor) -> torch.Tensor:
    """``sum_i popcount(w[..., i])`` over 8 words (int64, low 32 bits) in 4
    popcounts: a carry-save tree of four full adders reduces 7 words of
    weight 1 to one word each of weight 1, 2 and 4 (Harley-Seal), as
    ``popc8`` in csrc/xnor_mismatch.cu folds the XOR words.  The plain
    versions below count word by word, independent of this fold."""
    s1, c1 = _full_add(w[..., 0], w[..., 1], w[..., 2])
    s2, c2 = _full_add(w[..., 3], w[..., 4], w[..., 5])
    s3, c3 = _full_add(s1, s2, w[..., 6])
    s4, c4 = _full_add(c1, c2, c3)
    return (_popcount32(s3) + _popcount32(w[..., 7]) + 2 * _popcount32(s4)
            + 4 * _popcount32(c4))


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


@functools.cache
def _plan_fn():
    fn = _cuda.lib().repro_xnor_mismatch_plan
    fn.argtypes = 4 * [ctypes.c_longlong] + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    return fn


def tile_plan(e: int, m: int, n: int, kw: int, sms: int) -> dict:
    """The tile csrc/xnor_mismatch.cu launches for an (E,) M x N x Kw call
    on a card with ``sms`` SMs, read from the C entry point's own plan (it
    launches nothing; needs the built kernel library): ``tile`` ("decode"
    or "prefill"), the grid, the threads a block, its dynamic shared memory
    and, for the decode tile, its row count (``rows``, the block's rows
    padded up), the row groups, the row tiles and ``splits`` a block, and
    Kw's 16-word ``pieces``, which the splits share in equal runs."""
    out = (ctypes.c_longlong * len(_PLAN_FIELDS))()
    _cuda.check(_plan_fn()(e, m, n, kw, sms, out), "xnor_mismatch_plan")
    f = dict(zip(_PLAN_FIELDS, out))
    plan = dict(tile="decode" if f["decode"] else "prefill",
                grid=(f["grid_x"], f["grid_y"], f["grid_z"]),
                threads=f["threads"], smem=f["smem"])
    if f["decode"]:
        plan.update((k, f[k]) for k in ("rows", "row_groups", "row_tiles",
                                        "splits", "pieces"))
    return plan


def describe_plan(plan: dict) -> str:
    """One line for a :func:`tile_plan`."""
    blocks = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
    if plan["tile"] == "prefill":
        return f"prefill tile, {blocks} blocks of 64 x 64"
    per = plan["pieces"] / plan["splits"]
    return (f"decode tile of {plan['rows']} rows, "
            f"{plan['row_groups']} row group(s), "
            f"{plan['row_tiles']} row tile(s) x {plan['splits']} split(s) of "
            f"{per:g} piece(s) a block, {blocks} blocks of "
            f"{plan['threads'] // 32} warps")


def xnor_dot_mxu_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the mxu kernel: unpack all Kw words of both operands
    to ±1 (pad bits included) and contract -> (M, N) int32 padded dot.  The
    contraction runs in float64, where every partial sum (|s| <= Kw*32) is
    an exact integer, so the result equals the int8 x int8 -> int32 dot."""
    k_all = a.shape[1] * WORD_BITS
    ua = bitpack.unpack_sign(a, k_all, torch.float64)
    ub = bitpack.unpack_sign(b, k_all, torch.float64)
    return (ua @ ub.T).to(torch.int32)


def xnor_mismatch_batched_plain(a: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched vpu kernel: (E, M, Kw) x (E, N, Kw)
    int32 words -> (E, M, N) int32, the 2-D algorithm per expert."""
    out = torch.empty((a.shape[0], a.shape[1], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    for e in range(a.shape[0]):
        out[e] = xnor_mismatch_plain(a[e], b[e])
    return out


def xnor_dot_mxu_batched_plain(a: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched mxu kernel: every expert's words
    unpacked to ±1 (pad bits included) and contracted in float64 (exact) ->
    (E, M, N) int32 padded dots."""
    k_all = a.shape[-1] * WORD_BITS
    ua = bitpack.unpack_sign(a, k_all, torch.float64)
    ub = bitpack.unpack_sign(b, k_all, torch.float64)
    return torch.bmm(ua, ub.transpose(1, 2)).to(torch.int32)


def _check_operands(a: torch.Tensor, b: torch.Tensor, ndim: int = 2) -> None:
    _cuda.require(a, "a_packed", torch.int32, ndim)
    _cuda.require(b, "b_packed", torch.int32, ndim)
    if a.shape[-1] != b.shape[-1] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"Kw mismatch or expert counts differ: "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")


def _launch(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``repro_{name}`` on 2-D operands, or on 3-D expert stacks
    (the ``*_batched`` entry points, which take the expert count first)."""
    *lead, m, kw = a.shape
    n = b.shape[-2]
    out = torch.empty((*lead, m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        rc = getattr(_cuda.lib(), f"repro_{name}")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), *lead, m, n, kw,
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
    True dot = result - mxu_pad_inflation(Kw, k_true).  The kernel runs
    its decode tile for M <= 32 and its prefill tile above."""
    _check_operands(a_packed, b_packed)
    if _cuda.on_cpu(a_packed, b_packed):
        return xnor_dot_mxu_plain(a_packed, b_packed)
    return _launch("xnor_dot_mxu", a_packed, b_packed)


def xnor_mismatch_batched(a_packed: torch.Tensor,
                          b_packed: torch.Tensor) -> torch.Tensor:
    """Expert-batched VPU path: (E, M, Kw) x (E, N, Kw) -> (E, M, N) int32
    raw xor-mismatch counts (K7)."""
    _check_operands(a_packed, b_packed, 3)
    if _cuda.on_cpu(a_packed, b_packed):
        return xnor_mismatch_batched_plain(a_packed, b_packed)
    return _launch("xnor_mismatch_batched", a_packed, b_packed)


def xnor_dot_mxu_batched(a_packed: torch.Tensor,
                         b_packed: torch.Tensor) -> torch.Tensor:
    """Expert-batched MXU path: (E, M, N) int32 *padded* ±1 dots over
    exactly Kw words (K8); subtract ``mxu_pad_inflation(Kw, k_true)``.
    K3's two tiles per expert (``blockIdx.z``): the decode tile for bucket
    rows M <= 32 (deepseek-moe-16b's 24 at decode), the prefill tile
    above."""
    _check_operands(a_packed, b_packed, 3)
    if _cuda.on_cpu(a_packed, b_packed):
        return xnor_dot_mxu_batched_plain(a_packed, b_packed)
    return _launch("xnor_dot_mxu_batched", a_packed, b_packed)
