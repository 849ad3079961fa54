"""The PyTorch port's CUDA kernels on the card, against their plain PyTorch
versions (exact, int32) and the port's CPU path.  Marked ``gpu``: they skip
without a CUDA GPU.  This file imports no JAX (the machine with the card has
none).  Run there with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import bitpack, converter, quant
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import synthetic
from repro_torch.kernels import (_cuda, attn_decode, dispatch, kbit_gemm,
                                 kbit_mxu, pack_bits, xnor_gemm)
from repro_torch.launch import quickstart
from repro_torch.models import lm, registry
from repro_torch.nn import attention
from repro_torch.nn.common import QCtx
from repro_torch.optim import adamw
from repro_torch.serve import engine
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch import resolve_device

    return resolve_device("cuda")


def _floats(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev)
    flat = x.view(-1)
    edge = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf")],
                        device=dev)
    flat[: min(flat.numel(), 5)] = edge[: min(flat.numel(), 5)]
    return x


def _words(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-2**31, 2**31, shape, generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32)


# K1's plan (csrc/pack_sign.cu) gives a warp 8 words (256 floats) at
# decode and 16 (512) at prefill, and a block 4 warps (1,024 or 2,048
# floats): K one float and one word either side of each such edge and its
# multiples, at decode (M 4), just past it (M 33) and at prefill (M 256);
# K % 4 != 0 reads by 4-byte loads.  Then the MoE prologue's 24 / 576
# expert-sorted rows at K 2048 / 1408, deepseek-moe-16b's dense `down`
# input (K 10944, Kw 342) at one, four and 576 rows, and many rows of one
# word.
K1_EDGE_K = [e + d for e in (256, 512, 1024, 2048, 4096, 8192, 16384)
             for d in (-32, -1, 1, 32)]
K1_CASES = ([(1, 1), (3, 33), (4, 2048), (128, 8192), (5, 2049), (257, 100)]
            + [(m, k) for m in (4, 33, 256) for k in K1_EDGE_K]
            + [(24, 2048), (24, 1408), (576, 2048), (576, 1408), (4, 10944),
               (1, 10944), (576, 10944), (4096, 33)])


@pytest.mark.parametrize("m,k", K1_CASES)
def test_pack_sign_kernel_matches_plain(cuda, m, k):
    x = _floats((m, k), m + k, cuda)
    got = pack_bits.pack_sign(x)
    again = pack_bits.pack_sign(x)
    # the same values one float into their storage: contiguous, not 16-byte
    # aligned, so read by 4-byte loads
    buf = torch.empty(m * k + 1, device=cuda)
    view = buf[1:].view(m, k)
    view.copy_(x)
    shifted = pack_bits.pack_sign(view)
    torch.cuda.synchronize()
    want = pack_bits.pack_sign_plain(x)
    assert torch.equal(got, want)
    # a second call repeats the first bit for bit
    assert torch.equal(again, got)
    assert torch.equal(shifted, want)


def _edge_rows(m, k, dev):
    """Rows cycling through the sign's edge values -- ±0, ±NaN, ±inf,
    ±denormals (the smallest and 1e-39), ±1 and 3 -- with a period
    of 13, odd to every lane's stride, so every lane and every bit position
    of a word meets each of them."""
    edge = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                         -float("inf"), 1e-45, -1e-45, 1e-39, -1e-39, 1.0,
                         -1.0, 3.0], dtype=torch.float32)
    # and a NaN with its sign bit set (0xffc00000)
    neg_nan = torch.tensor([-(1 << 22)], dtype=torch.int32).view(torch.float32)
    edge = torch.cat([edge, neg_nan])
    idx = (torch.arange(m * k).reshape(m, k)
           + 5 * torch.arange(m).reshape(m, 1)) % edge.numel()
    return edge[idx].to(dev)


@pytest.mark.parametrize("m,k", [(4, 2048), (24, 1408), (256, 8192),
                                 (576, 2048), (4, 10944), (7, 1023)])
def test_pack_sign_kernel_on_edge_values(cuda, m, k):
    x = _edge_rows(m, k, cuda)
    assert (torch.isnan(x) & (x.view(torch.int32) < 0)).any()
    got = pack_bits.pack_sign(x)
    torch.cuda.synchronize()
    assert torch.equal(got, pack_bits.pack_sign_plain(x))


@pytest.mark.parametrize("m,k", [(4, 2048), (256, 8192), (4096, 33),
                                 (0, 2048), (4, 0), (0, 0)])
def test_pack_sign_launches_once_per_call(cuda, m, k):
    """One counted launch per call; no rows or K = 0 launch nothing and
    give an empty (M, Kw) result."""
    x = torch.randn((m, k), device=cuda)
    _cuda.reset_launches()
    got = pack_bits.pack_sign(x)
    pack_bits.pack_sign(x)
    torch.cuda.synchronize()
    assert got.shape == (m, bitpack.packed_width(k))
    want = 0 if got.numel() == 0 else 2
    assert _cuda.LAUNCHES["pack_sign"] == want
    assert sum(_cuda.LAUNCHES.values()) == want


# K3 / K8 tile boundaries: M on both sides of the decode tile's 32 rows
# (and K8's 24 / 576 bucket rows), N off the 16- and 128-row tiles, Kw
# ragged against the 16-word chunk and the split-K runs
TILE_M = (1, 4, 8, 9, 24, 32, 33, 64, 256, 576)
TILE_N = (17, 512, 1408, 2047)
TILE_KW = (1, 5, 63, 65, 257)
TILE_CASES = [(m, n, kw) for m in TILE_M for n in TILE_N for kw in TILE_KW]


@pytest.mark.parametrize("m,n,kw", [(1, 1, 1), (3, 5, 7), (4, 2048, 64),
                                    (17, 8192, 64), (128, 2048, 256),
                                    (33, 65, 9)] + TILE_CASES)
def test_gemm_kernels_match_plain(cuda, m, n, kw):
    a, b = _words((m, kw), 1, cuda), _words((n, kw), 2, cuda)
    got_v, got_m = xnor_gemm.xnor_mismatch(a, b), xnor_gemm.xnor_dot_mxu(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got_v, xnor_gemm.xnor_mismatch_plain(a, b))
    assert torch.equal(got_m, xnor_gemm.xnor_dot_mxu_plain(a, b))
    assert torch.equal(got_m, 32 * kw - 2 * got_v)


def test_launch_counts(cuda):
    _cuda.reset_launches()
    x = _floats((2, 70), 0, cuda)
    w = pack_bits.pack_sign(_floats((5, 70), 1, cuda))
    for backend in ("vpu", "mxu"):
        dispatch.quant_gemm(x, w, k_true=70,
                            config=dispatch.GemmConfig(backend=backend))
    dispatch.quant_gemm(x.cpu(), w.cpu(), k_true=70)  # plain versions
    assert _cuda.LAUNCHES == {"pack_sign": 3, "xnor_mismatch": 1,
                              "xnor_dot_mxu": 1, "xnor_mismatch_batched": 0,
                              "xnor_dot_mxu_batched": 0,
                              "quant_pack_planes": 0, "kbit_plane_gemm": 0,
                              "kbit_mxu_gemm": 0, "flash_decode": 0,
                              "kbit_plane_gemm_batched": 0,
                              "kbit_mxu_gemm_batched": 0}


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
@pytest.mark.parametrize("k", [70, 2048, 8192])
def test_quant_gemm_cuda_equals_cpu(cuda, backend, k):
    x = _floats((6, k), k, cuda)
    w = _floats((40, k), k + 1, cuda)
    wp = pack_bits.pack_sign_plain(w)
    cfg = dispatch.GemmConfig(backend=backend)
    ep = dispatch.EpilogueSpec(xnor_range=True)
    got = dispatch.quant_gemm(x, wp, k_true=k, config=cfg, epilogue=ep)
    want = dispatch.quant_gemm(x.cpu(), wp.cpu(), k_true=k, config=cfg,
                               epilogue=ep)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("e,m,n,kw", [(1, 1, 1, 1), (3, 5, 33, 7),
                                      (64, 24, 1408, 64), (64, 24, 2048, 44),
                                      (64, 576, 1408, 64), (2, 77, 65, 9),
                                      (5, 17, 100, 5)]
                         + [(2, m, n, kw) for m, n, kw in TILE_CASES])
def test_batched_gemm_kernels_match_plain(cuda, e, m, n, kw):
    a, b = _words((e, m, kw), 3, cuda), _words((e, n, kw), 4, cuda)
    got_v = xnor_gemm.xnor_mismatch_batched(a, b)
    got_m = xnor_gemm.xnor_dot_mxu_batched(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got_v, xnor_gemm.xnor_mismatch_batched_plain(a, b))
    assert torch.equal(got_m, xnor_gemm.xnor_dot_mxu_batched_plain(a, b))
    assert torch.equal(got_m, 32 * kw - 2 * got_v)


# K2 / K7 tiles (csrc/xnor_mismatch.cu; xnor_gemm.tile_plan reads its plan):
# M on both sides of the decode tile's 32 rows with small N (row groups of
# 32 where the prefill grid would fill under half the SMs), N off the 16-row
# warp tile, ragged Kw (word-by-word copies) against the 16-word piece,
# granite's q / k / v / o / up / down at the rows that give every split
# count, and deepseek-moe-16b's expert GEMMs at 24 and 576 bucket rows
XNOR_EDGES = [(m, n, kw) for m in (31, 32, 33, 64, 65) for n, kw in
              ((17, 64), (40, 44), (100, 9), (250, 16))]
XNOR_GRANITE = [(m, n, kw) for m in (1, 4, 8, 32, 96, 256)
                for n, kw in ((2048, 64), (512, 64), (8192, 64), (2048, 256))]
XNOR_MOE = [(64, m, n, kw) for m in (24, 576) for n, kw in ((1408, 64),
                                                            (2048, 44))]


@pytest.mark.parametrize("m,n,kw", XNOR_EDGES + XNOR_GRANITE)
def test_xnor_mismatch_tiles_match_plain(cuda, m, n, kw):
    a, b = _words((m, kw), m + kw, cuda), _words((n, kw), n + kw, cuda)
    got = xnor_gemm.xnor_mismatch(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, xnor_gemm.xnor_mismatch_plain(a, b))


def test_xnor_mismatch_plans_reach_every_split(cuda):
    """The granite cases above reach both tiles, row groups and splits of
    1, 2, 4 and 8 on this card (the plan the C entry point launches, read
    back by ``tile_plan``), and every decode plan's grid and pieces cover
    every weight row, activation row and Kw word."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plans = [xnor_gemm.tile_plan(1, m, n, kw, sms)
             for m, n, kw in XNOR_GRANITE + XNOR_EDGES]
    decode = [p for p in plans if p["tile"] == "decode"]
    for p, (m, n, kw) in zip(plans, XNOR_GRANITE + XNOR_EDGES):
        if p["tile"] == "decode":
            assert p["grid"][0] * p["row_tiles"] * 16 >= n
            assert p["grid"][1] * 32 >= m and p["rows"] >= min(m, 32)
            assert p["pieces"] * 16 >= kw > (p["pieces"] - 1) * 16
            assert p["splits"] <= p["pieces"]
            assert p["threads"] == 32 * p["row_tiles"] * p["splits"] <= 256
        else:
            assert p["grid"][0] * 64 >= n and p["grid"][1] * 64 >= m
    assert {p["splits"] for p in decode} == {1, 2, 4, 8}
    assert any(p["row_groups"] > 1 for p in decode)
    assert any(p["tile"] == "prefill" for p in plans)


@pytest.mark.parametrize("e,m,n,kw", XNOR_MOE + [(3, m, n, kw) for m, n, kw
                                                  in XNOR_EDGES])
def test_xnor_mismatch_batched_tiles_match_plain(cuda, e, m, n, kw):
    a, b = _words((e, m, kw), m + kw, cuda), _words((e, n, kw), n + kw, cuda)
    got = xnor_gemm.xnor_mismatch_batched(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, xnor_gemm.xnor_mismatch_batched_plain(a, b))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("m,n,kw", [(4, 100, 64), (24, 1408, 44),
                                    (33, 17, 8), (256, 130, 20)])
def test_xnor_mismatch_unaligned_operands(cuda, batched, m, n, kw):
    """Operands at a 4-byte but not 16-byte offset (contiguous views one
    word into a buffer), Kw % 4 == 0: the kernel copies word by word."""
    lead = (2,) if batched else ()
    sa, sb = (*lead, m, kw), (*lead, n, kw)
    a = _words((math.prod(sa) + 1,), 7, cuda)[1:].view(sa)
    b = _words((math.prod(sb) + 1,), 8, cuda)[1:].view(sb)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    kernel, plain = ((xnor_gemm.xnor_mismatch_batched,
                      xnor_gemm.xnor_mismatch_batched_plain) if batched else
                     (xnor_gemm.xnor_mismatch, xnor_gemm.xnor_mismatch_plain))
    got = kernel(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(a.clone(), b.clone()))


@pytest.mark.parametrize("fill_a,fill_b", [(0, -1), (-1, 0), (-1, -1), (0, 0)])
@pytest.mark.parametrize("m,n,kw", [(4, 2048, 256), (24, 40, 44),
                                    (256, 130, 63), (1, 1, 1)])
def test_xnor_mismatch_constant_words(cuda, fill_a, fill_b, m, n, kw):
    """All-zero and all-ones words: every bit mismatches where they meet,
    and every sum is 32 * Kw (or 0), on both tiles, 2-D and batched."""
    want = 32 * kw if fill_a != fill_b else 0
    for lead in ((), (3,)):
        a = torch.full((*lead, m, kw), fill_a, dtype=torch.int32, device=cuda)
        b = torch.full((*lead, n, kw), fill_b, dtype=torch.int32, device=cuda)
        got = (xnor_gemm.xnor_mismatch_batched(a, b) if lead
               else xnor_gemm.xnor_mismatch(a, b))
        torch.cuda.synchronize()
        assert torch.equal(got, torch.full_like(got, want))


@pytest.mark.parametrize("e,m,n,kw", [(1, 4, 2048, 64), (1, 4, 2048, 256),
                                      (1, 256, 8192, 64), (64, 24, 1408, 64),
                                      (64, 576, 2048, 44)])
def test_xnor_mismatch_repeats_bit_for_bit(cuda, e, m, n, kw):
    """Two calls on the same inputs give the same bits (integer sums, the
    split-K partials added in a fixed order)."""
    a, b = _words((e, m, kw), 11, cuda), _words((e, n, kw), 12, cuda)
    if e == 1:
        a, b = a[0], b[0]
        fn = xnor_gemm.xnor_mismatch
    else:
        fn = xnor_gemm.xnor_mismatch_batched
    first, second = fn(a, b), fn(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _grouped_operands(dev, t=48, k=300, e=8, n=70, stacks=2):
    x = _floats((t, k), 5, dev)
    ws = tuple(pack_bits.pack_sign_plain(_floats((e, n, k), 6 + i, dev))
               for i in range(stacks))
    gs = torch.tensor([9, 0, 13, 1, 0, 11, 6, 4], device=dev)[:e]
    return x, ws, gs


def test_grouped_launch_counts(cuda):
    """A grouped call packs once and launches K7 (``vpu``) or K8
    (``mxu``) once per stack — never the 2-D K2/K3 — and ``xla`` and the
    CPU launch nothing."""
    x, ws, gs = _grouped_operands(cuda)
    _cuda.reset_launches()
    for backend in ("vpu", "mxu", "xla"):
        dispatch.quant_gemm_grouped(x, ws, gs, k_true=x.shape[1],
                                    config=dispatch.GemmConfig(backend=backend))
    dispatch.quant_gemm_grouped(x.cpu(), tuple(w.cpu() for w in ws), gs.cpu(),
                                k_true=x.shape[1])
    assert _cuda.LAUNCHES == {"pack_sign": 2, "xnor_mismatch": 0,
                              "xnor_dot_mxu": 0, "xnor_mismatch_batched": 2,
                              "xnor_dot_mxu_batched": 2,
                              "quant_pack_planes": 0, "kbit_plane_gemm": 0,
                              "kbit_mxu_gemm": 0, "flash_decode": 0,
                              "kbit_plane_gemm_batched": 0,
                              "kbit_mxu_gemm_batched": 0}


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
@pytest.mark.parametrize("stacks", [1, 2])
@pytest.mark.parametrize("capacity", [None, 6, 2])  # full, drops, route-first
def test_quant_gemm_grouped_cuda_equals_cpu(cuda, backend, stacks, capacity):
    x, ws, gs = _grouped_operands(cuda, stacks=stacks)
    w = ws if stacks > 1 else ws[0]
    cfg = dispatch.GemmConfig(backend=backend)
    got = dispatch.quant_gemm_grouped(x, w, gs, k_true=x.shape[1], config=cfg,
                                      expert_capacity=capacity)
    want = dispatch.quant_gemm_grouped(
        x.cpu(), tuple(v.cpu() for v in ws) if stacks > 1 else w.cpu(),
        gs.cpu(), k_true=x.shape[1], config=cfg, expert_capacity=capacity)
    got = got if stacks > 1 else (got,)
    want = want if stacks > 1 else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _acts(shape, seed, dev, a_bits):
    """Floats over [-0.5, 1.5] with the DoReFa edge cases: rounding ties
    (j + 0.5)/Na, -0.0, 0, 1, below 0, above 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(shape, generator=g, device=dev) * 2 - 0.5
    na = (1 << a_bits) - 1
    edge = torch.tensor([(j + 0.5) / na for j in range(na)]
                        + [-0.0, 0.0, 1.0, -3.0, 7.0], device=dev)
    flat = x.view(-1)
    n = min(flat.numel(), edge.numel())
    flat[:n] = edge[:n]
    return x


# K4's plan (csrc/quant_pack_planes.cu) splits a row over 1-32 warps of 8
# or 16 words and loops over chunks of 32 x 16 words: the MoE prologue's
# 24 / 576 expert-sorted rows at K 2048 / 1408, deepseek-moe-16b's dense
# `down` at K 10944 (22 warps of 16, the last one short), Kw 37 (5 warps of
# 8, the last one short), one row, Kw 529 (two chunks) and M 576 at
# K 10944.
@pytest.mark.parametrize("a_bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m,k", [(1, 1), (3, 33), (4, 2048), (128, 8192),
                                 (5, 2049), (256, 8191), (24, 2048),
                                 (24, 1408), (576, 2048), (576, 1408),
                                 (4, 10944), (4, 37 * 32 - 5), (1, 2048),
                                 (2, 529 * 32 - 7), (576, 10944)])
def test_quant_pack_planes_kernel_matches_plain(cuda, a_bits, m, k):
    x = _acts((m, k), m + k, cuda, a_bits)
    got_p, got_t = pack_bits.quant_pack_planes(x, a_bits)
    again_p, again_t = pack_bits.quant_pack_planes(x, a_bits)
    torch.cuda.synchronize()
    want_p, want_t = pack_bits.quant_pack_planes_plain(x, a_bits)
    assert torch.equal(got_p, want_p) and torch.equal(got_t, want_t)
    # a second call repeats the first bit for bit
    assert torch.equal(again_p, got_p) and torch.equal(again_t, got_t)


def _tie_rows(m, k, a_bits, dev):
    """Rows whose values sit on the code ties (j + 0.5)/Na and one float
    either side of them, cycling over j: round-half-to-even decides every
    code of the ties."""
    na = (1 << a_bits) - 1
    ties = torch.tensor([(j + 0.5) / na for j in range(na)],
                        dtype=torch.float32)
    vals = torch.stack([ties, torch.nextafter(ties, torch.tensor(2.0)),
                        torch.nextafter(ties, torch.tensor(-1.0))])
    reps = -(-m * k // vals.numel())
    return vals.reshape(-1).repeat(reps)[: m * k].reshape(m, k).to(dev)


@pytest.mark.parametrize("a_bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m,k", [(4, 2048), (24, 1408), (576, 2048),
                                 (4, 10944)])
def test_quant_pack_planes_kernel_on_code_ties(cuda, a_bits, m, k):
    x = _tie_rows(m, k, a_bits, cuda)
    got_p, got_t = pack_bits.quant_pack_planes(x, a_bits)
    torch.cuda.synchronize()
    want_p, want_t = pack_bits.quant_pack_planes_plain(x, a_bits)
    assert torch.equal(got_p, want_p) and torch.equal(got_t, want_t)


# K5 / K9 and K6 / K10 tiles: plane pairs, the decode / prefill tiles'
# edges (TILE_CASES: M on both sides of the decode tile's 32 rows and the
# prefill tiles' 64, N off the 16-, 64- and 128-row tiles, Kw ragged against
# the 8-word chunk and the split-K runs), granite's GEMMs at the decode
# batch and the prefill rows (the decode tile's split-K runs and row groups),
# and rows whose planes are all zero, which the kernels skip: their S must
# be exactly 0
KBIT_PAIRS = [(2, 2), (4, 4), (8, 8), (8, 4), (3, 5)]
GRANITE_CASES = [(m, n, kw) for m in (4, 256)
                 for n, kw in ((2048, 64), (512, 64), (8192, 64), (2048, 256))
                 if (m, n, kw) != (4, 2048, 64)]
ZERO_ROWS = ("front", "planes", "slice", "all")
ZERO_SHAPES = [(4, 2048, 64), (24, 1408, 63), (32, 512, 257), (33, 65, 9),
               (256, 1408, 65), (576, 17, 5)]


def _zero_rows(a, zeros):
    """Zero rows of a (..., ka, M, Kw) activation plane stack in place and
    return the (..., M) mask of rows zero in every plane and word (none of
    the random rows when ``zeros`` is None): "front" keeps the first third
    of the rows (the MoE buckets pack an expert's rows at the front, zeros
    behind); "planes" zeroes every other row in the low half of the planes
    only; "slice" every third row in the upper half of its words only;
    "all" every row."""
    m, kw = a.shape[-2:]
    if zeros == "front":
        a[..., (m + 2) // 3:, :] = 0
    elif zeros == "planes":
        a[..., : (a.shape[-3] + 1) // 2, ::2, :] = 0
    elif zeros == "slice":
        a[..., ::3, kw // 2:] = 0
    elif zeros == "all":
        a.zero_()
    return (a == 0).all(dim=-1).all(dim=-2)


@pytest.mark.parametrize("ka,kb", KBIT_PAIRS)
@pytest.mark.parametrize("m,n,kw,zeros",
                         [(1, 1, 1, None), (3, 5, 7, None), (4, 2048, 64, None),
                          (17, 512, 256, None), (33, 65, 9, None)]
                         + [(m, n, kw, None) for m, n, kw in TILE_CASES]
                         + [(m, n, kw, None) for m, n, kw in GRANITE_CASES]
                         + [(m, n, kw, z) for z in ZERO_ROWS
                            for m, n, kw in ZERO_SHAPES])
def test_kbit_gemm_kernels_match_plain(cuda, ka, kb, m, n, kw, zeros):
    a, b = _words((ka, m, kw), 1, cuda), _words((kb, n, kw), 2, cuda)
    zero = _zero_rows(a, zeros)
    got_v, got_m = kbit_gemm.kbit_plane_gemm(a, b), kbit_mxu.kbit_mxu_gemm(a, b)
    torch.cuda.synchronize()
    want = kbit_gemm.kbit_plane_gemm_plain(a, b)
    assert torch.equal(got_v, want)
    assert torch.equal(got_m, want)
    assert torch.equal(kbit_mxu.kbit_mxu_gemm_plain(a, b), want)
    assert not got_v[zero].any() and not got_m[zero].any()


def test_kbit_launch_counts(cuda):
    _cuda.reset_launches()
    x = _acts((2, 70), 0, cuda, 4)
    w = pack_bits.quant_pack_planes(_acts((5, 70), 1, cuda, 4), 4)[0]
    for backend in ("vpu", "mxu", "xla"):
        dispatch.quant_gemm(x, w, k_true=70, w_bits=4, a_bits=4,
                            config=dispatch.GemmConfig(backend=backend))
    dispatch.quant_gemm(x.cpu(), w.cpu(), k_true=70, w_bits=4, a_bits=4)
    assert _cuda.LAUNCHES == {"pack_sign": 0, "xnor_mismatch": 0,
                              "xnor_dot_mxu": 0, "xnor_mismatch_batched": 0,
                              "xnor_dot_mxu_batched": 0,
                              "quant_pack_planes": 3, "kbit_plane_gemm": 1,
                              "kbit_mxu_gemm": 1, "flash_decode": 0,
                              "kbit_plane_gemm_batched": 0,
                              "kbit_mxu_gemm_batched": 0}


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
@pytest.mark.parametrize("w_bits,a_bits", [(4, 4), (8, 8), (4, 8)])
def test_kbit_quant_gemm_cuda_equals_cpu(cuda, backend, w_bits, a_bits):
    """The integer S and T are exact and the dequant is one fp32 op, so
    the card gives the CPU's bits."""
    x = _acts((6, 8192), w_bits, cuda, a_bits)
    w = _floats((40, 8192), a_bits, cuda).nan_to_num(0.0, 3.0, -3.0)
    wp = bitpack.pack_planes(quant.weight_codes(w, w_bits), w_bits)
    cfg = dispatch.GemmConfig(backend=backend)
    got = dispatch.quant_gemm(x, wp, k_true=8192, config=cfg, w_bits=w_bits,
                              a_bits=a_bits)
    want = dispatch.quant_gemm(x.cpu(), wp.cpu(), k_true=8192, config=cfg,
                               w_bits=w_bits, a_bits=a_bits)
    assert torch.equal(got.cpu(), want)


def _bucket_rows(a, seed):
    """Pack each expert's rows at the front of its bucket, as the grouped
    GEMM's ``_bucket_cells`` does: expert x keeps its first g_x rows, g_x
    drawn from the seed with expert 0 empty and the last expert full, and
    the rows behind them are zero planes.  Returns the zero-row mask."""
    e, _, m, _ = a.shape
    g = torch.Generator(device=a.device).manual_seed(seed)
    sizes = torch.randint(0, m + 1, (e,), generator=g, device=a.device)
    sizes[0], sizes[-1] = 0, m
    zero = torch.arange(m, device=a.device)[None, :] >= sizes[:, None]
    a.masked_fill_(zero[:, None, :, None], 0)
    return zero


@pytest.mark.parametrize("ka,kb", KBIT_PAIRS)
@pytest.mark.parametrize("e,m,n,kw,zeros",
                         [(1, 1, 1, 1, None), (3, 5, 33, 7, None),
                          (64, 24, 1408, 64, None), (64, 24, 2048, 44, None),
                          (2, 77, 65, 9, None), (5, 17, 100, 5, None)]
                         + [(2, m, n, kw, None) for m, n, kw in TILE_CASES]
                         + [(e, m, n, kw, "buckets") for e, m, n, kw in (
                             (64, 24, 1408, 64), (64, 24, 2048, 44),
                             (4, 576, 200, 44), (3, 33, 65, 9),
                             (5, 64, 512, 257))]
                         + [(3, m, n, kw, z) for z in ZERO_ROWS
                            for m, n, kw in ZERO_SHAPES[:3]])
def test_batched_kbit_gemm_kernels_match_plain(cuda, e, m, n, kw, zeros, ka,
                                               kb):
    """K9 and K10 against their plain versions, and each other, exactly;
    rows zero in every plane (bucket tails, experts with no row) give S 0."""
    a, b = _words((e, ka, m, kw), 5, cuda), _words((e, kb, n, kw), 6, cuda)
    zero = (_bucket_rows(a, 7) if zeros == "buckets"
            else _zero_rows(a, zeros))
    got_v = kbit_gemm.kbit_plane_gemm_batched(a, b)
    got_m = kbit_mxu.kbit_mxu_gemm_batched(a, b)
    torch.cuda.synchronize()
    want = kbit_gemm.kbit_plane_gemm_batched_plain(a, b)
    assert torch.equal(got_v, want) and torch.equal(got_m, want)
    assert torch.equal(kbit_mxu.kbit_mxu_gemm_batched_plain(a, b), want)
    assert not got_v[zero].any() and not got_m[zero].any()


def _grouped_kbit_operands(dev, w_bits, t=48, k=300, e=8, n=70, stacks=2):
    x = _acts((t, k), 7, dev, 4)
    ws = tuple(bitpack.pack_planes(quant.weight_codes(
        _floats((e, n, k), 8 + i, dev).nan_to_num(0.0, 3.0, -3.0), w_bits),
        w_bits).transpose(0, 1).contiguous() for i in range(stacks))
    gs = torch.tensor([9, 0, 13, 1, 0, 11, 6, 4], device=dev)[:e]
    return x, ws, gs


def test_grouped_kbit_launch_counts(cuda):
    """A grouped w4a4 call runs the prologue once and K9 (``vpu``) or K10
    (``mxu``) once per stack — never the 2-D K5/K6 or the 1-bit kernels —
    and ``xla`` and the CPU launch nothing."""
    x, ws, gs = _grouped_kbit_operands(cuda, 4)
    _cuda.reset_launches()
    for backend in ("vpu", "mxu", "xla"):
        dispatch.quant_gemm_grouped(x, ws, gs, k_true=x.shape[1], w_bits=4,
                                    a_bits=4,
                                    config=dispatch.GemmConfig(backend=backend))
    dispatch.quant_gemm_grouped(x.cpu(), tuple(w.cpu() for w in ws), gs.cpu(),
                                k_true=x.shape[1], w_bits=4, a_bits=4)
    assert _cuda.LAUNCHES == {"pack_sign": 0, "xnor_mismatch": 0,
                              "xnor_dot_mxu": 0, "xnor_mismatch_batched": 0,
                              "xnor_dot_mxu_batched": 0,
                              "quant_pack_planes": 2, "kbit_plane_gemm": 0,
                              "kbit_mxu_gemm": 0, "flash_decode": 0,
                              "kbit_plane_gemm_batched": 2,
                              "kbit_mxu_gemm_batched": 2}


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
@pytest.mark.parametrize("w_bits,a_bits", [(4, 4), (8, 8), (4, 8)])
@pytest.mark.parametrize("stacks", [1, 2])
@pytest.mark.parametrize("capacity", [None, 6, 2])  # full, drops, route-first
def test_quant_gemm_grouped_kbit_cuda_equals_cpu(cuda, backend, w_bits,
                                                 a_bits, stacks, capacity):
    """The integer S and T are exact and the dequant is one fp32 op, so
    the grouped k-bit output on the card has the CPU's bits."""
    x, ws, gs = _grouped_kbit_operands(cuda, w_bits, stacks=stacks)
    x = _acts(tuple(x.shape), 9, cuda, a_bits)
    w = ws if stacks > 1 else ws[0]
    cfg = dispatch.GemmConfig(backend=backend)
    got = dispatch.quant_gemm_grouped(x, w, gs, k_true=x.shape[1], config=cfg,
                                      expert_capacity=capacity, w_bits=w_bits,
                                      a_bits=a_bits)
    want = dispatch.quant_gemm_grouped(
        x.cpu(), tuple(v.cpu() for v in ws) if stacks > 1 else w.cpu(),
        gs.cpu(), k_true=x.shape[1], config=cfg, expert_capacity=capacity,
        w_bits=w_bits, a_bits=a_bits)
    got = got if stacks > 1 else (got,)
    want = want if stacks > 1 else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_smoke_serving_packed_equals_fakequant_on_card(cuda, backend):
    spec = registry.get("granite-3-2b")
    cfg = spec.smoke
    params = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    packed, _ = converter.convert(params, QuantPolicy.binary())
    ctx = QCtx(policy=QuantPolicy.binary(), compute_dtype=torch.float32,
               gemm_config=dispatch.GemmConfig(backend=backend))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 5, 9, 3)]

    def serve(p):
        eng = engine.Engine(spec, cfg, ctx, p, engine.EngineConfig(
            batch=2, cache_len=32, max_new_tokens=6))
        sched = engine.Scheduler(eng)
        for pr in prompts:
            sched.submit(engine.Request(prompt=pr))
        return sched.run()

    _cuda.reset_launches()
    on_card = serve(packed)
    assert _cuda.LAUNCHES["pack_sign"] > 0
    assert _cuda.LAUNCHES[{"vpu": "xnor_mismatch",
                           "mxu": "xnor_dot_mxu"}[backend]] > 0
    fake = serve(params)
    assert sorted(on_card) == sorted(fake) == [0, 1, 2, 3]
    for rid in on_card:
        np.testing.assert_array_equal(on_card[rid], fake[rid])


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen2-72b"])
@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_dense_smoke_serving_on_card(cuda, arch, backend):
    """The dense deepseek-7b / qwen2-72b smoke configs on the card, with
    ``full_attn_max_seq`` lowered so that every prefill takes
    ``_sdpa_chunked``: ``lm.init_packed`` equals the whole model's
    conversion bit for bit, and the packed greedy streams equal
    fake-quant's (§2.2.2), each packed GEMM through its kernel."""
    import dataclasses

    spec = registry.get(arch)
    cfg = spec.smoke
    cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, full_attn_max_seq=4, chunk_q=1, chunk_kv=4))
    policy = QuantPolicy.binary()
    params = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    want, _ = converter.convert(params, policy)
    packed, _, _ = lm.init_packed(torch.Generator(device=cuda).manual_seed(0),
                                  cfg, policy)
    for a, b in zip(tree_leaves(packed), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ctx = QCtx(policy=policy, compute_dtype=torch.float32,
               gemm_config=dispatch.GemmConfig(backend=backend))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 5, 9, 3)]

    def serve(p):
        eng = engine.Engine(spec, cfg, ctx, p, engine.EngineConfig(
            batch=2, cache_len=32, max_new_tokens=6))
        sched = engine.Scheduler(eng)
        for pr in prompts:
            sched.submit(engine.Request(prompt=pr))
        return sched.run()

    _cuda.reset_launches()
    on_card = serve(packed)
    assert _cuda.LAUNCHES["pack_sign"] > 0
    assert _cuda.LAUNCHES[{"vpu": "xnor_mismatch",
                           "mxu": "xnor_dot_mxu"}[backend]] > 0
    fake = serve(params)
    assert sorted(on_card) == sorted(fake) == [0, 1, 2, 3]
    for rid in on_card:
        np.testing.assert_array_equal(on_card[rid], fake[rid])


def test_sdpa_chunked_on_card_matches_cpu(cuda):
    """``_sdpa_chunked`` on the card against the CPU and against ``_sdpa``
    (padded KV, a -1 key, a window; rtol = atol = 1e-5, fp32 attention
    summed in another order)."""
    acfg = attention.AttnConfig(d_model=512, n_heads=8, n_kv_heads=2,
                                d_head=64, window=40, chunk_q=16,
                                chunk_kv=24)
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 64, 2, 4, 64), generator=g)
    k = torch.randn((2, 70, 2, 64), generator=g)
    v = torch.randn((2, 70, 2, 64), generator=g)
    pos = torch.arange(70, dtype=torch.int32).expand(2, 70).clone()
    pos[:, 5] = -1
    q_pos = pos[:, 6:].clone()
    want = attention._sdpa_chunked(acfg, q, k, v, q_pos, pos)
    got = attention._sdpa_chunked(acfg, *(t.to(cuda) for t in
                                          (q, k, v, q_pos, pos)))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    full = attention._sdpa(acfg, *(t.to(cuda) for t in (q, k, v)),
                           attention._mask(acfg, q_pos.to(cuda), pos.to(cuda)))
    torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-5)


def test_smoke_serving_w4a4_vpu_equals_mxu_on_card(cuda):
    """DoReFa w4a4 on the card: ``vpu`` (-> vpu-k4) and ``mxu`` (-> mxu-k4)
    compute the same integer S and the same dequant, so their greedy
    streams are identical; each went through its kernels."""
    spec = registry.get("granite-3-2b")
    cfg = spec.smoke
    policy = QuantPolicy.quantized(4)
    params = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    packed, _ = converter.convert(params, policy)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 5, 9, 3)]
    streams = {}
    for backend, kernel in (("vpu", "kbit_plane_gemm"),
                            ("mxu", "kbit_mxu_gemm")):
        ctx = QCtx(policy=policy, compute_dtype=torch.float32,
                   gemm_config=dispatch.GemmConfig(backend=backend))
        eng = engine.Engine(spec, cfg, ctx, packed, engine.EngineConfig(
            batch=2, cache_len=32, max_new_tokens=6))
        sched = engine.Scheduler(eng)
        for pr in prompts:
            sched.submit(engine.Request(prompt=pr))
        _cuda.reset_launches()
        streams[backend] = sched.run()
        assert _cuda.LAUNCHES["quant_pack_planes"] > 0
        assert _cuda.LAUNCHES[kernel] > 0
        assert _cuda.LAUNCHES["pack_sign"] == 0
    assert sorted(streams["vpu"]) == [0, 1, 2, 3]
    for rid in streams["vpu"]:
        np.testing.assert_array_equal(streams["vpu"][rid], streams["mxu"][rid])


@pytest.mark.parametrize("paged", [False, True])
def test_smoke_spec_serving_on_card_matches_cpu(cuda, paged):
    """Speculative serving of granite smoke (a w1a1 1-layer draft, spec_len
    3; paged: block 8, chunk 4, shared prefixes, fused attention) on the
    card: the greedy streams and the spec counters equal the same run on the
    CPU, the streams equal the card's target-only streams, and K1 / K2 ran
    7 times per packed layer per forward call of target and draft (K11 once
    per target layer per prefill window and verify position on the paged
    run)."""
    spec = registry.get("granite-3-2b")
    cfg = spec.smoke
    cpu_params = lm.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (9,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, (n,)).astype(np.int32)]) for n in (3, 3, 5, 5)]
    extra = (dict(kv_block_size=8, prefill_chunk=4, shared_prefix=True,
                  fused_attn=True) if paged else {})

    def serve(dev, speculative=True):
        params = tree_map(lambda x: x.to(dev), cpu_params)
        packed, _ = converter.convert(params, QuantPolicy.binary())
        ctx = QCtx(policy=QuantPolicy.binary(), compute_dtype=torch.float32,
                   gemm_config=dispatch.GemmConfig(backend="vpu"))
        draft = None
        if speculative:
            dparams, dcfg, _ = converter.derive_draft(params, cfg, n_layers=1)
            draft = engine.DraftModel(cfg=dcfg, params=dparams, ctx=ctx)
        eng = engine.Engine(spec, cfg, ctx, packed, engine.EngineConfig(
            batch=2, cache_len=32, max_new_tokens=6, draft=draft, spec_len=3,
            **extra))
        sched = engine.Scheduler(eng)
        for pr in prompts:
            sched.submit(engine.Request(prompt=pr))
        _cuda.reset_launches()
        return sched.run(), sched.stats

    got, st = serve(cuda)
    t_calls = st.prefills + st.steps
    d_calls = (len(prompts) if paged else st.prefills) + 3 * st.steps
    want = 7 * (cfg.n_layers * t_calls + d_calls)
    assert _cuda.LAUNCHES["pack_sign"] == _cuda.LAUNCHES["xnor_mismatch"] == want
    # the verify attends one window position per call
    assert _cuda.LAUNCHES["flash_decode"] == (
        cfg.n_layers * (st.prefills + 4 * st.steps) if paged else 0)
    ref, _ = serve(cuda, speculative=False)
    on_cpu, cpu_st = serve(torch.device("cpu"))
    assert sorted(got) == sorted(ref) == sorted(on_cpu) == [0, 1, 2, 3]
    for rid in got:
        np.testing.assert_array_equal(got[rid], ref[rid])
        np.testing.assert_array_equal(got[rid], on_cpu[rid])
    assert (st.spec_rounds, st.spec_proposed, st.spec_accepted, st.steps) == (
        cpu_st.spec_rounds, cpu_st.spec_proposed, cpu_st.spec_accepted,
        cpu_st.steps)


def _paged_case(dev, tier, b, c, g, dh, bs=16, bps=7, kvh=2, seed=0,
                lens=None):
    """A shuffled pool holding ragged slots (slot 0 with a -1 entry in the
    middle of its table, the last slot unmapped), stale positions in
    unmapped blocks, and q at each slot's frontier.  ``tier``: "fp32",
    "bf16", 8 or 1.  ``lens``: the slots' lengths (default: slot 0 full,
    the others random)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = b * bps + 3
    table = torch.randperm(nb, generator=gen, device=dev)[:b * bps]
    table = table.view(b, bps).to(torch.int32)
    table[0, bps // 2] = -1
    table[-1] = -1
    if lens is None:
        lens = torch.randint(1, bps * bs, (b,), generator=gen, device=dev)
        lens[0] = bps * bs
    else:
        lens = torch.tensor(lens, device=dev)
    pool_pos = torch.randint(0, bps * bs, (nb, bs), generator=gen,
                             device=dev, dtype=torch.int32)
    p = torch.arange(bps * bs, device=dev, dtype=torch.int32).view(bps, bs)
    for r in range(b):
        for j in range(bps):
            if table[r, j] >= 0:
                pool_pos[table[r, j]] = torch.where(p[j] < lens[r], p[j], -1)

    def storage():
        x = torch.randn((nb, bs, kvh, dh), generator=gen, device=dev)
        if tier in ("fp32", "bf16"):
            return x.to(torch.bfloat16 if tier == "bf16" else torch.float32), None
        return attn_decode.kv_quantize(tier, x)

    pk, ks = storage()
    pv, vs = storage()
    q = torch.randn((b, c, kvh, g, dh), generator=gen, device=dev)
    q_pos = (lens[:, None] - c + torch.arange(c, device=dev)).to(torch.int32)
    return dict(table=table, q=q, q_pos=q_pos, pool_k=pk, pool_v=pv,
                pool_pos=pool_pos, k_scale=ks, v_scale=vs), bs


def _split_keys(dev, b, kvh, c, g, span):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return attn_decode.split_plan(b * kvh, c * g, span, sms)[1]


def _case_lens(dev, kind, b, c, g, bs, bps, kvh=2):
    """None (random), "short" (slots far shorter than a 128-entry table, so
    most split ranges hold no key) or "edges" (lengths on split-range
    edges of the kernel's plan, and one key either side)."""
    if kind == "short":
        return [37, 70, 5, 0][:b]
    if kind == "edges":
        k = _split_keys(dev, b, kvh, c, g, bs * bps)
        return [k, 2 * k + 1, 3 * k - 1, 0][:b]
    return None


def _visible_rows(inp, b, window):
    kpos = torch.where(inp["table"][:, :, None] >= 0,
                       inp["pool_pos"][inp["table"].clamp(min=0).long()], -1)
    kp, qp = kpos.view(b, 1, -1), inp["q_pos"][:, :, None]
    vis = (kp >= 0) & (kp <= qp)
    if window is not None:
        vis &= kp > qp - window
    return vis.any(-1)


# C*G on both sides of the tile switch (16: decode tile; 20, 148: window
# tile), Dh 64 / 128 on both tiles, block 4 (a 32-key split range spans 8
# table entries), a 128-entry table with short ragged slots, and lengths on
# the split ranges' edges
@pytest.mark.parametrize("tier", ["fp32", "bf16", 8, 1])
@pytest.mark.parametrize("c,g,dh,bs,bps,lens", [
    (1, 4, 64, 16, 7, None), (4, 1, 128, 16, 7, None),
    (37, 4, 64, 16, 7, None), (4, 4, 64, 4, 13, None),
    (5, 4, 64, 16, 7, None), (1, 4, 128, 16, 7, None),
    (37, 4, 128, 16, 7, None), (1, 4, 64, 16, 128, "short"),
    (1, 4, 64, 16, 128, "edges"), (5, 4, 64, 16, 128, "short"),
])
@pytest.mark.parametrize("cap,window", [(None, None), (30.0, 40)])
def test_flash_decode_kernel_matches_plain(cuda, tier, c, g, dh, bs, bps, lens,
                                           cap, window):
    """K11 against its plain version on the card: rows that see a key
    within atol 2e-5 (unit-scale inputs; the bf16 pool too, whose values
    both sides read exactly in fp32), the unmapped slot exact zeros."""
    b = 4 if lens else 3
    inp, bs = _paged_case(cuda, tier, b, c, g, dh, bs=bs, bps=bps,
                          seed=c + dh,
                          lens=_case_lens(cuda, lens, b, c, g, bs, bps))
    kv_bits = tier if isinstance(tier, int) else None
    opts = dict(block_size=bs, kv_bits=kv_bits, sm_scale=dh ** -0.5,
                logit_softcap=cap, window=window)
    got = attn_decode.flash_decode_paged(**inp, **opts)
    torch.cuda.synchronize()
    want = attn_decode.flash_decode_paged_plain(
        **inp, **{k: v for k, v in opts.items() if k != "block_size"})
    vis = _visible_rows(inp, b, window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[vis], want[vis], rtol=0, atol=2e-5)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))


@pytest.mark.parametrize("tier", ["fp32", 8, 1])
@pytest.mark.parametrize("c,bps", [(1, 128), (1, 7), (64, 40)])
def test_flash_decode_repeats_bit_for_bit(cuda, tier, c, bps):
    """Two calls on the same inputs give the same bits: the decode tile's
    split partials (many ranges at 128 entries, one at 7) merge in split
    order and the window tile sums in a fixed order; no float atomics."""
    inp, bs = _paged_case(cuda, tier, 4, c, 4, 64, bps=bps, kvh=8, seed=5)
    opts = dict(block_size=bs, kv_bits=tier if isinstance(tier, int) else None,
                sm_scale=0.125, logit_softcap=30.0)
    first = attn_decode.flash_decode_paged(**inp, **opts)
    second = attn_decode.flash_decode_paged(**inp, **opts)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    vis = _visible_rows(inp, 4, None)
    want = attn_decode.flash_decode_paged_plain(
        **inp, **{k: v for k, v in opts.items() if k != "block_size"})
    torch.testing.assert_close(first[vis], want[vis], rtol=0, atol=2e-5)


@pytest.mark.parametrize("tier", ["fp32", 8, 1])
@pytest.mark.parametrize("cache_len", [1536, 2048])
def test_flash_decode_contig_and_launch_count(cuda, tier, cache_len):
    """The contiguous route reaches the same kernel through an identity
    table of 512-row blocks (3 or 4 entries), and each call counts one
    launch."""
    kv_bits = tier if isinstance(tier, int) else None
    kv = attention.ContiguousKVCache(kv_bits=kv_bits)
    cfg = attention.AttnConfig(d_model=256, n_heads=8, n_kv_heads=2,
                               d_head=64, fused_attn=True, kv_bits=kv_bits)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cache = kv.init(2, cfg, cache_len, torch.float32, cuda)
    k = torch.randn((2, 1000, 2, 64), generator=gen, device=cuda)
    v = torch.randn((2, 1000, 2, 64), generator=gen, device=cuda)
    pos = torch.arange(1000, device=cuda, dtype=torch.int32).expand(2, 1000)
    kv.fill(cache, k, v, pos)
    q = torch.randn((2, 1, 2, 4, 64), generator=gen, device=cuda)
    q_pos = torch.tensor([[999], [500]], dtype=torch.int32, device=cuda)
    _cuda.reset_launches()
    got = kv.attend(cache, q, q_pos, cfg)
    assert _cuda.LAUNCHES["flash_decode"] == 1
    kk, vv, kpos = kv.gather(cache)
    want = attention._sdpa(cfg, q, kk, vv, attention._mask(cfg, q_pos, kpos))
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_moe_smoke_serving_packed_equals_fakequant_on_card(cuda, backend):
    """deepseek-moe smoke on the card: packed greedy streams equal
    fake-quant's, a second packed run repeats the first (stable sort,
    fixed-order combine), one slot at a time gives the same streams, and
    the grouped GEMMs ran on K7 / K8 only."""
    spec = registry.get("deepseek-moe-16b")
    cfg = spec.smoke
    params = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    packed, _ = converter.convert(params, QuantPolicy.binary())
    ctx = QCtx(policy=QuantPolicy.binary(), compute_dtype=torch.float32,
               gemm_config=dispatch.GemmConfig(backend=backend))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 5, 9, 3, 9, 4)]

    def serve(p, batch=2):
        eng = engine.Engine(spec, cfg, ctx, p, engine.EngineConfig(
            batch=batch, cache_len=32, max_new_tokens=6))
        sched = engine.Scheduler(eng)
        for pr in prompts:
            sched.submit(engine.Request(prompt=pr))
        return sched.run()

    _cuda.reset_launches()
    first = serve(packed)
    names = {"vpu": "xnor_mismatch_batched", "mxu": "xnor_dot_mxu_batched"}
    other = names["mxu" if backend == "vpu" else "vpu"]
    assert _cuda.LAUNCHES[names[backend]] > 0 and _cuda.LAUNCHES[other] == 0
    assert _cuda.LAUNCHES["pack_sign"] > 0
    runs = [serve(packed), serve(params), serve(packed, batch=1)]
    for got in runs:
        assert sorted(got) == sorted(first) == list(range(len(prompts)))
        for rid in first:
            np.testing.assert_array_equal(got[rid], first[rid])


def test_moe_smoke_serving_w4a4_vpu_equals_mxu_on_card(cuda):
    """deepseek-moe smoke at w4a4 on the card: ``vpu-k4`` and ``mxu-k4``
    give identical greedy streams (the same integer S), a repeat run
    repeats, and the grouped GEMMs ran on K9 / K10 only."""
    spec = registry.get("deepseek-moe-16b")
    cfg = spec.smoke
    policy = QuantPolicy.quantized(4)
    params = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    packed, _ = converter.convert(params, policy)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 5, 9, 3, 9, 4)]
    names = {"vpu": "kbit_plane_gemm_batched", "mxu": "kbit_mxu_gemm_batched"}
    streams = []
    for backend in ("vpu", "mxu", "vpu"):
        ctx = QCtx(policy=policy, compute_dtype=torch.float32,
                   gemm_config=dispatch.GemmConfig(backend=backend))
        eng = engine.Engine(spec, cfg, ctx, packed, engine.EngineConfig(
            batch=2, cache_len=32, max_new_tokens=6))
        sched = engine.Scheduler(eng)
        for pr in prompts:
            sched.submit(engine.Request(prompt=pr))
        _cuda.reset_launches()
        streams.append(sched.run())
        other = names["mxu" if backend == "vpu" else "vpu"]
        assert _cuda.LAUNCHES[names[backend]] > 0
        assert _cuda.LAUNCHES[other] == 0
        assert _cuda.LAUNCHES["quant_pack_planes"] > 0
        assert _cuda.LAUNCHES["xnor_mismatch_batched"] == 0
        assert _cuda.LAUNCHES["xnor_dot_mxu_batched"] == 0
    for got in streams[1:]:
        assert sorted(got) == sorted(streams[0]) == list(range(len(prompts)))
        for rid in got:
            np.testing.assert_array_equal(got[rid], streams[0][rid])


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_smoke_train_step_card_matches_cpu(cuda, remat):
    """One quickstart step of granite smoke (binary, fp32) on the card and
    on the CPU from the same init and batch.  Loss within rtol 2e-6, grad
    norm 1e-5, moments within 2e-5 of each leaf's largest |m| / |v|, and
    the new params within 1e-3 * lr wherever |m| is above 1e-3 of its
    leaf's largest, within 2 * lr everywhere (AdamW's first step moves a
    weight by about lr * sign(g); tests/test_torch_train.py's docstring
    derives these gates against JAX)."""
    spec = registry.get("granite-3-2b")
    cfg = spec.smoke
    host, _ = trainer.init_all(spec, cfg, torch.Generator().manual_seed(3))
    batch = synthetic.batch_at(synthetic.DataConfig(cfg.vocab_size, 32, 16), 0)
    step = trainer.make_train_step(
        spec, cfg, QCtx(policy=QuantPolicy.binary(),
                        compute_dtype=torch.float32),
        quickstart.OPT, remat=remat,
        bit_flip_metrics_on=True)
    out = []
    for dev in ("cpu", cuda):
        params = tree_map(lambda x: x.to(dev, copy=True), host)
        out.append(step(params, adamw.init(params), batch))
    (cp, co, cm), (gp, go, gm) = out
    np.testing.assert_allclose(gm["loss"].item(), cm["loss"].item(), rtol=2e-6)
    np.testing.assert_allclose(gm["grad_norm"].item(),
                               cm["grad_norm"].item(), rtol=1e-5)
    assert gm["lr"].item() == cm["lr"].item()
    lr = cm["lr"].item()
    for g, c, m in zip(tree_leaves(gp), tree_leaves(cp), tree_leaves(co["m"])):
        d = (g.cpu().double() - c.double()).abs()
        big = m.abs() > 1e-3 * m.abs().max()
        assert d.max() <= 2 * lr
        assert not big.any() or d[big].max() <= 1e-3 * lr
    for k in ("m", "v"):
        for g, c in zip(tree_leaves(go[k]), tree_leaves(co[k])):
            assert (g.cpu() - c).abs().max() <= 2e-5 * c.abs().max()
    assert go["step"].item() == 1


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_trained_smoke_model_packed_equals_fakequant_on_card(cuda, backend):
    """The quickstart's 120 steps on the card, then the trained model packed
    on K1 + K2 (``vpu``) or K1 + K3 (``mxu``) gives the fake-quant greedy
    streams exactly (§2.2.2 on trained weights)."""
    spec = registry.get("granite-3-2b")
    params, opt_state = trainer.init_all(
        spec, spec.smoke, torch.Generator(device=cuda).manual_seed(0))
    losses = []
    params, _ = quickstart.train(params, opt_state, on_step=lambda i, p, m:
                                 losses.append(m["loss"].item()))
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < 0.6 * losses[0]
    packed, _ = converter.convert(params, QuantPolicy.binary())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, spec.smoke.vocab_size, (n,)).astype(np.int32)
               for n in (8, 8, 5, 12)]
    streams = {}
    for label, p in (("packed", packed), ("fake-quant", params)):
        ctx = QCtx(policy=QuantPolicy.binary(), compute_dtype=torch.float32,
                   gemm_config=dispatch.GemmConfig(backend=backend))
        sched = engine.Scheduler(engine.Engine(
            spec, spec.smoke, ctx, p, engine.EngineConfig(
                batch=2, cache_len=64, max_new_tokens=12)))
        for pr in prompts:
            sched.submit(engine.Request(prompt=pr))
        _cuda.reset_launches()
        streams[label] = sched.run()
        if label == "packed":
            gemm = "xnor_mismatch" if backend == "vpu" else "xnor_dot_mxu"
            assert _cuda.LAUNCHES["pack_sign"] > 0
            assert _cuda.LAUNCHES[gemm] > 0
        else:
            assert not any(_cuda.LAUNCHES.values())
    assert sorted(streams["packed"]) == list(range(len(prompts)))
    for rid, toks in streams["fake-quant"].items():
        np.testing.assert_array_equal(streams["packed"][rid], toks)


@pytest.mark.parametrize("arch", ["lenet-mnist", "resnet18-cifar10"])
def test_cnn_smoke_packed_equals_fakequant_on_card(cuda, arch):
    """The paper's CNNs at smoke width on the card (conv GEMMs with K 72,
    144 and 200, tails that are not a multiple of 32): 1-bit packed ``vpu``
    (K1 + K2) and ``mxu`` (K1 + K3) logits equal fake-quant bit for bit;
    w4a4 packed ``vpu-k4`` (K4 + K5) equals ``mxu-k4`` (K4 + K6) bit for
    bit.  Each packed forward launches its prologue and its GEMM once per
    binarized layer."""
    from repro_torch.models import cnn

    spec = registry.get(arch)
    cfg = spec.smoke
    init, forward = ((cnn.lenet_init, cnn.lenet_forward)
                     if arch == "lenet-mnist"
                     else (cnn.resnet18_init, cnn.resnet18_forward))
    params = init(torch.Generator(device=cuda).manual_seed(0), cfg)
    x = torch.randn((16, cfg.in_hw, cfg.in_hw, cfg.in_c),
                    generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    for policy, kernels in (
            (QuantPolicy.binary(), {"vpu": ("pack_sign", "xnor_mismatch"),
                                    "mxu": ("pack_sign", "xnor_dot_mxu")}),
            (QuantPolicy.quantized(4),
             {"vpu": ("quant_pack_planes", "kbit_plane_gemm"),
              "mxu": ("quant_pack_planes", "kbit_mxu_gemm")})):
        packed, report = converter.convert(params, policy)
        out = {}
        for backend, names in kernels.items():
            ctx = QCtx(policy=policy, compute_dtype=torch.float32,
                       gemm_config=dispatch.GemmConfig(backend=backend))
            _cuda.reset_launches()
            out[backend] = forward(packed, cfg, ctx, x)
            torch.cuda.synchronize()
            assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
                k: report.n_packed for k in names}
        assert torch.equal(out["vpu"], out["mxu"])
        if policy.w_bits == 1:
            _cuda.reset_launches()
            fake = forward(params, cfg, QCtx(policy=policy,
                                             compute_dtype=torch.float32), x)
            assert not any(_cuda.LAUNCHES.values())
            assert torch.equal(out["vpu"], fake)
