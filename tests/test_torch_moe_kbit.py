"""PyTorch port vs the JAX package on the packed DoReFa k-bit MoE path: the
expert-batched k-bit kernels' plain versions (K9, K10) against the TPU
kernels, the grouped k-bit GEMM (prologue buckets, code sums, raw S and the
dequantized output), the converter's expert plane stacks, ``moe_apply``,
the model's logits and the scheduler's greedy streams on the
deepseek-moe-16b and qwen2-moe-a2.7b smoke configs.  Inputs are made with
numpy and handed to both packages; JAX's Pallas kernels run in interpret
mode, as the JAX package's own tests run them.

Tolerances: integer outputs (plane buckets, code sums T, S, packed words)
are bit-identical.  The grouped ``vpu`` / ``mxu`` output is the dense
path's dequant, ``(2S - Nw*T) * fp32(1/(Na*Nw))``, one fp32 operation in
both packages, and is asserted bit-identical too; the ``xla`` backend is a
float32 ``ragged_dot`` of the dequantized values whose summation order
belongs to each library, held within ``rtol=atol=2e-6`` (the k-bit
epilogue bound of ROADMAP C).  ``moe_apply`` and the model agree to rtol =
atol = 1e-4, as in tests/test_torch_moe.py; greedy streams are identical.
Denormals are flushed and one thread computes, as in tests/test_torch_lm.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro.core import converter as jconverter
from repro.core import quant as jquant
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.kernels import dispatch as jdispatch
from repro.kernels.dispatch import GemmConfig as JGemmConfig
from repro.kernels.kbit_gemm import kbit_plane_gemm_batched_pallas
from repro.kernels.kbit_mxu import kbit_mxu_gemm_batched_pallas
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.nn import mlp as jmlp
from repro.nn.common import QCtx as JQCtx
from repro.serve import engine as jengine
from repro_torch.core import bitpack, converter
from repro_torch.core.policy import QuantPolicy
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch, kbit_gemm, kbit_mxu
from repro_torch.kernels.dispatch import GemmConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm, registry
from repro_torch.nn import mlp
from repro_torch.nn.common import QCtx
from repro_torch.serve import engine

TOL = dict(rtol=1e-4, atol=1e-4)
EPI_TOL = dict(rtol=2e-6, atol=2e-6)  # ROADMAP C: the k-bit epilogue bound
ARCHS = ("deepseek-moe-16b", "qwen2-moe-a2.7b")
PLANE_PAIRS = ((4, 4), (8, 8), (8, 4))  # (ka, kb)
WIDTHS = ((4, 4), (8, 8), (4, 8))  # (w_bits, a_bits)


@pytest.fixture(autouse=True)
def flush_denormals():
    """Match XLA's CPU denormal flush for one test, on the calling thread
    alone (tests/test_torch_lm.py says why)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _i32(words) -> np.ndarray:
    return np.asarray(words).view(np.int32)


def _ctxs(backend: str, w_bits: int = 4, a_bits: int = 4):
    return (JQCtx(policy=JQuantPolicy.quantized(w_bits, a_bits),
                  compute_dtype=jnp.float32,
                  gemm_config=JGemmConfig(backend=backend)),
            QCtx(policy=QuantPolicy.quantized(w_bits, a_bits),
                 compute_dtype=torch.float32,
                 gemm_config=GemmConfig(backend=backend)))


@pytest.fixture(scope="module")
def smoke_params():
    """{arch: (numpy float params, numpy w4a4 packed params)} from the JAX
    package's init and converter."""
    out = {}
    for i, arch in enumerate(ARCHS):
        host = _host(jlm.init(jax.random.PRNGKey(20 + i),
                              jregistry.get(arch).smoke))
        packed, _ = jconverter.convert(host, JQuantPolicy.quantized(4))
        out[arch] = (host, _host(packed))
    return out


# --------------------------------------------------------------------------
# K9 / K10 plain versions
# --------------------------------------------------------------------------


def _plane_words(rng, shape):
    u = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    return u, torch.from_numpy(u.view(np.int32).copy())


def _pad_to(u, axis, mult):
    pad = [(0, 0)] * u.ndim
    pad[axis] = (0, -u.shape[axis] % mult)
    return np.pad(u, pad)


@pytest.mark.parametrize("ka,kb", PLANE_PAIRS)
@pytest.mark.parametrize("e,m,n,kw", [
    (2, 8, 16, 4),  # block multiples
    (3, 5, 9, 3),  # ragged M, N and Kw
    (1, 1, 33, 1),
    (4, 13, 8, 5),
])
def test_batched_kbit_plain_kernels_match_jax(e, m, n, kw, ka, kb):
    """K9's and K10's plain versions against the JAX batched Pallas kernels
    (interpret mode, blocks of 8 x 8 x 2 words) on random words over the
    full 32-bit range, bit for bit; ragged shapes are zero-padded to the
    blocks for JAX (zero words add nothing to S).  Both also equal the 2-D
    plain versions expert by expert."""
    rng = np.random.default_rng(e * 1000 + m * 10 + kw + ka * kb)
    au, at = _plane_words(rng, (e, ka, m, kw))
    bu, bt = _plane_words(rng, (e, kb, n, kw))
    ja = jnp.asarray(_pad_to(_pad_to(au, 2, 8), 3, 2))
    jb = jnp.asarray(_pad_to(_pad_to(bu, 2, 8), 3, 2))
    blocks = dict(bm=8, bn=8, bkw=2, interpret=True)
    want_v = np.asarray(kbit_plane_gemm_batched_pallas(
        ja, jb, chunk_words=2, **blocks))[:, :m, :n]
    want_m = np.asarray(kbit_mxu_gemm_batched_pallas(ja, jb,
                                                     **blocks))[:, :m, :n]
    got_v = kbit_gemm.kbit_plane_gemm_batched(at, bt)
    got_m = kbit_mxu.kbit_mxu_gemm_batched(at, bt)
    assert got_v.dtype == got_m.dtype == torch.int32
    assert got_v.shape == got_m.shape == (e, m, n)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    for x in range(e):
        want = kbit_gemm.kbit_plane_gemm_plain(at[x], bt[x])
        assert torch.equal(got_v[x], want)
        assert torch.equal(kbit_mxu.kbit_mxu_gemm_plain(at[x], bt[x]), want)


@pytest.mark.parametrize("kernel", ["vpu", "mxu"])
@pytest.mark.parametrize("ka,kb", PLANE_PAIRS)
@pytest.mark.parametrize("sizes,k,ec", [([3, 0, 8, 1], 70, 8),
                                        ([0, 5, 0, 2], 128, 8),
                                        ([1, 0], 33, 8),
                                        ([5, 0, 9, 1], 70, 2)])
def test_batched_kbit_plain_zero_bucket_rows_match_jax(sizes, k, ec, ka, kb,
                                                       kernel):
    """Front-packed buckets as the grouped k-bit GEMM builds them
    (``_bucket_cells`` + ``_pack_plane_buckets``): each expert's rows first,
    zero planes behind them, experts with no row all zero; one row also
    zeroed in its low planes only and one in its upper words only.  At
    capacity 2 the bucket total is below the row count, so the prologue
    routes first: slack cells are -1.0 floats, code 0, and must be zero in
    every plane.  K9's (``vpu``) or K10's (``mxu``) plain version equals
    the JAX batched kernel (interpret mode) bit for bit, and S is exactly 0
    on every row that is zero in all planes, the rows the CUDA kernels
    skip."""
    rng = np.random.default_rng(sum(sizes) * k + ka * kb + ec)
    e, n = len(sizes), 16
    x = torch.from_numpy(rng.uniform(0.05, 1.5, (sum(sizes), k)).astype(
        np.float32))
    gs = torch.tensor(sizes)
    dest, cell, _ = dispatch._bucket_cells(gs, x.shape[0], ec)
    a, _ = dispatch._pack_plane_buckets(x, ka, dest, cell, e, ec, False)
    assert (e * ec < x.shape[0]) == (ec == 2)  # route-first at capacity 2
    live = [(x_, r) for x_, g in enumerate(sizes) for r in range(min(g, ec))]
    a[live[0][0], : ka // 2, live[0][1]] = 0  # zero in some planes only
    a[live[-1][0], :, live[-1][1], a.shape[-1] // 2:] = 0  # in one Kw slice
    bu, bt = _plane_words(rng, (e, kb, n, a.shape[-1]))
    ja = jnp.asarray(_pad_to(_pad_to(a.numpy().view(np.uint32), 2, 8), 3, 2))
    jb = jnp.asarray(_pad_to(bu, 3, 2))
    blocks = dict(bm=8, bn=8, bkw=2, interpret=True)
    if kernel == "vpu":
        want = kbit_plane_gemm_batched_pallas(ja, jb, chunk_words=2, **blocks)
        got = kbit_gemm.kbit_plane_gemm_batched(a, bt)
    else:
        want = kbit_mxu_gemm_batched_pallas(ja, jb, **blocks)
        got = kbit_mxu.kbit_mxu_gemm_batched(a, bt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :ec])
    zero = (a == 0).all(dim=-1).all(dim=1)  # (E, ec): rows zero in all planes
    assert int(zero.sum()) == e * ec - len(live)
    assert not got[zero].any()
    assert got[~zero].any()


def test_batched_kbit_operand_checks():
    a = torch.zeros((2, 4, 3, 5), dtype=torch.int32)
    for fn in (kbit_gemm.kbit_plane_gemm_batched,
               kbit_mxu.kbit_mxu_gemm_batched):
        with pytest.raises(ValueError, match="expert counts differ"):
            fn(a, torch.zeros((3, 4, 6, 5), dtype=torch.int32))
        with pytest.raises(ValueError, match="Kw mismatch"):
            fn(a, torch.zeros((2, 4, 6, 4), dtype=torch.int32))
        with pytest.raises(ValueError, match="1..8 planes"):
            fn(a, torch.zeros((2, 9, 6, 5), dtype=torch.int32))
        with pytest.raises(ValueError, match="4 dims"):
            fn(a[0], torch.zeros((4, 6, 5), dtype=torch.int32))
        with pytest.raises(TypeError):
            fn(a.long(), a.long())
        assert fn(a[:, :, :0], a).shape == (2, 0, 3)


# --------------------------------------------------------------------------
# the grouped k-bit GEMM
# --------------------------------------------------------------------------


GROUPED_CASES = {  # name: (T, K, E, N, group sizes, expert_capacity, stacks)
    "ragged-empty-short": (23, 45, 4, 13, [5, 0, 11, 4], None, 1),
    "tuple": (17, 40, 3, 9, [6, 7, 4], None, 2),
    "capacity-drops": (12, 33, 3, 5, [8, 2, 2], 4, 1),
    "capacity-route-first": (30, 70, 3, 7, [9, 0, 14], 3, 2),
}


def _routing(gs, t, ec):
    """JAX's row -> (group, position, validity) arithmetic, in numpy."""
    ends = np.cumsum(gs)
    starts = ends - gs
    row = np.arange(t)
    g = np.searchsorted(ends, row, side="right")
    g_safe = np.minimum(g, len(gs) - 1)
    pos = row - starts[g_safe]
    return g, g_safe, pos, (g < len(gs)) & (pos < ec)


def _grouped_inputs(case, w_bits, a_bits):
    t, k, e, n, gs, cap, n_stacks = GROUPED_CASES[case]
    rng = np.random.default_rng(t * k + e + 10 * w_bits + a_bits)
    na = (1 << a_bits) - 1
    x = rng.uniform(-0.5, 1.5, (t, k)).astype(np.float32)
    x[0, :na] = [(j + 0.5) / na for j in range(na)][:k]  # rounding ties
    x[1, :4] = (-0.0, 0.0, 1.0, 7.0)
    ws = [rng.standard_normal((e, n, k)).astype(np.float32)
          for _ in range(n_stacks)]
    jw = tuple(jnp.moveaxis(jbitpack.pack_planes(
        jquant.weight_codes(jnp.asarray(w), w_bits), w_bits), 0, 1)
        for w in ws)
    tw = tuple(torch.from_numpy(_i32(w).copy()) for w in jw)
    return x, jw, tw, np.asarray(gs, np.int32), cap


@pytest.mark.parametrize("case", GROUPED_CASES)
@pytest.mark.parametrize("w_bits,a_bits", WIDTHS)
@pytest.mark.parametrize("backend", ["vpu", "mxu", "xla"])
def test_quant_gemm_grouped_kbit_matches_jax(backend, w_bits, a_bits, case):
    """The whole grouped k-bit call against JAX's: one stack and the up +
    gate tuple, full capacity with an empty expert and rows past the group
    sizes, capacity drops, and a tight capacity that routes the float rows
    first.  ``vpu`` / ``mxu`` outputs are bit-identical; ``xla`` within
    the epilogue bound.  Rows past a bucket's capacity are zeros."""
    x, jw, tw, gs, cap = _grouped_inputs(case, w_bits, a_bits)
    t, n = x.shape[0], jw[0].shape[2]
    single = len(jw) == 1
    want = jdispatch.quant_gemm_grouped(
        jnp.asarray(x), jw[0] if single else jw, jnp.asarray(gs),
        k_true=x.shape[1], config=JGemmConfig(backend=backend),
        expert_capacity=cap, w_bits=w_bits, a_bits=a_bits)
    for fused in (True, False):
        got = dispatch.quant_gemm_grouped(
            torch.from_numpy(x), tw[0] if single else tw, torch.from_numpy(gs),
            k_true=x.shape[1],
            config=GemmConfig(backend=backend, fused_prologue=fused),
            expert_capacity=cap, w_bits=w_bits, a_bits=a_bits)
        got = (got,) if single else got
        wants = (want,) if single else want
        assert len(got) == len(wants) == len(jw)
        for a, b in zip(got, wants):
            assert a.dtype == torch.float32 and a.shape == (t, n)
            if backend == "xla":
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **EPI_TOL)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if cap is not None:
        starts = np.cumsum([0] + list(gs[:-1]))
        for s, size in zip(starts, gs):
            assert not got[0][s + cap:s + size].any()


@pytest.mark.parametrize("case", GROUPED_CASES)
@pytest.mark.parametrize("w_bits,a_bits", WIDTHS)
def test_grouped_kbit_buckets_sums_and_s_match_jax(w_bits, a_bits, case):
    """The grouped k-bit arm's integer stages against JAX's: the plane
    buckets and per-row code sums of the prologue (both branches), then the
    raw S of every stack on ``vpu-kN`` (K9) and ``mxu-kN`` (K10), bit for
    bit; the buckets are contiguous for the kernels."""
    x, jw, tw, gs, cap = _grouped_inputs(case, w_bits, a_bits)
    t, k = x.shape
    e = len(gs)
    ec = cap or t
    g, g_safe, pos, valid = _routing(gs, t, ec)
    jcfg = JGemmConfig(backend="vpu", interpret=True)
    jb, jt = jdispatch._pack_plane_buckets(
        jnp.asarray(x), a_bits, jnp.asarray(g, jnp.int32),
        jnp.asarray(g_safe, jnp.int32), jnp.asarray(pos, jnp.int32), e, ec,
        jcfg)
    dest, cell, tvalid = dispatch._bucket_cells(
        torch.from_numpy(gs).long(), t, ec)
    np.testing.assert_array_equal(tvalid.numpy(), valid)
    np.testing.assert_array_equal(
        cell.numpy(), g_safe * ec + np.minimum(pos, ec - 1))
    tb, tt = dispatch._pack_plane_buckets(torch.from_numpy(x), a_bits, dest,
                                          cell, e, ec, True)
    assert tb.is_contiguous() and tb.shape == (e, a_bits, ec,
                                               bitpack.packed_width(k))
    np.testing.assert_array_equal(tb.numpy(), _i32(jb))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    name = f"vpu-k{w_bits}"
    tiles = jcfg.tiles(ec, jw[0].shape[2], tb.shape[-1], backend=name)
    for jwi, twi in zip(jw, tw):
        want = np.asarray(jdispatch.get_backend(name).gemm_kbit_grouped(
            jb, jwi, tiles, jcfg))
        for fam in ("vpu", "mxu"):
            s = dispatch.get_backend(f"{fam}-k{w_bits}").gemm_kbit_grouped(
                tb, twi)
            np.testing.assert_array_equal(s.numpy(), want)


def test_grouped_kbit_refusals():
    x = torch.zeros((5, 70))
    gs = torch.tensor([3, 2])
    planes = torch.zeros((2, 4, 6, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="mixed 1-bit/k-bit"):
        dispatch.quant_gemm_grouped(x, planes, gs, k_true=70, w_bits=4,
                                    a_bits=1)
    with pytest.raises(ValueError, match=r"\(E, 4, N, Kw\)"):
        dispatch.quant_gemm_grouped(x, planes[:, 0], gs, k_true=70,
                                    w_bits=4, a_bits=4)
    with pytest.raises(ValueError, match=r"\(E, 8, N, Kw\)"):
        dispatch.quant_gemm_grouped(x, planes, gs, k_true=70, w_bits=8,
                                    a_bits=8)
    kw = 520  # 2*K*255*255 >= 2^31 at K = 16640
    big = torch.zeros((2, 8, 6, kw), dtype=torch.int32)
    for family in ("vpu", "mxu"):
        with pytest.raises(ValueError, match="overflows its int32"):
            dispatch.quant_gemm_grouped(
                torch.zeros((5, kw * 32)), big, gs, k_true=kw * 32, w_bits=8,
                a_bits=8, config=GemmConfig(backend=family))


# --------------------------------------------------------------------------
# converter and interop
# --------------------------------------------------------------------------


@pytest.mark.parametrize("w_bits,a_bits", [(4, 4), (4, 8)])
@pytest.mark.parametrize("arch", ARCHS)
def test_converter_kbit_expert_stacks_match_jax(arch, w_bits, a_bits,
                                                smoke_params):
    """Every packed leaf, the expert plane stacks among them, equals JAX's
    bit for bit (codes over the whole stack), and so do the size reports."""
    host, _ = smoke_params[arch]
    policy = QuantPolicy.quantized(w_bits, a_bits)
    packed, report = converter.convert(params_from_numpy(host, "cpu"), policy)
    jpacked, jreport = jconverter.convert(
        host, JQuantPolicy.quantized(w_bits, a_bits))
    jleaves = jax.tree_util.tree_leaves_with_path(_host(jpacked))
    tleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda x: x.numpy(), packed))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    n_stacks = 0
    for (path, want), (_, got) in zip(jleaves, tleaves):
        if want.dtype == np.uint32:
            np.testing.assert_array_equal(got, want.view(np.int32))
            n_stacks += "experts" in jax.tree_util.keystr(path)
        else:
            np.testing.assert_array_equal(got, want)
    cfg = registry.get(arch).smoke
    moe_layers = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.n_layers))
    assert n_stacks == 3 * moe_layers
    experts = packed["layers"][cfg.n_layers - 1]["moe"]["experts"]
    assert experts["up_packed"].shape == (
        cfg.moe.e, w_bits, cfg.moe.d_expert, bitpack.packed_width(cfg.d_model))
    assert experts["down_packed"].is_contiguous()
    assert (report.bytes_fp32, report.bytes_after, report.n_packed) == (
        jreport.bytes_fp32, jreport.bytes_after, jreport.n_packed)


def test_kbit_expert_codes_span_the_whole_stack():
    """The codes come from one tanh-max over all experts: a stack whose
    experts differ in scale packs like the fake-quant quantizer, not like
    per-expert packing."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 40, 12)).astype(np.float32)
    w[0] *= 0.1  # a quiet expert: its codes use only the middle range
    packed, _ = converter.convert({"layers": [{"moe": {"experts": {
        "up": torch.from_numpy(w)}}}]}, QuantPolicy.quantized(4))
    planes = packed["layers"][0]["moe"]["experts"]["up_packed"]
    codes = bitpack.unpack_planes(planes.movedim(1, 0), 40)  # (E, 12, 40)
    want = np.asarray(jquant.weight_codes(
        jnp.asarray(np.transpose(w, (0, 2, 1))), 4))
    np.testing.assert_array_equal(codes.numpy(), want)
    assert codes[0].max() - codes[0].min() < 15


def test_interop_carries_kbit_expert_stacks_as_int32_views(smoke_params):
    _, jpacked = smoke_params["deepseek-moe-16b"]
    experts = jpacked["layers"][1]["moe"]["experts"]
    got = params_from_numpy(experts, "cpu")
    assert sorted(got) == ["down_packed", "gate_packed", "up_packed"]
    for name, words in experts.items():
        assert words.ndim == 4 and words.dtype == np.uint32
        assert words.shape[1] == 4
        assert got[name].dtype == torch.int32 and got[name].is_contiguous()
        np.testing.assert_array_equal(got[name].numpy(), words.view(np.int32))


# --------------------------------------------------------------------------
# moe_apply, the model and the scheduler
# --------------------------------------------------------------------------


def _moe_setup(which: str):
    """(port MoEConfig, JAX MoEConfig, numpy params, numpy x)."""
    cfg, jcfg = (registry.get(which).smoke.moe, jregistry.get(which).smoke.moe)
    host = _host(jmlp.moe_init(jax.random.PRNGKey(13), jcfg))
    x = np.random.default_rng(14).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, host, x


@pytest.mark.parametrize("mode", ["fakequant", "packed-vpu", "packed-mxu",
                                  "packed-xla"])
@pytest.mark.parametrize("which", ARCHS)
def test_moe_apply_kbit_matches_jax(which, mode):
    cfg, jcfg, host, x = _moe_setup(which)
    backend = mode.partition("-")[2] or "vpu"
    jctx, ctx = _ctxs(backend)
    if mode.startswith("packed"):
        host, rep = jconverter.convert(host, JQuantPolicy.quantized(4))
        host = _host(host)
        assert host["experts"]["up_packed"].ndim == 4 and rep.n_packed > 0
    jy, jaux = jmlp.moe_apply(jax.tree.map(jnp.asarray, host), jnp.asarray(x),
                              jcfg, jctx, "layers/1/moe")
    with torch.inference_mode():
        y, aux = mlp.moe_apply(params_from_numpy(host, "cpu"),
                               torch.from_numpy(x), cfg, ctx, "layers/1/moe")
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("which", ARCHS)
def test_moe_kbit_vpu_equals_mxu_on_port(which):
    """``vpu-k4`` and ``mxu-k4`` give the same integer S, so ``moe_apply``
    gives the same bits on both; packed is within the k-bit contract of
    fake-quant (``rtol=1e-4, atol=2e-4``)."""
    cfg, _, host, x = _moe_setup(which)
    params = params_from_numpy(host, "cpu")
    packed, _ = converter.convert(params, QuantPolicy.quantized(4))
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        fake, _ = mlp.moe_apply(params, xt, cfg, _ctxs("vpu")[1],
                                "layers/1/moe")
        yv, av = mlp.moe_apply(packed, xt, cfg, _ctxs("vpu")[1],
                               "layers/1/moe")
        ym, am = mlp.moe_apply(packed, xt, cfg, _ctxs("mxu")[1],
                               "layers/1/moe")
    assert torch.equal(yv, ym) and torch.equal(av, am)
    np.testing.assert_allclose(yv.numpy(), fake.numpy(), rtol=1e-4, atol=2e-4)


def test_packed_kbit_moe_runs_the_grouped_kernels(monkeypatch):
    """At w4a4 every routed GEMM goes through the grouped k-bit entry
    (K9 on ``vpu``, K10 on ``mxu``): three calls per MoE layer, and never
    the 1-bit batched kernels or the dense-path plane GEMMs."""
    cfg, _, host, x = _moe_setup("deepseek-moe-16b")
    packed, _ = converter.convert(params_from_numpy(host, "cpu"),
                                  QuantPolicy.quantized(4))
    calls = []
    for fam, fn in (("vpu", kbit_gemm.kbit_plane_gemm_batched),
                    ("mxu", kbit_mxu.kbit_mxu_gemm_batched)):
        be = dispatch.get_backend(f"{fam}-k4")

        def spy(a, b, fam=fam, fn=fn):
            calls.append((fam, tuple(a.shape), tuple(b.shape)))
            return fn(a, b)

        monkeypatch.setitem(dispatch._REGISTRY, be.name,
                            dataclasses.replace(be, gemm_kbit_grouped=spy))
    with torch.inference_mode():
        for backend in ("vpu", "mxu"):
            mlp.moe_apply(packed, torch.from_numpy(x), cfg,
                          _ctxs(backend)[1], "layers/1/moe")
    assert [c[0] for c in calls] == ["vpu"] * 3 + ["mxu"] * 3
    t_k = x.shape[0] * x.shape[1] * cfg.top_k
    assert calls[0][1] == (cfg.e, 4, t_k, bitpack.packed_width(cfg.d_model))
    assert calls[2][2] == (cfg.e, 4, cfg.d_model,
                           bitpack.packed_width(cfg.d_expert))


@pytest.mark.parametrize("quant,backend", [("fakequant", "vpu"),
                                           ("packed", "vpu"),
                                           ("packed", "mxu")])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_logits_kbit_match_jax(arch, quant, backend, smoke_params):
    """Prefill, two decode steps and the full forward (with its summed aux
    loss) at w4a4 against the JAX package."""
    host, jpacked = smoke_params[arch]
    p = jpacked if quant == "packed" else host
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    jcfg, cfg = jregistry.get(arch).smoke, registry.get(arch).smoke
    jctx, ctx = _ctxs(backend)
    tokens = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, 7))
    jl, jcache = jlm.prefill(jp, jcfg, jctx, jnp.asarray(tokens, jnp.int32),
                             cache_len=16)
    with torch.inference_mode():
        tl, tcache = lm.prefill(tp, cfg, ctx, torch.from_numpy(tokens),
                                cache_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = np.array([7, 5], np.int32)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(2):
        jl, jcache = jlm.decode_step(jp, jcfg, jctx, jcache,
                                     jnp.asarray(tok)[:, None],
                                     jnp.asarray(pos))
        with torch.inference_mode():
            tl, tcache = lm.decode_step(tp, cfg, ctx, tcache,
                                        torch.from_numpy(tok)[:, None].long(),
                                        torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        pos = pos + 1
    jl, jaux = jlm.forward(jp, jcfg, jctx, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        tl, aux = lm.forward(tp, cfg, ctx, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


LENS = (5, 5, 8, 3, 8, 5)  # same-length prefill runs + slot recycling


def _prompts(vocab: int):
    rng = np.random.default_rng(17)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in LENS]


def _serve(mod, eng, prompts):
    sched = mod.Scheduler(eng)
    for p in prompts:
        sched.submit(mod.Request(prompt=p))
    return sched.run(), sched.stats


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_kbit_greedy_streams_match_jax(arch, smoke_params):
    """w4a4 packed serving: JAX's ``vpu`` greedy streams, and the port's on
    ``vpu-k4`` and ``mxu-k4``, are identical, with the same step, prefill
    and admission counts."""
    _, jpacked = smoke_params[arch]
    spec, tspec = jregistry.get(arch), registry.get(arch)
    prompts = _prompts(spec.smoke.vocab_size)
    ecfg = dict(batch=2, cache_len=24, max_new_tokens=5)
    jeng = jengine.Engine(spec, spec.smoke, _ctxs("vpu")[0],
                          jax.tree.map(jnp.asarray, jpacked),
                          jengine.EngineConfig(**ecfg))
    want, jstats = _serve(jengine, jeng, prompts)
    params = params_from_numpy(jpacked, "cpu")
    for backend in ("vpu", "mxu"):
        got, stats = _serve(engine, engine.Engine(
            tspec, tspec.smoke, _ctxs(backend)[1], params,
            engine.EngineConfig(**ecfg)), prompts)
        assert sorted(got) == sorted(want) == list(range(len(prompts)))
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])
        assert (stats.steps, stats.prefills, stats.admissions) == (
            jstats.steps, jstats.prefills, jstats.admissions)


@pytest.mark.parametrize("arch,backend", [("deepseek-moe-16b", "vpu"),
                                          ("deepseek-moe-16b", "mxu"),
                                          ("qwen2-moe-a2.7b", "vpu")])
def test_serve_launcher_moe_kbit_checks_fakequant(arch, backend, capsys):
    out = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--quant", "w4a4", "--backend", backend,
                          "--prompts", "2", "--prompt-len", "4",
                          "--new-tokens", "3", "--cache-len", "16",
                          "--check-fakequant"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    assert f"{arch}: 2 layers" in text and "quant w4a4" in text
    assert "packed == fake-quant:" in text and "of 6 tokens agree" in text
