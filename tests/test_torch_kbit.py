"""PyTorch port vs the JAX package on the k-bit (DoReFa, paper Eq. 1) packed
path: the plain versions of the quantize-plane-pack prologue (K4), the
plane AND-popcount GEMM (K5) and the code-lane GEMM (K6) against the TPU
kernels (Pallas interpret mode, block-padded shapes), the dispatch layer's
k-bit half (resolution, refusals, ``quant_gemm`` on ``vpu``/``mxu``/``xla``),
the converter's plane stacks and packed k-bit ``qdense``.  The CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).

Tolerances: integer outputs (planes, row-sums T, S) are bit-identical.  The
packed k-bit dot is ``(2S - Nw*T) / (Na*Nw)``: an exact int32 numerator and
one fp32 scaling in both packages, so ``quant_gemm`` on ``vpu``/``mxu`` is
bit-identical too — up to one rounding of the product where a bias or the
alpha scale follows it (ROADMAP C: XLA fuses ``y*r + b`` into one
multiply-add).  The ``xla`` backend is a float32 matmul of the
dequantized values, whose summation order belongs to each library: a few
ulp (rtol 1e-5).  Packed against fake-quant is the JAX package's own k-bit
contract, ``rtol=1e-4, atol=2e-4`` (tests/test_kbit.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro.core import converter as jconverter
from repro.core import qlayers as jqlayers
from repro.core import quant as jquant
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.kernels import dispatch as jdispatch
from repro.kernels.kbit_gemm import kbit_plane_gemm_pallas
from repro.kernels.kbit_mxu import kbit_mxu_gemm_pallas
from repro.kernels.pack_bits import quant_pack_planes_pallas
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro_torch.core import bitpack, converter, qlayers, quant
from repro_torch.core.policy import QuantPolicy, QuantSpec
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch, kbit_gemm, kbit_mxu, pack_bits

KBIT_TOL = dict(rtol=1e-4, atol=2e-4)  # tests/test_kbit.py's contract
WIDTHS = [(2, 2), (3, 3), (4, 4), (8, 8), (4, 8)]  # (w_bits, a_bits)


def _i32(words) -> np.ndarray:
    return np.asarray(words).view(np.int32)


def _edge_acts(rng, shape, a_bits):
    """Floats spread over [-0.5, 1.5] with the DoReFa edge cases mixed in:
    exact rounding ties (j + 0.5)/Na, -0.0, 0, 1, below 0 and above 1."""
    na = (1 << a_bits) - 1
    x = rng.uniform(-0.5, 1.5, shape).astype(np.float32)
    edge = np.array([(j + 0.5) / na for j in range(na)]
                    + [-0.0, 0.0, 1.0, -3.0, 7.0, 1e-8, 1 - 1e-7],
                    np.float32)
    flat = x.reshape(-1)
    n = min(flat.size // 2, edge.size)
    flat[rng.choice(flat.size, n, replace=False)] = edge[:n]
    return x


def _planes(rng, bits, rows, kw):
    u = rng.integers(0, 2**32, (bits, rows, kw), dtype=np.uint64)
    u = u.astype(np.uint32)
    return u, torch.from_numpy(u.view(np.int32).copy())


# --------------------------------------------------------------------------
# K4: quantize -> plane pack (+ code row-sums)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("a_bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k", [33, 64, 100])
def test_quant_pack_planes_plain_matches_pallas_kernel(a_bits, k):
    """The prologue's plain version vs the TPU kernel (interpret mode).  The
    Pallas kernel takes floats pre-padded with -1.0 (code 0) to its blocks;
    the port's kernel masks the ragged edge itself."""
    m = 5
    x = _edge_acts(np.random.default_rng(a_bits * 100 + k), (m, k), a_bits)
    kw = bitpack.packed_width(k)
    bm, bkw = 8, 1
    xp = np.full((bm, kw * 32), -1.0, np.float32)
    xp[:m, :k] = x
    want_p, want_t = quant_pack_planes_pallas(jnp.asarray(xp), a_bits, bm=bm,
                                              bkw=bkw, interpret=True)
    got_p, got_t = pack_bits.quant_pack_planes(torch.from_numpy(x), a_bits)
    assert got_p.dtype == got_t.dtype == torch.int32
    assert got_p.shape == (a_bits, m, kw) and got_t.shape == (m, 1)
    np.testing.assert_array_equal(got_p.numpy(), _i32(want_p)[:, :m])
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t)[:m])


@pytest.mark.parametrize("a_bits", [2, 4, 8])
@pytest.mark.parametrize("m,k", [(1, 1), (3, 31), (7, 65), (2, 257)])
def test_pack_act_planes_matches_jax_unfused(a_bits, m, k):
    """Ragged shapes through both prologue routes of the port against the
    JAX ``pack_act_planes(fused=False)``; the planes unpack to the codes."""
    x = _edge_acts(np.random.default_rng(m * k + a_bits), (m, k), a_bits)
    want_p, want_t = jdispatch.pack_act_planes(jnp.asarray(x), a_bits,
                                               fused=False)
    for fused in (True, False):
        got_p, got_t = dispatch.pack_act_planes(torch.from_numpy(x), a_bits,
                                                fused=fused)
        np.testing.assert_array_equal(got_p.numpy(), _i32(want_p))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    codes = quant.act_codes(torch.from_numpy(x), a_bits)
    np.testing.assert_array_equal(bitpack.unpack_planes(got_p, k).numpy(),
                                  codes.numpy())
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jquant.act_codes(jnp.asarray(x), a_bits)))


def test_quant_pack_planes_rounds_ties_to_even():
    """Ties (j + 0.5)/Na land on the even code, as torch.round and
    jnp.round do (the CUDA kernel uses rintf for the same reason)."""
    x = torch.tensor([[0.5 / 3, 1.5 / 3, 2.5 / 3, 1.0, -0.0, 2.0]])
    planes, t = pack_bits.quant_pack_planes(x, 2)
    codes = bitpack.unpack_planes(planes, 6)[0].tolist()
    assert codes == [0, 2, 2, 3, 0, 3] and t.item() == 10
    with pytest.raises(ValueError, match="2..8"):
        pack_bits.quant_pack_planes(x, 1)


# --------------------------------------------------------------------------
# K5 / K6: plane AND-popcount and code-lane GEMMs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kb,ka", [(w, a) for w, a in WIDTHS])
@pytest.mark.parametrize("m,n,kw", [(8, 16, 4), (16, 8, 6)])
def test_kbit_gemm_plain_versions_match_pallas_kernels(ka, kb, m, n, kw):
    """K5's and K6's plain versions against the TPU kernels on random
    words over the full 32-bit range, bit for bit, and K5 == K6."""
    rng = np.random.default_rng(ka * 10 + kb + m + kw)
    au, at = _planes(rng, ka, m, kw)
    bu, bt = _planes(rng, kb, n, kw)
    blocks = dict(bm=8, bn=8, bkw=2, interpret=True)
    want_vpu = kbit_plane_gemm_pallas(jnp.asarray(au), jnp.asarray(bu),
                                      chunk_words=2, **blocks)
    want_mxu = kbit_mxu_gemm_pallas(jnp.asarray(au), jnp.asarray(bu),
                                    **blocks)
    got_vpu = kbit_gemm.kbit_plane_gemm(at, bt)
    got_mxu = kbit_mxu.kbit_mxu_gemm(at, bt)
    assert got_vpu.dtype == got_mxu.dtype == torch.int32
    np.testing.assert_array_equal(got_vpu.numpy(), np.asarray(want_vpu))
    np.testing.assert_array_equal(got_mxu.numpy(), np.asarray(want_mxu))
    np.testing.assert_array_equal(got_vpu.numpy(), got_mxu.numpy())


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (3, 5, 33), (7, 9, 95)])
def test_kbit_gemm_ragged_equals_integer_code_dot(bits, m, n, k):
    """Odd M, N and K: S is the integer dot of the codes, no correction."""
    rng = np.random.default_rng(bits + k)
    ca = rng.integers(0, 2**bits, (m, k))
    cb = rng.integers(0, 2**bits, (n, k))
    ap = bitpack.pack_planes(torch.from_numpy(ca), bits)
    bp = bitpack.pack_planes(torch.from_numpy(cb), bits)
    want = ca @ cb.T
    np.testing.assert_array_equal(kbit_gemm.kbit_plane_gemm(ap, bp).numpy(),
                                  want)
    np.testing.assert_array_equal(kbit_mxu.kbit_mxu_gemm(ap, bp).numpy(), want)
    for backend in ("vpu", "mxu", "xla", f"mxu-k{bits}"):
        got = dispatch.packed_kbit_gemm(
            ap, bp, config=dispatch.GemmConfig(backend=backend))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)


def test_kbit_gemm_operand_checks():
    a = torch.zeros((4, 2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="Kw mismatch"):
        kbit_gemm.kbit_plane_gemm(a, torch.zeros((4, 2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="1..8 planes"):
        kbit_mxu.kbit_mxu_gemm(torch.zeros((9, 2, 3), dtype=torch.int32), a)
    with pytest.raises(TypeError):
        kbit_gemm.kbit_plane_gemm(a.float(), a)


# --------------------------------------------------------------------------
# dispatch: resolution, refusals, quant_gemm
# --------------------------------------------------------------------------


def test_resolve_backend_matches_jax_over_names_and_widths():
    names = ["vpu", "mxu", "xla"] + [f"{f}-k{k}" for f in ("vpu", "mxu")
                                     for k in (2, 4, 8)]
    assert sorted(names) == sorted(dispatch._REGISTRY)
    for name in names:
        for w_bits in range(1, 9):
            want = jdispatch.resolve_backend(name, w_bits)
            assert dispatch.resolve_backend(name, w_bits) == want, (name,
                                                                    w_bits)
            for a_bits in (w_bits, 8):
                pro = dispatch.resolve_prologue(name, w_bits, a_bits)
                jpro = jdispatch.resolve_prologue(name, w_bits, a_bits)
                assert (pro.kind, pro.a_bits, pro.fused) == (
                    jpro.kind, jpro.a_bits, jpro.fused)
    assert dispatch.resolve_backend("vpu", 3) == "xla"
    assert dispatch.resolve_backend("mxu", 4) == "mxu-k4"
    for bad in ("vpux", "shard-vpu"):
        with pytest.raises(ValueError, match="unknown gemm backend"):
            dispatch.resolve_backend(bad, 4)


def _message(fn, *args):
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


@pytest.mark.parametrize("w_bits,a_bits", [(1, 4), (4, 1), (9, 4), (4, 12)])
def test_width_refusals_match_jax(w_bits, a_bits):
    assert (_message(dispatch._check_kbit_widths, w_bits, a_bits)
            == _message(jdispatch._check_kbit_widths, w_bits, a_bits))
    x = torch.zeros((2, 40))
    with pytest.raises(ValueError, match="widths"):
        dispatch.quant_gemm(x, torch.zeros((4, 3, 2), dtype=torch.int32),
                            k_true=40, w_bits=w_bits, a_bits=a_bits)


@pytest.mark.parametrize("family", ["vpu", "mxu"])
def test_accumulator_refusals_match_jax(family):
    """w8a8 caps K below 2^31 / (2*255*255) = 16513; w4a4 passes there."""
    for fn, jfn in ((dispatch._check_kbit_accumulator,
                     jdispatch._check_kbit_accumulator),
                    (dispatch._check_kbit_accumulator_mxu,
                     jdispatch._check_kbit_accumulator_mxu)):
        assert _message(fn, 16520, 8, 8) == _message(jfn, 16520, 8, 8)
        fn(16512, 8, 8)
        fn(16520, 4, 4)
    name = f"{family}-k8"
    assert (dispatch._accum_check_for(name).__name__
            == jdispatch._accum_check_for(name).__name__)
    kw = 520  # 16640 lanes
    planes = torch.zeros((8, 2, kw), dtype=torch.int32)
    with pytest.raises(ValueError, match="overflows its int32 accumulator"):
        dispatch.packed_kbit_gemm(planes, planes,
                                  config=dispatch.GemmConfig(backend=family))
    with pytest.raises(ValueError, match="overflows its int32 accumulator"):
        dispatch.quant_gemm(torch.zeros((2, kw * 32)), planes,
                            k_true=kw * 32, w_bits=8, a_bits=8,
                            config=dispatch.GemmConfig(backend=family))


def _assert_kbit_equal(got, want, *, epilogue, backend):
    """Bit-equal, save for roundings that XLA fuses and PyTorch does not:
    with a bias or alpha scale after the dequant multiply, XLA contracts
    ``dot * r + b`` into one fused multiply-add (ROADMAP C), so the two
    differ by one rounding of the product — at most an ulp of |dot|, hence
    ``rtol=atol=2e-6`` for these |dot| < 16.  The ``xla`` backend is a
    float32 matmul whose summation order belongs to each library."""
    if backend == "xla":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif epilogue:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    else:
        np.testing.assert_array_equal(got, want)


EPILOGUES = [dict(), dict(bias=True), dict(scale=True, bias=True)]


@pytest.mark.parametrize("backend", ["vpu", "mxu", "xla"])
@pytest.mark.parametrize("w_bits,a_bits", WIDTHS)
@pytest.mark.parametrize("ep", EPILOGUES, ids=lambda e: "+".join(e) or "none")
def test_quant_gemm_kbit_matches_jax_dispatch(backend, w_bits, a_bits, ep):
    m, k, n = 6, 70, 10  # K % 32 != 0
    rng = np.random.default_rng(w_bits * 10 + a_bits)
    x = rng.uniform(-0.3, 1.3, (2, m // 2, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    sc = np.abs(rng.standard_normal(n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    jwp = jbitpack.pack_planes(jquant.weight_codes(jnp.asarray(w), w_bits),
                               w_bits)
    want = jdispatch.quant_gemm(
        jnp.asarray(x), jwp, k_true=k,
        config=jdispatch.GemmConfig(backend=backend),
        epilogue=jdispatch.EpilogueSpec(**ep), scale=jnp.asarray(sc),
        bias=jnp.asarray(bias), w_bits=w_bits, a_bits=a_bits)
    wp = torch.from_numpy(_i32(jwp).copy())
    for fused in (True, False):
        got = dispatch.quant_gemm(
            torch.from_numpy(x), wp, k_true=k,
            config=dispatch.GemmConfig(backend=backend, fused_prologue=fused),
            epilogue=dispatch.EpilogueSpec(**ep), scale=torch.from_numpy(sc),
            bias=torch.from_numpy(bias), w_bits=w_bits, a_bits=a_bits)
        assert got.shape == (2, m // 2, n) and got.dtype == torch.float32
        _assert_kbit_equal(got.numpy(), np.asarray(want), epilogue=ep,
                           backend=dispatch.resolve_backend(backend, w_bits))


def test_xla_backend_1bit_matches_jax_and_plane_backends_refuse_1bit():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 70)).astype(np.float32)
    w = rng.standard_normal((7, 70)).astype(np.float32)
    jwp = jbitpack.pack_sign(jnp.asarray(w))
    want = jdispatch.quant_gemm(jnp.asarray(x), jwp, k_true=70,
                                config=jdispatch.GemmConfig(backend="xla"))
    wp = torch.from_numpy(_i32(jwp).copy())
    cfg = dispatch.GemmConfig(backend="xla")
    got = dispatch.quant_gemm(torch.from_numpy(x), wp, k_true=70, config=cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xp = bitpack.pack_sign(torch.from_numpy(x))
    np.testing.assert_array_equal(
        dispatch.packed_gemm(xp, wp, k_true=70, config=cfg).numpy(),
        np.asarray(want).astype(np.int32))
    with pytest.raises(ValueError, match="k-bit GEMMs only"):
        dispatch.get_backend("vpu-k4").gemm(xp, wp, 70)


# --------------------------------------------------------------------------
# converter and packed k-bit qdense
# --------------------------------------------------------------------------


def _smoke_params(seed=0):
    cfg = jregistry.get("granite-3-2b").smoke
    return jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("w_bits,a_bits", [(4, 4), (8, 8), (4, 8)])
def test_converter_plane_stacks_match_jax(w_bits, a_bits):
    np_params = _smoke_params()
    jpol = JQuantPolicy.quantized(w_bits, a_bits)
    pol = QuantPolicy.quantized(w_bits, a_bits)
    jpacked, jrep = jconverter.convert(np_params, jpol)
    packed, rep = converter.convert(params_from_numpy(np_params, "cpu"), pol)
    assert (rep.bytes_fp32, rep.bytes_after, rep.n_packed) == (
        jrep.bytes_fp32, jrep.bytes_after, jrep.n_packed)
    assert [(l.path, l.bytes_after) for l in rep.leaves] == [
        (l.path, l.bytes_after) for l in jrep.leaves]
    for lyr, jlyr in zip(packed["layers"], jpacked["layers"]):
        for blk, names in (("attn", "qkvo"), ("mlp", ("up", "gate", "down"))):
            for name in names:
                got, want = lyr[blk][name]["w_packed"], jlyr[blk][name]["w_packed"]
                assert got.shape[0] == w_bits and got.ndim == 3
                np.testing.assert_array_equal(got.numpy(), _i32(want))
    # the bytes of a packed layer are k/32 of its fp32 bytes (K % 32 == 0)
    leaf = next(l for l in rep.leaves if l.packed)
    assert leaf.bytes_after * 32 == leaf.bytes_fp32 * w_bits


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
@pytest.mark.parametrize("w_bits,a_bits", [(2, 2), (4, 4), (8, 8), (4, 8)])
@pytest.mark.parametrize("scale", [False, True])
def test_qdense_packed_kbit_matches_fakequant_and_jax(backend, w_bits, a_bits,
                                                      scale):
    """A converted dense layer with bias: the port's packed layer equals its
    own fake-quant layer within the k-bit contract and the JAX packed layer
    to the one rounding that XLA fuses into the bias add."""
    rng = np.random.default_rng(w_bits + 3 * a_bits)
    w = rng.standard_normal((97, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    x = rng.uniform(-0.5, 1.5, (3, 5, 97)).astype(np.float32)
    pol = QuantPolicy(w_bits=w_bits, a_bits=a_bits, scale=scale)
    jpol = JQuantPolicy(w_bits=w_bits, a_bits=a_bits, scale=scale)
    spec, jspec = pol.spec("layers/0/up"), jpol.spec("layers/0/up")
    p = params_from_numpy({"w": w, "b": b}, "cpu")
    packed, rep = converter.convert({"l": p}, pol)
    assert rep.n_packed == 1 and packed["l"]["w_packed"].shape == (w_bits, 24, 4)
    cfg = dispatch.GemmConfig(backend=backend)
    xt = torch.from_numpy(x)
    y_fake = qlayers.qdense(p, xt, spec, compute_dtype=torch.float32,
                            gemm_config=cfg)
    y_pack = qlayers.qdense(packed["l"], xt, spec, compute_dtype=torch.float32,
                            gemm_config=cfg)
    assert y_pack.shape == (3, 5, 24)
    np.testing.assert_allclose(y_pack.numpy(), y_fake.numpy(), **KBIT_TOL)
    jpacked, _ = jconverter.convert({"l": {"w": w, "b": b}}, jpol)
    want = jqlayers.qdense(jpacked["l"], jnp.asarray(x), jspec,
                           compute_dtype=jnp.float32,
                           gemm_config=jdispatch.GemmConfig(backend=backend))
    _assert_kbit_equal(y_pack.numpy(), np.asarray(want), epilogue=True,
                       backend=backend)


def test_qdense_packed_layout_refusals():
    spec = QuantSpec(4, 4)
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="plane stack"):
        qlayers.qdense({"w_packed": torch.zeros((3, 2), dtype=torch.int32)},
                       x, spec)
    with pytest.raises(ValueError, match="plane stack"):
        qlayers.qdense({"w_packed": torch.zeros((2, 3, 2), dtype=torch.int32)},
                       x, spec)
    with pytest.raises(ValueError, match=r"\(d_out, Kw\)"):
        qlayers.qdense({"w_packed": torch.zeros((1, 3, 2), dtype=torch.int32)},
                       x, QuantSpec(1, 1))
