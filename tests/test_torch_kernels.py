"""PyTorch port vs the JAX package: the packed GEMM kernels' plain versions
against the TPU kernels (Pallas interpret mode), the dispatch layer's
``quant_gemm`` on both backends and every epilogue flag, the converter's
words, and the port's own §2.2.2 invariant (fake-quant == packed, exactly).
The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro.core import converter as jconverter
from repro.core import qlayers as jqlayers
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.core.policy import QuantSpec as JQuantSpec
from repro.kernels import dispatch as jdispatch
from repro.kernels.xnor_gemm import (xnor_dot_mxu_pallas,
                                     xnor_mismatch_pallas)
from repro.kernels.xnor_gemm import mxu_pad_inflation as j_mxu_pad_inflation
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro_torch.core import bitpack, converter, qlayers
from repro_torch.core.policy import QuantPolicy, QuantSpec
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch, xnor_gemm


def _words(rng, shape):
    """Random 32-bit words over the full range (bit 31 set half the time),
    as (uint32 for JAX, int32 for the port)."""
    u = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    return u, torch.from_numpy(u.view(np.int32).copy())


@pytest.mark.parametrize("m,n,kw", [(8, 16, 4), (16, 8, 12), (8, 24, 2)])
def test_gemm_plain_versions_match_pallas_kernels(m, n, kw):
    rng = np.random.default_rng(m * 100 + n + kw)
    au, at = _words(rng, (m, kw))
    bu, bt = _words(rng, (n, kw))
    blocks = dict(bm=8, bn=8, bkw=2, interpret=True)
    want_vpu = xnor_mismatch_pallas(jnp.asarray(au), jnp.asarray(bu),
                                    chunk_words=2, **blocks)
    want_mxu = xnor_dot_mxu_pallas(jnp.asarray(au), jnp.asarray(bu), **blocks)
    got_vpu = xnor_gemm.xnor_mismatch(at, bt)
    got_mxu = xnor_gemm.xnor_dot_mxu(at, bt)
    assert got_vpu.dtype == got_mxu.dtype == torch.int32
    np.testing.assert_array_equal(got_vpu.numpy(), np.asarray(want_vpu))
    np.testing.assert_array_equal(got_mxu.numpy(), np.asarray(want_mxu))


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (3, 5, 33), (7, 9, 95),
                                   (2, 3, 257)])
def test_gemm_plain_versions_ragged_against_numpy(m, n, k):
    """Odd M, N and K: the two raw outputs and their pad corrections give
    the exact ±1 dot of the signs."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    sa, sw = np.where(a >= 0, 1, -1), np.where(w >= 0, 1, -1)
    dot = sa @ sw.T
    ap = bitpack.pack_sign(torch.from_numpy(a))
    wp = bitpack.pack_sign(torch.from_numpy(w))
    kw = ap.shape[1]
    mism = xnor_gemm.xnor_mismatch(ap, wp).numpy()
    padded = xnor_gemm.xnor_dot_mxu(ap, wp).numpy()
    np.testing.assert_array_equal(k - 2 * mism, dot)
    assert xnor_gemm.mxu_pad_inflation(kw, k) == j_mxu_pad_inflation(kw, k)
    np.testing.assert_array_equal(
        padded - xnor_gemm.mxu_pad_inflation(kw, k), dot)
    for backend in ("vpu", "mxu"):
        got = dispatch.packed_gemm(ap, wp, k_true=k,
                                   config=dispatch.GemmConfig(backend=backend))
        np.testing.assert_array_equal(got.numpy(), dot)


EPILOGUES = [dict(), dict(scale=True), dict(xnor_range=True), dict(bias=True),
             dict(scale=True, xnor_range=True, bias=True)]


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
@pytest.mark.parametrize("ep", EPILOGUES, ids=lambda e: "+".join(e) or "none")
@pytest.mark.parametrize("fused", [True, False])
def test_quant_gemm_matches_jax_dispatch(backend, ep, fused):
    m, k, n = 6, 70, 10  # K % 32 != 0
    rng = np.random.default_rng(len(ep))
    x = rng.standard_normal((2, m // 2, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    scale = np.abs(rng.standard_normal(n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    jw = jnp.asarray(w)
    want = jdispatch.quant_gemm(
        jnp.asarray(x), jbitpack.pack_sign(jw), k_true=k,
        config=jdispatch.GemmConfig(backend=backend, fused_prologue=fused),
        epilogue=jdispatch.EpilogueSpec(**ep),
        scale=jnp.asarray(scale), bias=jnp.asarray(bias))
    got = dispatch.quant_gemm(
        torch.from_numpy(x), bitpack.pack_sign(torch.from_numpy(w)), k_true=k,
        config=dispatch.GemmConfig(backend=backend, fused_prologue=fused),
        epilogue=dispatch.EpilogueSpec(**ep),
        scale=torch.from_numpy(scale), bias=torch.from_numpy(bias))
    assert got.shape == (2, m // 2, n) and got.dtype == torch.float32
    _assert_epilogue_equal(got.numpy(), np.asarray(want), ep.get("scale"))


def _assert_epilogue_equal(got, want, scaled):
    """The integer dot is exact, so the outputs are bit-identical — except
    that with a float alpha scale XLA may fuse ``y*scale + n`` into one
    fused multiply-add (one rounding) where PyTorch rounds twice: one ulp
    of fp32, hence rtol 1e-6."""
    if scaled:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_dispatch_resolution_and_refusals():
    spec = QuantSpec(w_bits=1, a_bits=1)
    for backend in ("vpu", "mxu"):
        cfg = dispatch.GemmConfig(backend=backend, fused_prologue=False)
        pro = dispatch.prologue_from_spec(spec, config=cfg)
        jpro = jdispatch.prologue_from_spec(
            JQuantSpec(w_bits=1, a_bits=1),
            config=jdispatch.GemmConfig(backend=backend, fused_prologue=False))
        assert (pro.kind, pro.a_bits, pro.fused) == (jpro.kind, jpro.a_bits,
                                                     jpro.fused)
        assert dispatch.resolve_backend(backend, 1) == backend
    for s in (QuantSpec(1, 1, scale=True, xnor_range=True), QuantSpec(),
              QuantSpec(4, 4, scale=True, xnor_range=True)):
        got = dispatch.epilogue_from_spec(s, bias=True, out_dtype=torch.float32)
        want = jdispatch.epilogue_from_spec(
            JQuantSpec(s.w_bits, s.a_bits, s.scale, s.xnor_range), bias=True,
            out_dtype=jnp.float32)
        assert (got.scale, got.xnor_range, got.bias) == (
            want.scale, want.xnor_range, want.bias)
    with pytest.raises(ValueError, match="unknown gemm backend"):
        dispatch.get_backend("shard-vpu")
    for name, w_bits in (("vpu", 4), ("mxu", 8), ("vpu", 3), ("xla", 1),
                         ("mxu-k4", 1)):
        assert (dispatch.resolve_backend(name, w_bits)
                == jdispatch.resolve_backend(name, w_bits))
    assert dispatch.get_backend("xla").prologue == "float"
    with pytest.raises(ValueError, match="k_true"):
        dispatch.quant_gemm(torch.zeros((2, 8)), torch.zeros((3, 1),
                            dtype=torch.int32), k_true=9)
    with pytest.raises(TypeError):
        xnor_gemm.xnor_mismatch(torch.zeros((2, 2)), torch.zeros((2, 2)))


def _smoke_params(seed=0):
    cfg = jregistry.get("granite-3-2b").smoke
    return jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("scale", [False, True])
def test_converter_words_match_jax(scale):
    np_params = _smoke_params()
    jpol, pol = JQuantPolicy.binary(scale=scale), QuantPolicy.binary(scale=scale)
    jpacked, jrep = jconverter.convert(np_params, jpol)
    packed, rep = converter.convert(params_from_numpy(np_params, "cpu"), pol)
    assert (rep.bytes_fp32, rep.bytes_after, rep.n_packed) == (
        jrep.bytes_fp32, jrep.bytes_after, jrep.n_packed)
    assert [l.path for l in rep.leaves] == [l.path for l in jrep.leaves]
    for i, (lyr, jlyr) in enumerate(zip(packed["layers"], jpacked["layers"])):
        for blk, names in (("attn", "qkvo"), ("mlp", ("up", "gate", "down"))):
            for name in names:
                got, want = lyr[blk][name], jlyr[blk][name]
                assert "w" not in got
                np.testing.assert_array_equal(
                    got["w_packed"].numpy(),
                    np.asarray(want["w_packed"]).view(np.int32))
                if scale:
                    np.testing.assert_allclose(got["scale"].numpy(),
                                               np.asarray(want["scale"]),
                                               rtol=1e-6)
    np.testing.assert_array_equal(packed["embed"]["table"].numpy(),
                                  np_params["embed"]["table"])


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
@pytest.mark.parametrize("spec", [QuantSpec(1, 1), QuantSpec(1, 1, scale=True),
                                  QuantSpec(1, 1, xnor_range=True)],
                         ids=["plain", "scale", "xnor_range"])
@pytest.mark.parametrize("bias", [False, True])
def test_qdense_fakequant_equals_packed_exactly(backend, spec, bias):
    """§2.2.2 on the port: the float (fake-quant) layer and its converted
    packed twin give identical outputs."""
    gen = torch.Generator().manual_seed(3)
    p = qlayers.dense_init(gen, 97, 40, bias=bias)
    if bias:
        p["b"] = torch.randn(40, generator=gen)
    policy = QuantPolicy(w_bits=1, a_bits=1, scale=spec.scale,
                         xnor_range=spec.xnor_range)
    packed, _ = converter.convert({"layer": p}, policy)
    x = torch.randn((3, 5, 97), generator=gen)
    cfg = dispatch.GemmConfig(backend=backend)
    y_fake = qlayers.qdense(p, x, spec, compute_dtype=torch.float32,
                            gemm_config=cfg)
    y_pack = qlayers.qdense(packed["layer"], x, spec,
                            compute_dtype=torch.float32, gemm_config=cfg)
    assert y_fake.shape == y_pack.shape == (3, 5, 40)
    assert torch.equal(y_fake, y_pack)


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_qdense_packed_matches_jax(backend):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((70, 12)).astype(np.float32)
    x = rng.standard_normal((4, 70)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    jpacked, _ = jconverter.convert({"l": {"w": w, "b": b}},
                                    JQuantPolicy.binary(scale=True))
    want = jqlayers.qdense(jpacked["l"], jnp.asarray(x),
                           JQuantSpec(1, 1, scale=True),
                           compute_dtype=jnp.float32,
                           gemm_config=jdispatch.GemmConfig(backend=backend))
    tp = params_from_numpy(
        {k: np.asarray(v) for k, v in jpacked["l"].items()}, "cpu")
    got = qlayers.qdense(tp, torch.from_numpy(x), QuantSpec(1, 1, scale=True),
                         compute_dtype=torch.float32,
                         gemm_config=dispatch.GemmConfig(backend=backend))
    _assert_epilogue_equal(got.numpy(), np.asarray(want), True)
