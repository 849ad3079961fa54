"""The PyTorch port's CUDA kernels on the card, against their plain PyTorch
versions (exact, int32) and the port's CPU path.  Marked ``gpu``: they skip
without a CUDA GPU.  This file imports no JAX (the machine with the card has
none).  Run there with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bitpack, converter, quant
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import (_cuda, dispatch, kbit_gemm, kbit_mxu,
                                 pack_bits, xnor_gemm)
from repro_torch.models import lm, registry
from repro_torch.nn.common import QCtx
from repro_torch.serve import engine

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


@pytest.mark.parametrize("m,k", [(1, 1), (3, 33), (4, 2048), (128, 8192),
                                 (5, 2049), (257, 100)])
def test_pack_sign_kernel_matches_plain(cuda, m, k):
    x = _floats((m, k), m + k, cuda)
    got = pack_bits.pack_sign(x)
    torch.cuda.synchronize()
    assert torch.equal(got, pack_bits.pack_sign_plain(x))


@pytest.mark.parametrize("m,n,kw", [(1, 1, 1), (3, 5, 7), (4, 2048, 64),
                                    (17, 8192, 64), (128, 2048, 256),
                                    (33, 65, 9)])
def test_gemm_kernels_match_plain(cuda, m, n, kw):
    a, b = _words((m, kw), 1, cuda), _words((n, kw), 2, cuda)
    got_v, got_m = xnor_gemm.xnor_mismatch(a, b), xnor_gemm.xnor_dot_mxu(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got_v, xnor_gemm.xnor_mismatch_plain(a, b))
    assert torch.equal(got_m, xnor_gemm.xnor_dot_mxu_plain(a, b))


def test_launch_counts(cuda):
    _cuda.reset_launches()
    x = _floats((2, 70), 0, cuda)
    w = pack_bits.pack_sign(_floats((5, 70), 1, cuda))
    for backend in ("vpu", "mxu"):
        dispatch.quant_gemm(x, w, k_true=70,
                            config=dispatch.GemmConfig(backend=backend))
    dispatch.quant_gemm(x.cpu(), w.cpu(), k_true=70)  # plain versions
    assert _cuda.LAUNCHES == {"pack_sign": 3, "xnor_mismatch": 1,
                              "xnor_dot_mxu": 1, "quant_pack_planes": 0,
                              "kbit_plane_gemm": 0, "kbit_mxu_gemm": 0}


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


@pytest.mark.parametrize("a_bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m,k", [(1, 1), (3, 33), (4, 2048), (128, 8192),
                                 (5, 2049), (256, 8191)])
def test_quant_pack_planes_kernel_matches_plain(cuda, a_bits, m, k):
    x = _acts((m, k), m + k, cuda, a_bits)
    got_p, got_t = pack_bits.quant_pack_planes(x, a_bits)
    torch.cuda.synchronize()
    want_p, want_t = pack_bits.quant_pack_planes_plain(x, a_bits)
    assert torch.equal(got_p, want_p) and torch.equal(got_t, want_t)


@pytest.mark.parametrize("ka,kb", [(2, 2), (4, 4), (8, 8), (8, 4), (3, 5)])
@pytest.mark.parametrize("m,n,kw", [(1, 1, 1), (3, 5, 7), (4, 2048, 64),
                                    (17, 512, 256), (33, 65, 9)])
def test_kbit_gemm_kernels_match_plain(cuda, ka, kb, m, n, kw):
    a, b = _words((ka, m, kw), 1, cuda), _words((kb, n, kw), 2, cuda)
    got_v, got_m = kbit_gemm.kbit_plane_gemm(a, b), kbit_mxu.kbit_mxu_gemm(a, b)
    torch.cuda.synchronize()
    want = kbit_gemm.kbit_plane_gemm_plain(a, b)
    assert torch.equal(got_v, want)
    assert torch.equal(got_m, want)
    assert torch.equal(kbit_mxu.kbit_mxu_gemm_plain(a, b), want)


def test_kbit_launch_counts(cuda):
    _cuda.reset_launches()
    x = _acts((2, 70), 0, cuda, 4)
    w = pack_bits.quant_pack_planes(_acts((5, 70), 1, cuda, 4), 4)[0]
    for backend in ("vpu", "mxu", "xla"):
        dispatch.quant_gemm(x, w, k_true=70, w_bits=4, a_bits=4,
                            config=dispatch.GemmConfig(backend=backend))
    dispatch.quant_gemm(x.cpu(), w.cpu(), k_true=70, w_bits=4, a_bits=4)
    assert _cuda.LAUNCHES == {"pack_sign": 0, "xnor_mismatch": 0,
                              "xnor_dot_mxu": 0, "quant_pack_planes": 3,
                              "kbit_plane_gemm": 1, "kbit_mxu_gemm": 1}


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
