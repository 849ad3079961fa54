"""PyTorch port vs the JAX package on the packed 1-bit MoE path: the
deepseek-moe-16b and qwen2-moe-a2.7b smoke configs, the converter's expert
stacks, the expert-batched kernels' plain versions (K7, K8), the grouped
GEMM, ``moe_apply``, the model's logits and the scheduler's greedy streams.
Inputs are made with numpy and handed to both packages; JAX's Pallas
kernels run in interpret mode, as the JAX package's own tests run them.

Tolerances: integer outputs and packed words are bit-identical; the float
outputs of ``moe_apply`` and the model (softmax router, norms, RoPE,
attention) agree to rtol = atol = 1e-4, as in tests/test_torch_lm.py,
since XLA and PyTorch round those ops in another order; greedy streams are
identical.  Denormals are flushed as in tests/test_torch_lm.py (see its
docstring): XLA's CPU backend does, and a binarized model sees the sign of
a denormal.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro.core import converter as jconverter
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.kernels import dispatch as jdispatch
from repro.kernels.dispatch import GemmConfig as JGemmConfig
from repro.kernels.xnor_gemm import (xnor_dot_mxu_batched_pallas,
                                     xnor_mismatch_batched_pallas)
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.nn import mlp as jmlp
from repro.nn.common import QCtx as JQCtx
from repro.serve import engine as jengine
from repro_torch.core import bitpack, converter
from repro_torch.core.policy import QuantPolicy
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch, xnor_gemm
from repro_torch.kernels.dispatch import GemmConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm, registry
from repro_torch.nn import mlp
from repro_torch.nn.common import QCtx
from repro_torch.serve import engine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("deepseek-moe-16b", "qwen2-moe-a2.7b")
# the JAX package's own MoE test config: top-k gate weights renormalised
NORM_MOE = dict(d_model=64, d_expert=48, n_routed=8, n_shared=1, top_k=2)


@pytest.fixture(autouse=True)
def flush_denormals():
    """Match XLA's CPU denormal flush (module docstring) for one test, on
    the calling thread alone (tests/test_torch_lm.py says why)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def smoke_params():
    """{arch: (numpy float params, numpy 1-bit packed params)} from the JAX
    package's init and converter."""
    out = {}
    for i, arch in enumerate(ARCHS):
        host = _host(jlm.init(jax.random.PRNGKey(10 + i),
                              jregistry.get(arch).smoke))
        packed, _ = jconverter.convert(host, JQuantPolicy.binary())
        out[arch] = (host, _host(packed))
    return out


def _ctxs(backend: str, policy: str = "binary"):
    jpol = getattr(JQuantPolicy, policy)()
    pol = getattr(QuantPolicy, policy)()
    return (JQCtx(policy=jpol, compute_dtype=jnp.float32,
                  gemm_config=JGemmConfig(backend=backend)),
            QCtx(policy=pol, compute_dtype=torch.float32,
                 gemm_config=GemmConfig(backend=backend)))


# --------------------------------------------------------------------------
# configs, converter, interop
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    j, t = jregistry.get(arch), registry.get(arch)
    assert (t.arch_id, t.family) == (j.arch_id, j.family)
    for a, b in ((t.config, j.config), (t.smoke, j.smoke)):
        assert (a.name, a.n_layers, a.d_model, a.vocab_size, a.padded_vocab,
                a.ffn_pattern, a.first_dense_layers, a.norm,
                a.tie_embeddings) == (
            b.name, b.n_layers, b.d_model, b.vocab_size, b.padded_vocab,
            b.ffn_pattern, b.first_dense_layers, b.norm, b.tie_embeddings)
        assert dataclasses.asdict(a.moe) == dataclasses.asdict(b.moe)
        assert a.moe.e == b.moe.e
        for field in ("n_heads", "n_kv_heads", "d_head", "rope_theta",
                      "qkv_bias", "scale"):
            assert getattr(a.attn, field) == getattr(b.attn, field)
        assert (None if a.first_dense_mlp is None
                else dataclasses.asdict(a.first_dense_mlp)) == (
            None if b.first_dense_mlp is None
            else dataclasses.asdict(b.first_dense_mlp))
        assert [a.ffn_kind(i) for i in range(a.n_layers)] == [
            b.ffn_kind(i) for i in range(b.n_layers)]
    full = t.config
    assert (full.d_model, full.moe.e, full.moe.d_expert, full.moe.top_k) == (
        2048, 64, 1408, 6 if arch == "deepseek-moe-16b" else 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_expert_stacks_match_jax(arch, smoke_params):
    host, jpacked = smoke_params[arch]
    packed, report = converter.convert(params_from_numpy(host, "cpu"),
                                       QuantPolicy.binary())
    _, jreport = jconverter.convert(host, JQuantPolicy.binary())
    jleaves = jax.tree_util.tree_leaves_with_path(jpacked)
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
    up = packed["layers"][cfg.n_layers - 1]["moe"]["experts"]["up_packed"]
    assert up.shape == (cfg.moe.e, cfg.moe.d_expert,
                        bitpack.packed_width(cfg.d_model))
    assert (report.bytes_fp32, report.bytes_after, report.n_packed) == (
        jreport.bytes_fp32, jreport.bytes_after, jreport.n_packed)


def test_interop_carries_expert_stacks_as_int32_views(smoke_params):
    _, jpacked = smoke_params["deepseek-moe-16b"]
    experts = jpacked["layers"][1]["moe"]["experts"]
    got = params_from_numpy(experts, "cpu")
    assert sorted(got) == ["down_packed", "gate_packed", "up_packed"]
    for name, words in experts.items():
        assert words.ndim == 3 and words.dtype == np.uint32
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(), words.view(np.int32))


# --------------------------------------------------------------------------
# K7 / K8 plain versions and the grouped GEMM
# --------------------------------------------------------------------------


def _words(rng, shape, k_true):
    """Random words with the bits past ``k_true`` zeroed (uint32 for JAX,
    int32 for the port)."""
    u = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    bits = np.arange(shape[-1] * 32).reshape(shape[-1], 32)
    mask = (np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))
            * (bits < k_true)).sum(-1).astype(np.uint32)
    u &= mask
    return u, torch.from_numpy(u.view(np.int32).copy())


@pytest.mark.parametrize("e,m,n,kw,k_true", [
    (2, 8, 16, 4, 128),  # block multiples: raw outputs comparable as they are
    (3, 5, 9, 3, 70),  # ragged M, N and a part-used last word
    (1, 1, 33, 1, 20),
    (4, 13, 8, 5, 150),
])
def test_batched_plain_kernels_match_jax(e, m, n, kw, k_true):
    rng = np.random.default_rng(e * 1000 + m * 10 + kw)
    au, at = _words(rng, (e, m, kw), k_true)
    bu, bt = _words(rng, (e, n, kw), k_true)
    ja, jb = jnp.asarray(au), jnp.asarray(bu)
    raw_v = xnor_gemm.xnor_mismatch_batched(at, bt)
    raw_m = xnor_gemm.xnor_dot_mxu_batched(at, bt)
    assert raw_v.dtype == raw_m.dtype == torch.int32
    assert raw_v.shape == raw_m.shape == (e, m, n)
    if m % 8 == 0 and n % 8 == 0 and kw % 2 == 0:
        blocks = dict(bm=8, bn=8, bkw=2, interpret=True)
        np.testing.assert_array_equal(raw_v.numpy(), np.asarray(
            xnor_mismatch_batched_pallas(ja, jb, chunk_words=2, **blocks)))
        np.testing.assert_array_equal(raw_m.numpy(), np.asarray(
            xnor_dot_mxu_batched_pallas(ja, jb, **blocks)))
    for name in ("vpu", "mxu"):
        jcfg = JGemmConfig(backend=name, interpret=True)
        tiles = jcfg.tiles(m, n, kw, backend=name)
        if name == "vpu":  # zero pad words add no mismatch: raw is raw
            np.testing.assert_array_equal(raw_v.numpy(), np.asarray(
                jdispatch._vpu_raw_grouped(ja, jb, tiles, True)))
        want = jdispatch.get_backend(name).gemm_grouped(ja, jb, k_true, tiles,
                                                        jcfg)
        got = dispatch.get_backend(name).gemm_grouped(at, bt, k_true)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # both corrected forms are the exact ±1 dot of the signs
    sa = bitpack.unpack_sign(at, k_true, torch.float64)
    sb = bitpack.unpack_sign(bt, k_true, torch.float64)
    exact = torch.bmm(sa, sb.transpose(1, 2)).to(torch.int32)
    assert torch.equal(k_true - 2 * raw_v, exact)
    assert torch.equal(raw_m - xnor_gemm.mxu_pad_inflation(kw, k_true), exact)


# K7's tile switches (csrc/xnor_mismatch.cu): bucket rows around the decode
# tile's 32 (24 = deepseek-moe-16b's decode buckets), N off the 16-row warp
# tile and deepseek's 1408, Kw 44 (its down GEMM) and 63; Pallas runs on
# zero-padded operands (zero words add no mismatch)
@pytest.mark.parametrize("m,n,kw", [(m, n, kw) for m in (24, 32, 33, 64)
                                    for n, kw in ((17, 44), (1408, 63))])
def test_batched_plain_matches_pallas_at_tile_switches(m, n, kw):
    rng = np.random.default_rng(m * 100 + kw)
    au, at = _words(rng, (2, m, kw), 32 * kw)
    bu, bt = _words(rng, (2, n, kw), 32 * kw)
    mp, np_, kp = -(-m // 8) * 8, -(-n // 128) * 128, -(-kw // 8) * 8
    ap = np.pad(au, [(0, 0), (0, mp - m), (0, kp - kw)])
    bp = np.pad(bu, [(0, 0), (0, np_ - n), (0, kp - kw)])
    want = np.asarray(xnor_mismatch_batched_pallas(
        jnp.asarray(ap), jnp.asarray(bp), bm=mp, bn=128, bkw=kp,
        chunk_words=8, interpret=True))[:, :m, :n]
    np.testing.assert_array_equal(
        xnor_gemm.xnor_mismatch_batched_plain(at, bt).numpy(), want)


GROUPED_CASES = {  # name: (T, K, E, N, group sizes, expert_capacity, stacks)
    "ragged-empty-short": (23, 45, 4, 13, [5, 0, 11, 4], None, 1),
    "tuple": (17, 40, 3, 9, [6, 7, 4], None, 2),
    "capacity-drops": (12, 33, 3, 5, [8, 2, 2], 4, 1),
    "capacity-route-first": (30, 70, 3, 7, [9, 0, 14], 3, 2),
}


@pytest.mark.parametrize("case", GROUPED_CASES)
@pytest.mark.parametrize("backend", ["vpu", "mxu", "xla"])
def test_quant_gemm_grouped_matches_jax(backend, case):
    t, k, e, n, gs, cap, n_stacks = GROUPED_CASES[case]
    rng = np.random.default_rng(t * k + e)
    x = rng.standard_normal((t, k)).astype(np.float32)
    x[0, :3] = (0.0, -0.0, 0.0)  # sign(±0) = +1 on both sides
    ws = [rng.standard_normal((e, n, k)).astype(np.float32)
          for _ in range(n_stacks)]
    jw = tuple(jbitpack.pack_sign(jnp.asarray(w)) for w in ws)
    tw = tuple(torch.from_numpy(np.asarray(w).view(np.int32).copy())
               for w in jw)
    if n_stacks == 1:
        jw, tw = jw[0], tw[0]
    gs_np = np.asarray(gs, np.int32)
    want = jdispatch.quant_gemm_grouped(
        jnp.asarray(x), jw, jnp.asarray(gs_np), k_true=k,
        config=JGemmConfig(backend=backend), expert_capacity=cap)
    got = dispatch.quant_gemm_grouped(
        torch.from_numpy(x), tw, torch.from_numpy(gs_np), k_true=k,
        config=GemmConfig(backend=backend), expert_capacity=cap)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == n_stacks
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (t, n)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if cap is not None:  # rows past a bucket's capacity are zeros
        starts = np.cumsum([0] + gs[:-1])
        for s, size in zip(starts, gs):
            assert not got[0][s + cap:s + size].any()


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------


def _moe_setup(which: str):
    """(port MoEConfig, JAX MoEConfig, numpy params, numpy x)."""
    if which == "norm":
        cfg, jcfg = mlp.MoEConfig(**NORM_MOE), jmlp.MoEConfig(**NORM_MOE)
    else:
        cfg, jcfg = (registry.get(which).smoke.moe,
                     jregistry.get(which).smoke.moe)
    host = _host(jmlp.moe_init(jax.random.PRNGKey(3), jcfg))
    x = np.random.default_rng(4).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, host, x


@pytest.mark.parametrize("mode", ["fakequant", "packed-vpu", "packed-mxu",
                                  "packed-xla", "fp"])
@pytest.mark.parametrize("which", ARCHS + ("norm",))
def test_moe_apply_matches_jax(which, mode):
    cfg, jcfg, host, x = _moe_setup(which)
    policy = "full_precision" if mode == "fp" else "binary"
    backend = mode.partition("-")[2] or "vpu"
    jctx, ctx = _ctxs(backend, policy)
    if mode.startswith("packed"):
        host, rep = jconverter.convert(host, JQuantPolicy.binary())
        host = _host(host)
        assert "up_packed" in host["experts"] and rep.n_packed > 0
    jy, jaux = jmlp.moe_apply(jax.tree.map(jnp.asarray, host), jnp.asarray(x),
                              jcfg, jctx, "layers/1/moe")
    with torch.inference_mode():
        y, aux = mlp.moe_apply(params_from_numpy(host, "cpu"),
                               torch.from_numpy(x), cfg, ctx, "layers/1/moe")
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("which", ARCHS + ("norm",))
def test_moe_packed_equals_fakequant_on_port(which):
    """§2.2.2 on the port's MoE: every packed backend gives the fake-quant
    output and aux loss bit for bit (the same integer dots, the same float
    ops in the same order, the same combine)."""
    cfg, _, host, x = _moe_setup(which)
    params = params_from_numpy(host, "cpu")
    packed, _ = converter.convert(params, QuantPolicy.binary())
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        want, want_aux = mlp.moe_apply(params, xt, cfg, _ctxs("vpu")[1],
                                       "layers/1/moe")
        for backend in ("vpu", "mxu", "xla"):
            got, aux = mlp.moe_apply(packed, xt, cfg, _ctxs(backend)[1],
                                     "layers/1/moe")
            assert torch.equal(got, want) and torch.equal(aux, want_aux)


def test_moe_top_k_and_combine_order():
    """Ties go to the lower expert index (``jax.lax.top_k``), values come
    descending, and a token's k contributions are summed from zero in
    ascending sorted position, which for one token is ascending expert id:
    the result does not depend on the token's batch mates."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.1],
                          [0.25, 0.25, 0.25, 0.25, 0.0]])
    w, idx = mlp._top_k(probs, 3)
    jw, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    cfg, _, host, x = _moe_setup("deepseek-moe-16b")
    packed, _ = converter.convert(params_from_numpy(host, "cpu"),
                                  QuantPolicy.binary())
    ctx = _ctxs("vpu")[1]
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        whole, _ = mlp.moe_apply(packed, xt, cfg, ctx, "layers/1/moe")
        rows = [mlp.moe_apply(packed, xt[b:b + 1, s:s + 1], cfg, ctx,
                              "layers/1/moe")[0]
                for b in range(x.shape[0]) for s in range(x.shape[1])]
    assert torch.equal(whole.reshape(-1, x.shape[-1]),
                       torch.cat(rows).reshape(-1, x.shape[-1]))


def test_packed_moe_reads_nothing_back_to_the_host(monkeypatch):
    """The packed path keeps group sizes, bucket cells and masks on the
    device: no ``item`` / ``tolist`` / truth value / ``nonzero`` anywhere
    in ``moe_apply`` with a packed backend (on the card each would stall
    the stream) — at 1 bit (``vpu`` / ``mxu``) and at w4a4 (``vpu-k4`` /
    ``mxu-k4``), under full and tight expert capacity."""
    cfg, _, host, x = _moe_setup("qwen2-moe-a2.7b")
    params = params_from_numpy(host, "cpu")
    policies = (QuantPolicy.binary(), QuantPolicy.quantized(4))
    packed = [converter.convert(params, pol)[0] for pol in policies]
    t = x.shape[0] * x.shape[1]
    xs = torch.from_numpy(np.random.default_rng(8).uniform(
        -0.5, 1.5, (t * cfg.top_k, cfg.d_model)).astype(np.float32))
    gs = torch.zeros(cfg.e, dtype=torch.int64)
    gs[:3] = torch.tensor([t, 0, t * cfg.top_k - t - 2])  # 2 rows past

    def sync(*_a, **_k):
        raise AssertionError("host sync on the packed MoE path")

    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, sync)
    monkeypatch.setattr(torch, "nonzero", sync)
    ys = []
    with torch.inference_mode():
        for pol, p in zip(policies, packed):
            for backend in ("vpu", "mxu"):
                ctx = QCtx(policy=pol, compute_dtype=torch.float32,
                           gemm_config=GemmConfig(backend=backend))
                ys.append(mlp.moe_apply(p, torch.from_numpy(x), cfg, ctx,
                                        "layers/1/moe")[0])
            w = p["experts"]["up_packed"]
            for backend in ("vpu", "mxu"):  # tight: the route-first prologue
                ys.append(dispatch.quant_gemm_grouped(
                    xs, w, gs, k_true=cfg.d_model, expert_capacity=2,
                    config=GemmConfig(backend=backend), w_bits=pol.w_bits,
                    a_bits=pol.a_bits))
    monkeypatch.undo()
    assert len(ys) == 8 and all(torch.isfinite(y).all() for y in ys)


def test_mlp_no_unpack_on_expert_weights():
    """The 32x traffic win: nn/mlp.py never unpacks packed expert weights
    (the dispatch layer owns the packed contraction)."""
    src = inspect.getsource(mlp)
    assert "unpack" not in src and "quant_gemm_grouped" in src


def test_later_slice_paths_raise():
    cfg, _, host, x = _moe_setup("deepseek-moe-16b")
    params = params_from_numpy(host, "cpu")
    ctx = dataclasses.replace(_ctxs("vpu")[1], mesh=object())
    with pytest.raises(NotImplementedError, match="slice 6"):
        mlp.moe_apply(params, torch.from_numpy(x), cfg, ctx, "layers/1/moe")


# --------------------------------------------------------------------------
# the model and the scheduler
# --------------------------------------------------------------------------


@pytest.mark.parametrize("quant,backend", [("fakequant", "vpu"),
                                           ("packed", "vpu"),
                                           ("packed", "mxu")])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_logits_match_jax(arch, quant, backend, smoke_params):
    """Prefill, three decode steps and the full forward (with its summed
    aux loss) against the JAX package."""
    host, jpacked = smoke_params[arch]
    p = jpacked if quant == "packed" else host
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    jcfg, cfg = jregistry.get(arch).smoke, registry.get(arch).smoke
    jctx, ctx = _ctxs(backend)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 7))
    jl, jcache = jlm.prefill(jp, jcfg, jctx, jnp.asarray(tokens, jnp.int32),
                             cache_len=16)
    with torch.inference_mode():
        tl, tcache = lm.prefill(tp, cfg, ctx, torch.from_numpy(tokens),
                                cache_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = np.array([7, 5], np.int32)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(3):
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
    assert float(aux) > 0


LENS = (5, 5, 8, 3, 8, 5)  # same-length prefill runs + slot recycling


def _prompts(vocab: int):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in LENS]


def _serve(mod, eng, prompts):
    sched = mod.Scheduler(eng)
    for p in prompts:
        sched.submit(mod.Request(prompt=p))
    return sched.run(), sched.stats


def _port_engine(params, backend, arch="deepseek-moe-16b", **ecfg):
    spec = registry.get(arch)
    return engine.Engine(spec, spec.smoke, _ctxs(backend)[1], params,
                         engine.EngineConfig(**ecfg))


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_scheduler_greedy_streams_match_jax(backend, smoke_params):
    _, jpacked = smoke_params["deepseek-moe-16b"]
    spec = jregistry.get("deepseek-moe-16b")
    prompts = _prompts(spec.smoke.vocab_size)
    ecfg = dict(batch=2, cache_len=24, max_new_tokens=5)
    jeng = jengine.Engine(spec, spec.smoke, _ctxs(backend)[0],
                          jax.tree.map(jnp.asarray, jpacked),
                          jengine.EngineConfig(**ecfg))
    want, jstats = _serve(jengine, jeng, prompts)
    got, stats = _serve(engine, _port_engine(
        params_from_numpy(jpacked, "cpu"), backend, **ecfg), prompts)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert (stats.steps, stats.prefills, stats.admissions) == (
        jstats.steps, jstats.prefills, jstats.admissions)


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_packed_equals_fakequant_and_per_request(arch, smoke_params):
    """On the port: packed ``vpu`` and ``mxu`` greedy streams equal
    fake-quant's, a second run repeats the first, and streams served four
    slots at a time equal streams served one request at a time."""
    host, _ = smoke_params[arch]
    params = params_from_numpy(host, "cpu")
    packed, _ = converter.convert(params, QuantPolicy.binary())
    prompts = _prompts(registry.get(arch).smoke.vocab_size)
    ecfg = dict(cache_len=24, max_new_tokens=6)
    want, _ = _serve(engine, _port_engine(params, "vpu", arch, batch=4,
                                          **ecfg), prompts)
    runs = [_serve(engine, _port_engine(packed, backend, arch, batch=b,
                                        **ecfg), prompts)[0]
            for backend, b in (("vpu", 4), ("vpu", 4), ("mxu", 4),
                               ("vpu", 1))]
    for got in runs:
        assert sorted(got) == list(range(len(prompts)))
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("arch,backend", [("deepseek-moe-16b", "vpu"),
                                          ("deepseek-moe-16b", "mxu"),
                                          ("qwen2-moe-a2.7b", "vpu")])
def test_serve_launcher_moe_checks_fakequant(arch, backend, capsys):
    out = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--backend", backend, "--prompts", "2",
                          "--prompt-len", "4", "--new-tokens", "3",
                          "--cache-len", "16", "--check-fakequant"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    assert f"{arch}: 2 layers" in text
    assert "packed == fake-quant: True" in text
