"""PyTorch port vs the JAX package: the dense deepseek-7b (MHA, untied head)
and qwen2-72b (GQA, QKV bias, rope_theta 1e6, untied head) on their smoke
configs, from the JAX package's own numpy params loaded into both.

* The configs equal the JAX package's field by field.
* ``forward`` logits and ``prefill`` + decode logits at fp32, fake-quant,
  packed 1-bit ``vpu`` / ``mxu`` and packed w4a4 (tolerance: fp32, rtol =
  atol = 1e-4, tests/test_torch_lm.py's: the integer GEMMs are exact in both
  packages, the float ops around them round in another order).
* Scheduler greedy streams: the port's packed 1-bit ``vpu`` / ``mxu`` and
  fake-quant streams equal the JAX scheduler's 1-bit streams, and its w4a4
  ``vpu`` / ``mxu`` streams the JAX w4a4 streams (exact).
* ``_sdpa_chunked`` against JAX's with small chunks (padded KV, -1
  positions, window, softcap, a row with no visible key), both held
  against ``_sdpa`` on rows that see a key; ``prefill`` and ``forward``
  with ``full_attn_max_seq`` lowered, so the chunked path runs, against
  JAX.
* ``lm.init_packed`` == ``converter.convert(lm.init(...))`` bit for bit,
  with its ``SizeReport`` and its draft tree (== ``derive_draft``).
* The serve launcher on qwen2-72b smoke with a w1a1 draft.

Denormals are flushed and the tests compute on one thread, as in
tests/test_torch_lm.py (see its docstring).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import converter as jconverter
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.kernels.dispatch import GemmConfig as JGemmConfig
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.nn import attention as jattn
from repro.nn.common import QCtx as JQCtx
from repro.serve import engine as jengine
from repro_torch.core import converter
from repro_torch.core.policy import QuantPolicy
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.dispatch import GemmConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm, registry
from repro_torch.nn import attention
from repro_torch.nn.common import QCtx
from repro_torch.serve import engine

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_lm.py's logits tolerance
# _sdpa_chunked against JAX's and against _sdpa: fp32 softmax attention
# summed in another order (chunk by chunk, rescaled), a few ulp of O(1)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("deepseek-7b", "qwen2-72b")
CACHE_LEN = 16
LENS = (5, 5, 8, 3, 8, 5)  # FIFO same-length runs + recycling on 2 slots


@pytest.fixture(autouse=True)
def flush_denormals():
    """Match XLA's CPU denormal flush for one test, on the calling thread
    alone (tests/test_torch_lm.py's fixture)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _policies(quant: str):
    """(JAX policy, port policy) for ``fp`` | ``binary`` | ``w4a4``."""
    if quant == "fp":
        return JQuantPolicy.full_precision(), QuantPolicy.full_precision()
    if quant == "binary":
        return JQuantPolicy.binary(), QuantPolicy.binary()
    return JQuantPolicy.quantized(4), QuantPolicy.quantized(4)


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(arch, JAX smoke cfg, port smoke cfg, numpy float params, numpy
    packed params by quant)."""
    arch = request.param
    jcfg = jregistry.get(arch).smoke
    host = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(3), jcfg))
    packed = {}
    for quant in ("binary", "w4a4"):
        p, _ = jconverter.convert(host, _policies(quant)[0])
        packed[quant] = jax.tree.map(np.asarray, p)
    return arch, jcfg, registry.get(arch).smoke, host, packed


def _ctxs(quant: str, backend: str):
    jpol, pol = _policies(quant)
    return (JQCtx(policy=jpol, compute_dtype=jnp.float32,
                  gemm_config=JGemmConfig(backend=backend)),
            QCtx(policy=pol, compute_dtype=torch.float32,
                 gemm_config=GemmConfig(backend=backend)))


def _params(smoke, variant: str):
    """Numpy params for ``fp`` / ``fakequant`` (float) or ``packed``."""
    _, _, _, host, packed = smoke
    if variant.startswith("packed"):
        return packed["w4a4" if variant.endswith("w4a4") else "binary"]
    return host


def _fields_equal(a, b, where: str) -> None:
    """Every field of the port's config dataclass ``a`` equals the JAX
    config ``b``'s field of that name (nested configs field by field)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _fields_equal(x, y, f"{where}.{f.name}")
        else:
            assert x == y, (f"{where}.{f.name}", x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    spec, jspec = registry.get(arch), jregistry.get(arch)
    assert (spec.arch_id, spec.family) == (jspec.arch_id, jspec.family)
    for a, b, which in ((spec.config, jspec.config, "config"),
                        (spec.smoke, jspec.smoke, "smoke")):
        _fields_equal(a, b, f"{arch}.{which}")
        assert not a.tie_embeddings and a.ffn_pattern == ("mlp",)
    full = spec.config
    if arch == "deepseek-7b":
        assert (full.n_layers, full.d_model, full.attn.n_heads,
                full.attn.n_kv_heads, full.attn.d_head, full.mlp.d_ff,
                full.vocab_size, full.attn.qkv_bias) == (
            30, 4096, 32, 32, 128, 11008, 102400, False)
    else:
        assert (full.n_layers, full.d_model, full.attn.groups,
                full.attn.d_head, full.mlp.d_ff, full.vocab_size,
                full.attn.qkv_bias, full.attn.rope_theta) == (
            80, 8192, 8, 128, 29568, 152064, True, 1e6)
        assert spec.smoke.attn.qkv_bias and spec.smoke.attn.groups == 2


@pytest.mark.parametrize("variant,quant,backend", [
    ("fp", "fp", "vpu"), ("fakequant", "binary", "vpu"),
    ("packed", "binary", "vpu"), ("packed", "binary", "mxu"),
    ("packed-w4a4", "w4a4", "vpu")])
def test_prefill_and_decode_logits_match_jax(smoke, variant, quant, backend):
    _, jcfg, cfg, _, _ = smoke
    host = _params(smoke, variant)
    jp, tp = jax.tree.map(jnp.asarray, host), params_from_numpy(host, "cpu")
    jctx, ctx = _ctxs(quant, backend)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 7))
    jl, jcache = jlm.prefill(jp, jcfg, jctx, jnp.asarray(tokens, jnp.int32),
                             cache_len=CACHE_LEN)
    with torch.inference_mode():
        tl, tcache = lm.prefill(tp, cfg, ctx, torch.from_numpy(tokens),
                                cache_len=CACHE_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = np.array([7, 5], np.int32)  # rows at different depths
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
        assert tl.shape == (2, 1, cfg.padded_vocab)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("variant,quant", [("fp", "fp"),
                                           ("packed", "binary")])
def test_forward_logits_match_jax(smoke, variant, quant):
    _, jcfg, cfg, _, _ = smoke
    host = _params(smoke, variant)
    jctx, ctx = _ctxs(quant, "vpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 9))
    jl, _ = jlm.forward(jax.tree.map(jnp.asarray, host), jcfg, jctx,
                        jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        tl, aux = lm.forward(params_from_numpy(host, "cpu"), cfg, ctx,
                             torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(aux) == 0.0


def _serve(mod, eng, prompts):
    sched = mod.Scheduler(eng)
    for p in prompts:
        sched.submit(mod.Request(prompt=p))
    return sched.run(), sched.stats


@pytest.mark.parametrize("quant", ["binary", "w4a4"])
def test_scheduler_greedy_streams_match_jax(smoke, quant):
    """The JAX scheduler's packed ``vpu`` streams are the reference; the
    port's packed ``vpu`` and ``mxu`` streams equal them, and at 1 bit so
    do the port's fake-quant streams (§2.2.2)."""
    arch, jcfg, cfg, host, packed = smoke
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32)
               for n in LENS]
    ecfg = dict(batch=2, cache_len=24, max_new_tokens=5)
    jctx, _ = _ctxs(quant, "vpu")
    jspec = jregistry.get(arch)
    want, jstats = _serve(jengine, jengine.Engine(
        jspec, jcfg, jctx, jax.tree.map(jnp.asarray, packed[quant]),
        jengine.EngineConfig(**ecfg)), prompts)
    runs = [("vpu", packed[quant]), ("mxu", packed[quant])]
    if quant == "binary":
        runs.append(("vpu", host))  # fake-quant
    for backend, p in runs:
        _, ctx = _ctxs(quant, backend)
        got, stats = _serve(engine, engine.Engine(
            registry.get(arch), cfg, ctx, params_from_numpy(p, "cpu"),
            engine.EngineConfig(**ecfg)), prompts)
        assert sorted(got) == sorted(want) == list(range(len(prompts)))
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])
        assert (stats.steps, stats.prefills) == (jstats.steps,
                                                 jstats.prefills)


def _chunked_case(cfg_kw: dict):
    """Small grouped attention operands: 8 query rows, 11 keys (padded to
    12 by chunks of 4), key 2 empty (position -1), and query row 0 at
    position 1, before every key's position, so it sees none."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 8, 2, 2, 16), np.float32)
    k = rng.standard_normal((2, 11, 2, 16), np.float32)
    v = rng.standard_normal((2, 11, 2, 16), np.float32)
    k_pos = np.tile(np.arange(3, 14, dtype=np.int32), (2, 1))
    k_pos[:, 2] = -1
    q_pos = np.tile(np.array([1, 6, 7, 8, 9, 10, 12, 13], np.int32), (2, 1))
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, chunk_q=4,
              chunk_kv=4, **cfg_kw)
    return (jattn.AttnConfig(**kw), attention.AttnConfig(**kw),
            (q, k, v, q_pos, k_pos))


@pytest.mark.parametrize("cfg_kw", [{}, dict(window=3),
                                    dict(logit_softcap=2.0),
                                    dict(window=5, logit_softcap=1.5,
                                         causal=False)])
def test_sdpa_chunked_matches_jax(cfg_kw):
    jcfg, cfg, arrays = _chunked_case(cfg_kw)
    want = np.asarray(jattn._sdpa_chunked(jcfg, *map(jnp.asarray, arrays)))
    q, k, v, q_pos, k_pos = map(torch.from_numpy, arrays)
    got = attention._sdpa_chunked(cfg, q, k, v, q_pos, k_pos)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    # _sdpa on the rows that see a key (a row that sees none is junk: the
    # chunked path averages every chunk's values, padding included)
    mask = attention._mask(cfg, q_pos, k_pos)
    full = attention._sdpa(cfg, q, k, v, mask).numpy()
    seen = mask.any(-1).numpy()
    assert seen.any() and (not cfg.causal or not seen[:, 0].any())
    np.testing.assert_allclose(got.numpy()[seen], full[seen], **ATTN_TOL)
    np.testing.assert_allclose(want[seen], full[seen], **ATTN_TOL)
    # query rows must split into whole chunks
    with pytest.raises(ValueError, match="chunk_q"):
        attention._sdpa_chunked(dataclasses.replace(cfg, chunk_q=3), q, k, v,
                                q_pos, k_pos)


def _long(cfg, jcfg):
    """Both configs with ``full_attn_max_seq`` lowered to 8 and chunks of
    4 / 8, so a 16-token prompt takes ``_sdpa_chunked``."""
    kw = dict(full_attn_max_seq=8, chunk_q=4, chunk_kv=8)
    return (dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, **kw)),
            dataclasses.replace(jcfg, attn=dataclasses.replace(jcfg.attn,
                                                               **kw)))


@pytest.mark.parametrize("variant,quant", [("fp", "fp"),
                                           ("packed", "binary")])
def test_long_prefill_and_forward_match_jax(smoke, variant, quant):
    """``prefill`` (routed on S) and ``forward`` (routed on max(S, Sk))
    above ``full_attn_max_seq``: the same logits as JAX's chunked path and
    as the port's own unchunked path, and the same greedy tokens."""
    _, jcfg, cfg, _, _ = smoke
    lcfg, ljcfg = _long(cfg, jcfg)
    host = _params(smoke, variant)
    jp, tp = jax.tree.map(jnp.asarray, host), params_from_numpy(host, "cpu")
    jctx, ctx = _ctxs(quant, "vpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 16))
    jl, jcache = jlm.prefill(jp, ljcfg, jctx, jnp.asarray(tokens, jnp.int32),
                             cache_len=24)
    with torch.inference_mode():
        tl, tcache = lm.prefill(tp, lcfg, ctx, torch.from_numpy(tokens),
                                cache_len=24)
        short, _ = lm.prefill(tp, cfg, ctx, torch.from_numpy(tokens),
                              cache_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tl.numpy(), short.numpy(), **TOL)
    pos = np.full((2,), 16, np.int32)
    jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    ttok = tl[:, -1].argmax(-1).numpy().astype(np.int32)
    for _ in range(3):
        np.testing.assert_array_equal(ttok, jtok)
        jl, jcache = jlm.decode_step(jp, ljcfg, jctx, jcache,
                                     jnp.asarray(jtok)[:, None],
                                     jnp.asarray(pos))
        with torch.inference_mode():
            tl, tcache = lm.decode_step(tp, lcfg, ctx, tcache,
                                        torch.from_numpy(ttok)[:, None].long(),
                                        torch.from_numpy(pos))
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        ttok = tl[:, -1].argmax(-1).numpy().astype(np.int32)
        pos = pos + 1
    np.testing.assert_array_equal(ttok, jtok)
    jf, _ = jlm.forward(jp, ljcfg, jctx, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        tf, _ = lm.forward(tp, lcfg, ctx, torch.from_numpy(tokens))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)


def _assert_same_tree(a, b, where: str = "") -> None:
    """Same structure (dict keys in order, list lengths) and bit-identical
    leaves of the same dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for key in a:
            _assert_same_tree(a[key], b[key], f"{where}/{key}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}/{i}")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), where


@pytest.mark.parametrize("arch,quant", [
    ("granite-3-2b", "binary"), ("deepseek-moe-16b", "binary"),
    ("deepseek-moe-16b", "w4a4"), ("qwen2-72b", "binary"),
    ("qwen2-72b", "w4a4"), ("deepseek-7b", "binary")])
def test_init_packed_equals_convert_of_init(arch, quant):
    """One block at a time == the whole float model converted: the params
    bit for bit (tied and untied heads, MoE stacks whose k-bit codes are
    per tensor, QKV bias), the SizeReport leaf for leaf, and the draft
    tree == ``derive_draft`` at w1a1 and kept float, sharing the
    embedding, final norm and head with the target."""
    cfg = registry.get(arch).smoke
    policy = _policies(quant)[1]
    whole = lm.init(torch.Generator().manual_seed(6), cfg)
    want, want_rep = converter.convert(whole, policy)
    got, rep, none = lm.init_packed(torch.Generator().manual_seed(6), cfg,
                                    policy)
    assert none is None
    _assert_same_tree(got, want)
    assert rep.leaves == want_rep.leaves
    assert rep.bytes_fp32 == converter.model_nbytes(whole)
    for dpolicy in (QuantPolicy.binary(), QuantPolicy.full_precision()):
        ddraft, _, _ = converter.derive_draft(whole, cfg, n_layers=1,
                                              policy=dpolicy)
        got, _, draft = lm.init_packed(torch.Generator().manual_seed(6), cfg,
                                       policy, draft_layers=1,
                                       draft_policy=dpolicy)
        _assert_same_tree(got, want)
        _assert_same_tree(draft, ddraft)
        for key in ("embed", "final_norm", "lm_head"):
            if key in got:
                assert draft[key] is got[key] or all(
                    x is y for x, y in zip(draft[key].values(),
                                           got[key].values())), key
        # no target (it comes from a checkpoint): the same draft alone
        none_p, none_rep, alone = lm.init_packed(
            torch.Generator().manual_seed(6), cfg, None, draft_layers=1,
            draft_policy=dpolicy)
        assert none_p is None and none_rep is None
        _assert_same_tree(alone, ddraft)
    with pytest.raises(ValueError, match="n_layers"):
        lm.init_packed(torch.Generator(), cfg, policy,
                       draft_layers=cfg.n_layers + 1)


def test_serve_launcher_qwen2_72b_draft(capsys):
    """``--arch qwen2-72b --smoke --device cpu --draft w1a1``: the target
    and the draft come from ``init_packed``; the streams equal the same
    launch without a draft and the float model's (``--check-fakequant``
    draws it whole again from the seed)."""
    flags = ["--arch", "qwen2-72b", "--smoke", "--device", "cpu",
             "--prompts", "2", "--prompt-len", "6", "--new-tokens", "4",
             "--cache-len", "24"]
    ref = serve_cli.main(flags)
    text = capsys.readouterr().out
    assert "qwen2-72b: 2 layers, d_model 64" in text
    assert "(14 layers packed)" in text
    got = serve_cli.main(flags + ["--draft", "w1a1"])
    text = capsys.readouterr().out
    assert "speculative draft: 1/2 layers (w1a1), spec_len=2" in text
    assert sorted(got) == sorted(ref) == [0, 1]
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
    checked = serve_cli.main(flags + ["--draft", "w1a1",
                                      "--check-fakequant"])
    assert "packed == fake-quant: True" in capsys.readouterr().out
    for rid in ref:
        np.testing.assert_array_equal(checked[rid], ref[rid])


def test_serve_launcher_packed_target_with_draft(tmp_path, capsys):
    """``--packed PATH --draft w1a1`` on qwen2-72b smoke: the target comes
    from the file (the seeded model exported by ``export_packed``) and only
    the draft from ``init_packed``; the streams equal the seeded launch
    without a draft."""
    from repro_torch.ckpt import manager

    flags = ["--arch", "qwen2-72b", "--smoke", "--device", "cpu",
             "--prompts", "2", "--prompt-len", "6", "--new-tokens", "4",
             "--cache-len", "24"]
    ref = serve_cli.main(flags)
    capsys.readouterr()
    cfg = registry.get("qwen2-72b").smoke
    path = str(tmp_path / "qwen.npz")
    manager.export_packed(lm.init(torch.Generator().manual_seed(0), cfg),
                          QuantPolicy.binary(), path)
    got = serve_cli.main(flags + ["--packed", path, "--draft", "w1a1"])
    text = capsys.readouterr().out
    assert "loaded packed checkpoint" in text
    assert "speculative draft: 1/2 layers (w1a1), spec_len=2" in text
    assert sorted(got) == sorted(ref) == [0, 1]
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
