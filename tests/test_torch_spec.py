"""PyTorch port vs the JAX package: speculative decoding on the granite-3-2b
smoke config.

* The rollback and window primitives: the contiguous ``fill_window`` at
  C 2 / 3 / 5 with write-masked rows and ``truncate`` on both layouts
  (a shared-prefix block, a -1 table entry, rows that must not roll back),
  at every KV tier.  Leaves are bit-identical to JAX's, except the 1-bit
  alpha, a mean over Dh that the packages sum in another order (within 4
  fp32 ulps, as tests/test_torch_paged.py holds it); the port's window write
  itself is checked exact against its own encoding.
* ``lm.decode_window(logits_all=True)`` and ``lm.cache_truncate`` at
  tests/test_torch_lm.py's tolerance, and ``converter.derive_draft``.
* The scheduler with a w1a1 1-layer draft: greedy streams identical to the
  JAX scheduler's speculative streams and to the port's own target-only
  streams, with JAX's ``spec_*`` counters, on both KV layouts, spec_len 1
  and 3, for 1-bit ``vpu`` / ``mxu``, w4a4 ``vpu`` and paged fused targets
  (fp and int8 KV); the forced accept / reject cases; the validation
  errors; and the launcher's ``--draft`` / ``--request-stream`` /
  ``--temperature`` / ``--eos-id`` flags.

Denormals are flushed and the tests compute on one thread, as in
tests/test_torch_lm.py.
"""

import argparse
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
from repro_torch.kernels.dispatch import GemmConfig, backend_names
from repro_torch.launch import cli
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm, registry
from repro_torch.nn import attention
from repro_torch.nn.common import QCtx
from repro_torch.serve import engine

NO_TRUNC = engine.Scheduler.NO_TRUNC
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_lm.py's logits tolerance
PAGED = dict(kv_block_size=8, prefill_chunk=4, shared_prefix=True)
SPEC = registry.get("granite-3-2b")
JSPEC = jregistry.get("granite-3-2b")


@pytest.fixture(autouse=True)
def flush_denormals():
    """Match XLA's CPU denormal flush for one test, on the calling thread
    alone (tests/test_torch_lm.py explains why)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _np(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_leaves_equal(got: dict, want: dict):
    """Bit-identical leaves (uint32 through an int32 view), the 1-bit
    alpha within 4 ulps."""
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = _np(got[name]), _np(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in ("k_scale", "v_scale", "pool_ks", "pool_vs") and (
                w.ndim == 3):
            np.testing.assert_array_max_ulp(g, w, maxulp=4)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _layouts(layout: str, kv_bits, block_size: int = 4):
    if layout == "paged":
        return (jattn.PagedKVCache(block_size=block_size, kv_bits=kv_bits),
                attention.PagedKVCache(block_size=block_size, kv_bits=kv_bits))
    return (jattn.ContiguousKVCache(kv_bits=kv_bits),
            attention.ContiguousKVCache(kv_bits=kv_bits))


def _attn_cfgs(kvh=2, dh=16):
    return (jattn.AttnConfig(d_model=32, n_heads=4, n_kv_heads=kvh, d_head=dh),
            attention.AttnConfig(d_model=32, n_heads=4, n_kv_heads=kvh,
                                 d_head=dh))


def _random_state(tkv, tcfg, b, cache_len, rng, table=None):
    """A port cache whose every leaf holds random values of its dtype, and
    the same leaves as JAX arrays."""
    tc = tkv.init(b, tcfg, cache_len, torch.float32, "cpu")
    for name, leaf in tc.items():
        if name == "table":
            leaf.copy_(torch.from_numpy(table))
        elif name in ("slot_pos", "pool_pos"):
            span = cache_len if name == "slot_pos" else cache_len * b
            leaf.copy_(torch.from_numpy(rng.integers(
                -1, span, leaf.shape).astype(np.int32)))
        elif leaf.dtype == torch.float32:
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(leaf.shape).astype(np.float32)))
        else:
            info = torch.iinfo(leaf.dtype)
            leaf.copy_(torch.from_numpy(rng.integers(
                info.min, info.max + 1, leaf.shape)).to(leaf.dtype))
    return tc, {k: jnp.asarray(v.numpy()) for k, v in tc.items()}


# ---------------------------------------------------------------------------
# rollback and window primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_bits", [None, 8, 1])
@pytest.mark.parametrize("c", [2, 3, 5])
def test_contiguous_fill_window_matches_jax(c, kv_bits):
    """The index write equals JAX's one-hot einsum write: per-row window
    starts (one wrapping the ring), a write-masked row left untouched, every
    leaf; and it is exactly the port's own encoding placed at ``pos %
    cache_len``."""
    b, cache_len, kvh, dh = 3, 16, 2, 16
    jkv, tkv = _layouts("contiguous", kv_bits)
    _, tcfg = _attn_cfgs(kvh, dh)
    rng = np.random.default_rng([c, kv_bits or 0])
    tc, jc = _random_state(tkv, tcfg, b, cache_len, rng)
    before = {k: v.clone() for k, v in tc.items()}
    k = rng.standard_normal((b, c, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, c, kvh, dh)).astype(np.float32)
    pos = (np.array([3, 9, 14], np.int32)[:, None]
           + np.arange(c, dtype=np.int32))
    wm = np.array([True, False, True])
    jc = jkv.fill_window(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                         jnp.asarray(wm))
    got = tkv.fill_window(tc, torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(pos), torch.from_numpy(wm))
    assert got is tc  # written in place
    _assert_leaves_equal(tc, jc)
    enc = {**tkv._encode(torch.from_numpy(k), torch.from_numpy(v)),
           "slot_pos": torch.from_numpy(pos)}
    for name, leaf in tc.items():
        want = before[name].clone()
        for row in (0, 2):
            for j in range(c):
                want[row, pos[row, j] % cache_len] = enc[name][row, j]
        assert torch.equal(leaf, want), name


def test_fill_window_negative_zero_is_the_only_difference():
    """JAX's one-hot einsum write adds the other window tokens' +0 products
    to each stored value, which turns a -0.0 into +0.0; the port's index
    write keeps -0.0.  The values are equal, and so is attention over
    them (ROADMAP C)."""
    jkv, tkv = _layouts("contiguous", None)
    jcfg, tcfg = _attn_cfgs(kvh=2, dh=8)
    k = np.ones((1, 2, 2, 8), np.float32)
    k[0, 0, 0, 0] = -0.0
    pos = np.array([[2, 3]], np.int32)
    jc = jkv.fill_window(jkv.init(1, jcfg, 8, jnp.float32), jnp.asarray(k),
                         jnp.asarray(k), jnp.asarray(pos))
    tc = tkv.fill_window(tkv.init(1, tcfg, 8, torch.float32, "cpu"),
                         torch.from_numpy(k), torch.from_numpy(k),
                         torch.from_numpy(pos))
    jk, tk = np.asarray(jc["k"]), tc["k"].numpy()
    np.testing.assert_array_equal(tk, jk)  # equal values
    assert np.signbit(tk[0, 2, 0, 0]) and not np.signbit(jk[0, 2, 0, 0])
    differs = tk.view(np.int32) != jk.view(np.int32)
    assert differs.sum() == 1 and differs[0, 2, 0, 0]


@pytest.mark.parametrize("kv_bits", [None, 8, 1])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_truncate_matches_jax(layout, kv_bits):
    """Rollback flips exactly the positions at or past each row's length
    (JAX's leaves bit for bit); ``NO_TRUNC`` rows are untouched.  Paged: a
    block shared by slots 0 and 1 keeps its positions (both lengths lie past
    it), a -1 table entry is dropped, blocks no slot maps are untouched, and
    nothing but ``pool_pos`` changes.  Then the rolled-back range, rewritten
    with the same tokens, gives the cache bytes from before the rollback."""
    b, cache_len, bs = 3, 16, 4
    jkv, tkv = _layouts(layout, kv_bits, bs)
    _, tcfg = _attn_cfgs()
    rng = np.random.default_rng([kv_bits or 0, layout == "paged"])
    table = None
    if layout == "paged":
        # 12 blocks over 3 slots + 3 spare: block 7 shared by slots 0 and 1,
        # slot 2's third entry unmapped
        table = np.array([[7, 1, 2, 3], [7, 4, 5, 6], [8, 9, -1, 10]],
                         np.int32)
    tc, jc = _random_state(tkv, tcfg, b, cache_len, rng, table)
    if layout == "paged":
        # positions as the allocator lays them out: slot-local, in order
        pp = tc["pool_pos"]
        for row in range(b):
            for j, blk in enumerate(table[row]):
                if blk >= 0:
                    pp[blk] = torch.arange(j * bs, (j + 1) * bs)
        jc["pool_pos"] = jnp.asarray(pp.numpy())
    lengths = np.array([6, NO_TRUNC, 2], np.int32)
    before = {k: v.clone() for k, v in tc.items()}
    jc = jkv.truncate(jc, jnp.asarray(lengths))
    assert tkv.truncate(tc, torch.from_numpy(lengths)) is tc
    _assert_leaves_equal(tc, jc)
    for name in tc:
        if name not in ("slot_pos", "pool_pos"):
            assert torch.equal(tc[name], before[name]), name
    if layout == "paged":
        pp = tc["pool_pos"]
        assert pp[7].tolist() == [0, 1, 2, 3]  # shared prefix block intact
        assert pp[1].tolist() == [4, 5, -1, -1]  # slot 0 rolled back at 6
        assert torch.equal(pp[4:7], before["pool_pos"][4:7])  # NO_TRUNC row
        assert pp[8].tolist() == [0, 1, -1, -1] and (pp[9] == -1).all()
        assert torch.equal(pp[11:], before["pool_pos"][11:])  # unmapped
    else:
        sp, old = tc["slot_pos"], before["slot_pos"]
        assert torch.equal(sp[1], old[1])
        assert torch.equal(sp[0], torch.where(old[0] >= 6, -1, old[0]))

    # rewrite a rolled-back range with the same tokens: the original bytes
    k = rng.standard_normal((1, 5, 2, 16)).astype(np.float32)
    pos = torch.arange(2, 7, dtype=torch.int32)[None]
    one = tkv.init(1, tcfg, cache_len, torch.float32, "cpu")
    if layout == "paged":
        one["table"].copy_(torch.tensor([[0, 1, 2, 3]], dtype=torch.int32))
    kt = torch.from_numpy(k)
    tkv.fill_window(one, kt, -kt, pos)
    full = {name: leaf.clone() for name, leaf in one.items()}
    tkv.truncate(one, torch.tensor([4], dtype=torch.int32))
    tkv.fill_window(one, kt[:, 2:], -kt[:, 2:], pos[:, 2:])
    for name in one:
        assert torch.equal(one[name], full[name]), name


def _smoke_params(policy, seed=4):
    host = jax.tree.map(np.asarray,
                        jlm.init(jax.random.PRNGKey(seed), JSPEC.smoke))
    if policy is None:
        return host
    packed, _ = jconverter.convert(host, policy)
    return jax.tree.map(np.asarray, packed)


@pytest.mark.parametrize("paged,fused,kv_bits,quant,backend", [
    (False, False, None, "binary", "vpu"),
    (False, False, None, "w4a4", "mxu"),
    (True, True, 8, "binary", "vpu"),
])
def test_decode_window_logits_all_and_cache_truncate_match_jax(
        paged, fused, kv_bits, quant, backend):
    """A 3-token verify window at per-row starts after two prefilled
    prompts: every position's logits (B, C, V) at tests/test_torch_lm.py's
    tolerance, the last row equal to ``logits_all=False``'s, then
    ``cache_truncate`` to ragged lengths leaves JAX's positions."""
    jpol, pol = ((JQuantPolicy.binary(), QuantPolicy.binary())
                 if quant == "binary" else
                 (JQuantPolicy.quantized(4), QuantPolicy.quantized(4)))
    host = _smoke_params(jpol)
    jcfg, cfg = JSPEC.smoke, SPEC.smoke
    if fused or kv_bits:
        jcfg = dataclasses.replace(jcfg, attn=dataclasses.replace(
            jcfg.attn, fused_attn=fused, kv_bits=kv_bits))
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, fused_attn=fused, kv_bits=kv_bits))
    jctx = JQCtx(policy=jpol, compute_dtype=jnp.float32,
                 gemm_config=JGemmConfig(backend=backend))
    ctx = QCtx(policy=pol, compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend=backend))
    jp, tp = jax.tree.map(jnp.asarray, host), params_from_numpy(host, "cpu")
    cache_len, b = 16, 2
    if paged:
        jkv = jattn.PagedKVCache(block_size=4, kv_bits=kv_bits)
        tkv = attention.PagedKVCache(block_size=4, kv_bits=kv_bits)
    else:
        jkv = jattn.ContiguousKVCache(kv_bits=kv_bits)
        tkv = attention.ContiguousKVCache(kv_bits=kv_bits)
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, jcfg.vocab_size, (b, 6)).astype(np.int32)
    jc = jlm.init_cache(jcfg, b, cache_len, jnp.float32, kv=jkv)
    tc = lm.init_cache(cfg, b, cache_len, torch.float32, "cpu", kv=tkv)
    if paged:
        table = np.array([[3, 1, 0, 2], [7, 6, 4, 5]], np.int32)
        jc = {"layers": [{**lc, "table": jnp.asarray(table)}
                         for lc in jc["layers"]]}
        for lc in tc["layers"]:
            lc["table"].copy_(torch.from_numpy(table))
    _, jsub = jlm.prefill(jp, jcfg, jctx, jnp.asarray(prompts),
                          cache_len=cache_len)
    jc = jlm.cache_insert(jc, jsub, jnp.asarray([0, 1], jnp.int32), jkv)
    with torch.inference_mode():
        _, tsub = lm.prefill(tp, cfg, ctx, torch.from_numpy(prompts).long(),
                             cache_len=cache_len)
        lm.cache_insert(tc, tsub, torch.tensor([0, 1]), tkv)
    win = rng.integers(0, jcfg.vocab_size, (b, 3)).astype(np.int32)
    start = np.array([6, 4], np.int32)  # row 1 rewrites part of its prompt
    wm = np.array([True, True])
    jl, jc = jlm.decode_window(jp, jcfg, jctx, jc, jnp.asarray(win),
                               jnp.asarray(start), jkv,
                               write_mask=jnp.asarray(wm), logits_all=True)
    with torch.inference_mode():
        tl, tc = lm.decode_window(tp, cfg, ctx, tc,
                                  torch.from_numpy(win).long(),
                                  torch.from_numpy(start), tkv,
                                  write_mask=torch.from_numpy(wm),
                                  logits_all=True)
    assert tl.shape == (b, 3, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    lengths = np.array([7, NO_TRUNC], np.int32)
    jc = jlm.cache_truncate(jcfg, jc, jnp.asarray(lengths), jkv)
    lm.cache_truncate(cfg, tc, torch.from_numpy(lengths), tkv)
    pos_leaf = "pool_pos" if paged else "slot_pos"
    for tl_, jl_ in zip(tc["layers"], jc["layers"]):
        np.testing.assert_array_equal(tl_[pos_leaf].numpy(),
                                      np.asarray(jl_[pos_leaf]))
    with pytest.raises(ValueError, match="pure-attention"):
        lm.cache_truncate(cfg, {"layers": [{"h": torch.zeros(1)}]},
                          torch.from_numpy(lengths))


def test_derive_draft_matches_jax():
    """The leading layers, packed at w1a1 by default, leaf for leaf as the
    JAX converter packs them; depth defaults to a quarter (at least 1), a
    depth outside [1, total] raises, ``keep_float`` keeps the float weights
    and the draft keeps the target's embedding."""
    host = _smoke_params(None)
    tparams = params_from_numpy(host, "cpu")
    jd, jdcfg, jrep = jconverter.derive_draft(host, JSPEC.smoke)
    td, tdcfg, trep = converter.derive_draft(tparams, SPEC.smoke)
    assert tdcfg.n_layers == jdcfg.n_layers == max(1, SPEC.smoke.n_layers // 4)
    assert tdcfg == dataclasses.replace(SPEC.smoke, n_layers=1)
    assert (trep.n_packed, trep.bytes_after) == (jrep.n_packed,
                                                 jrep.bytes_after)
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: x.numpy(), td))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jd)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, w) in zip(flat_t, flat_j):
        np.testing.assert_array_equal(_np(a), _np(w), err_msg=str(path))
    assert td["embed"]["table"] is tparams["embed"]["table"]
    kd, _, _ = converter.derive_draft(tparams, SPEC.smoke, n_layers=2,
                                      keep_float=True)
    assert len(kd["layers"]) == 2
    assert kd["layers"][1]["attn"]["q"]["w"] is tparams["layers"][1]["attn"]["q"]["w"]
    assert "w_packed" in kd["layers"][1]["attn"]["q"]
    for bad in (0, SPEC.smoke.n_layers + 1):
        with pytest.raises(ValueError, match="n_layers"):
            converter.derive_draft(tparams, SPEC.smoke, n_layers=bad)


# ---------------------------------------------------------------------------
# the speculative scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """(float params, packed params by quant, the w1a1 1-layer draft as
    numpy, prompts with a shared 9-token prefix).  Two prompt lengths keep
    the JAX package's compiles few; the budgets (``BUDGETS``) make slots
    retire and recycle at different rounds."""
    host = _smoke_params(None)
    packed = {"binary": _smoke_params(JQuantPolicy.binary()),
              "w4a4": _smoke_params(JQuantPolicy.quantized(4))}
    draft, _, _ = jconverter.derive_draft(host, JSPEC.smoke, n_layers=1)
    draft = jax.tree.map(np.asarray, draft)
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, JSPEC.smoke.vocab_size, (9,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, JSPEC.smoke.vocab_size, (n,)).astype(np.int32)])
        for n in (3, 3, 5, 5)]
    return host, packed, draft, prompts


def _policies(quant):
    if quant == "binary":
        return JQuantPolicy.binary(), QuantPolicy.binary()
    return JQuantPolicy.quantized(4), QuantPolicy.quantized(4)


BUDGETS = (6, 3, 5, 6)  # max_new_tokens per request


def _run(mod, eng, prompts, budgets=BUDGETS):
    sched = mod.Scheduler(eng)
    for p, n in zip(prompts, budgets):
        sched.submit(mod.Request(prompt=p, max_new_tokens=n))
    return sched.run(), sched


def _port_engine(params, quant="binary", backend="vpu", draft=None, **ecfg):
    ctx = QCtx(policy=_policies(quant)[1], compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend=backend))
    if draft is not None:
        dcfg, dparams = draft
        draft = engine.DraftModel(cfg=dcfg, params=dparams, ctx=dataclasses.replace(
            ctx, policy=QuantPolicy.binary()))
    return engine.Engine(SPEC, SPEC.smoke, ctx, params,
                         engine.EngineConfig(draft=draft, **ecfg))


def _counters(stats):
    return (stats.spec_rounds, stats.spec_proposed, stats.spec_accepted,
            stats.steps, stats.prefills, stats.prefill_tokens,
            stats.shared_tokens, stats.admissions)


@pytest.mark.parametrize("paged,fused,kv_bits,quant,backend,spec_len", [
    (False, False, None, "binary", "vpu", 1),
    (False, False, None, "binary", "mxu", 3),
    (False, False, None, "w4a4", "vpu", 3),
    (True, False, None, "binary", "vpu", 3),
    (True, True, None, "binary", "vpu", 1),
    (True, True, 8, "binary", "mxu", 3),
])
def test_spec_streams_match_jax_and_target_only(smoke, paged, fused, kv_bits,
                                                quant, backend, spec_len):
    """4 requests on 2 slots (slot recycling, retirement inside a round,
    shared-prefix blocks on the paged layout, block 8, chunk 4): the port's
    speculative greedy streams equal the JAX scheduler's speculative streams
    and the port's target-only streams; the ``spec_*`` counters, verify
    steps and prefill counters equal JAX's; every block is released."""
    _, packed, draft, prompts = smoke
    jpol, _ = _policies(quant)
    ecfg = dict(batch=2, cache_len=32, max_new_tokens=6, fused_attn=fused,
                kv_bits=kv_bits, spec_len=spec_len, **(PAGED if paged else {}))
    jctx = JQCtx(policy=jpol, compute_dtype=jnp.float32,
                 gemm_config=JGemmConfig(backend=backend))
    jdraft = jengine.DraftModel(
        cfg=dataclasses.replace(JSPEC.smoke, n_layers=1),
        params=jax.tree.map(jnp.asarray, draft),
        ctx=dataclasses.replace(jctx, policy=JQuantPolicy.binary()))
    jeng = jengine.Engine(JSPEC, JSPEC.smoke, jctx,
                          jax.tree.map(jnp.asarray, packed[quant]),
                          jengine.EngineConfig(draft=jdraft, **ecfg))
    want, jsched = _run(jengine, jeng, prompts)

    tparams = params_from_numpy(packed[quant], "cpu")
    tdraft = (dataclasses.replace(SPEC.smoke, n_layers=1),
              params_from_numpy(draft, "cpu"))
    teng = _port_engine(tparams, quant, backend, tdraft, **ecfg)
    assert teng.speculative and teng.paged == paged
    assert not teng.dcfg.attn.fused_attn and teng.dcfg.attn.kv_bits is None
    got, sched = _run(engine, teng, prompts)
    ecfg.pop("spec_len")
    ref, _ = _run(engine, _port_engine(tparams, quant, backend, **ecfg),
                  prompts)
    assert sorted(got) == sorted(want) == sorted(ref) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        np.testing.assert_array_equal(got[rid], ref[rid])
    assert _counters(sched.stats) == _counters(jsched.stats)
    assert sched.last_stats is sched.stats
    assert sched.stats.spec_proposed == spec_len * sched.stats.spec_rounds > 0
    if paged:
        assert sched.stats.shared_tokens > 0
        assert sched.alloc.live_blocks == 0


@pytest.mark.parametrize("paged", [False, True])
def test_spec_forced_accept_all(smoke, paged):
    """Draft == target: every proposal is the target's own pick, so the
    acceptance is exactly 1.0, each round emits spec_len + 1 tokens, and
    there are fewer verify rounds than target-only decode steps."""
    _, packed, _, prompts = smoke
    tparams = params_from_numpy(packed["binary"], "cpu")
    ecfg = dict(batch=2, cache_len=32, max_new_tokens=7,
                **(PAGED if paged else {}))
    ref, rsched = _run(engine, _port_engine(tparams, **ecfg), prompts)
    got, sched = _run(engine, _port_engine(
        tparams, draft=(SPEC.smoke, tparams), spec_len=3, **ecfg), prompts)
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
    assert sched.stats.acceptance_rate == 1.0
    assert sched.stats.steps < rsched.stats.steps


def test_spec_forced_reject_rolls_back(smoke):
    """A doomed draft (a zeroed tied embedding makes every logit equal, so
    it always proposes token 0) forces a rollback nearly every round; the
    streams stay the target's, one token a round at worst."""
    _, packed, draft, prompts = smoke
    tparams = params_from_numpy(packed["binary"], "cpu")
    dparams = params_from_numpy(draft, "cpu")
    dparams["embed"] = {"table": torch.zeros_like(dparams["embed"]["table"])}
    ecfg = dict(batch=2, cache_len=32, max_new_tokens=6)
    ref, _ = _run(engine, _port_engine(tparams, **ecfg), prompts)
    got, sched = _run(engine, _port_engine(
        tparams, draft=(dataclasses.replace(SPEC.smoke, n_layers=1), dparams),
        spec_len=2, **ecfg), prompts)
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
    st = sched.stats
    assert st.acceptance_rate < 0.5 and st.spec_accepted < st.spec_proposed
    assert st.spec_rounds >= sum(len(v) for v in ref.values()) / 3


def test_spec_validation(smoke):
    """Greedy only (engine- and request-level temperature), spec_len >= 1,
    the draft's vocabulary, and the cache headroom at admission: all
    loud."""
    _, packed, draft, _ = smoke
    tparams = params_from_numpy(packed["binary"], "cpu")
    d = (dataclasses.replace(SPEC.smoke, n_layers=1),
         params_from_numpy(draft, "cpu"))
    with pytest.raises(ValueError, match="greedy-only"):
        _port_engine(tparams, draft=d, batch=2, cache_len=32,
                     max_new_tokens=4, temperature=0.7)
    with pytest.raises(ValueError, match="greedy-only"):
        _port_engine(tparams, draft=d, batch=2, cache_len=32,
                     max_new_tokens=4,
                     sampling=engine.SamplingParams(temperature=0.5))
    with pytest.raises(ValueError, match="spec_len"):
        _port_engine(tparams, draft=d, batch=2, cache_len=32,
                     max_new_tokens=4, spec_len=0)
    with pytest.raises(ValueError, match="vocabulary"):
        _port_engine(tparams, draft=(dataclasses.replace(
            d[0], vocab_size=1000), d[1]), batch=2, cache_len=32)
    eng = _port_engine(tparams, draft=d, batch=2, cache_len=32,
                       max_new_tokens=6, spec_len=2)
    sched = engine.Scheduler(eng)
    sched.submit(engine.Request(prompt=np.zeros((25,), np.int32)))
    with pytest.raises(ValueError, match="cache_len"):
        sched.run()  # 25 + 6 + 2 > 32: the verify window would overflow
    sched = engine.Scheduler(eng)
    sched.submit(engine.Request(prompt=np.zeros((4,), np.int32),
                                sampling=engine.SamplingParams(
                                    temperature=1.0)))
    with pytest.raises(ValueError, match="greedy-only"):
        sched.run()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SERVE = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu", "--prompts",
         "2", "--prompt-len", "6", "--new-tokens", "5", "--cache-len", "24",
         "--request-stream"]


def test_serve_launcher_spec_request_stream(capsys):
    """``--draft w1a1 --spec-len 2 --request-stream`` serves 2 x --prompts
    mixed-length requests with the streams of the same launch without
    ``--draft``, and prints the served / speculative / latency lines."""
    ref = serve_cli.main(SERVE)
    capsys.readouterr()
    got = serve_cli.main(SERVE + ["--draft", "w1a1", "--spec-len", "2"])
    text = capsys.readouterr().out
    assert sorted(got) == sorted(ref) == [0, 1, 2, 3]
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
    assert "speculative draft: 1/2 layers (w1a1), spec_len=2" in text
    assert "served 4 requests (prompt lens 2-6) on 2 slots" in text
    assert "speculative: " in text and "proposals accepted" in text
    assert "per-token latency: p50" in text
    paged = serve_cli.main(SERVE + ["--draft", "fp", "--kv-block-size", "4",
                                    "--prefill-chunk", "3", "--shared-prefix",
                                    "--fused-attn", "--kv-bits", "8",
                                    "--check-fakequant"])
    text = capsys.readouterr().out
    assert "paged KV: " in text and "packed == fake-quant: True" in text
    assert all(len(v) == 5 for v in paged.values())


def test_serve_launcher_temperature_and_eos(capsys):
    """``--draft`` with ``--temperature 0.5`` stops on the greedy-only
    error; ``--eos-id`` retires a slot the step it emits that token."""
    with pytest.raises(ValueError, match="greedy-only"):
        serve_cli.main(SERVE + ["--draft", "w1a1", "--temperature", "0.5"])
    sampled = serve_cli.main(SERVE + ["--temperature", "0.5"])
    assert all(len(v) == 5 for v in sampled.values())
    ref = serve_cli.main(SERVE + ["--draft", "w1a1"])
    eos = int(ref[0][2])
    got = serve_cli.main(SERVE + ["--draft", "w1a1", "--eos-id", str(eos)])
    stop = int(np.argmax(ref[0] == eos))
    np.testing.assert_array_equal(got[0], ref[0][:stop + 1])
    assert len(got[0]) < 5
    capsys.readouterr()


def test_cli_flag_blocks():
    """The flag blocks parse into the GemmConfig the dispatch registry
    takes; the backend choices are the registry's names."""
    ap = argparse.ArgumentParser()
    cli.add_gemm_flags(ap, "--backend", "--xnor-backend")
    cli.add_attn_flags(ap)
    cli.add_spec_flags(ap)
    args = ap.parse_args(["--xnor-backend", "mxu-k4", "--jnp-prologue",
                          "--fused-attn", "--kv-bits", "8", "--draft", "w1a1",
                          "--spec-len", "4", "--draft-layers", "3"])
    assert cli.gemm_config_from_args(args) == GemmConfig(
        backend="mxu-k4", fused_prologue=False)
    assert (args.fused_attn, args.kv_bits, args.draft, args.spec_len,
            args.draft_layers) == (True, 8, "w1a1", 4, 3)
    defaults = ap.parse_args([])
    assert cli.gemm_config_from_args(defaults) == GemmConfig()
    assert (defaults.draft, defaults.spec_len, defaults.draft_layers) == (
        None, 2, None)
    action = next(a for a in ap._actions if a.dest == "gemm_backend")
    assert action.choices == backend_names()
    assert {"vpu", "mxu", "xla", "vpu-k4", "mxu-k8"} <= set(backend_names())
    with pytest.raises(SystemExit):
        ap.parse_args(["--backend", "shard-vpu"])
