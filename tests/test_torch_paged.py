"""PyTorch port vs the JAX package: the paged KV cache, the block
allocator and the paged continuous-batching ``Scheduler`` (chunked prefill,
shared prefixes, write-masked decode), at every ``fused_attn`` x ``kv_bits``
setting, on the granite-3-2b smoke config.

The same numpy inputs and params go through both packages.  Cache leaves
must be bit-identical (codes, pools, positions, tables, int8 scales); the
1-bit alpha is a mean over Dh that the packages sum in another order, held
within 4 fp32 ulps (tests/test_torch_attn_decode.py).  Greedy streams and
the scheduler's prefill counters must be equal.  Denormals are flushed and
the tests compute on one thread, as in tests/test_torch_lm.py.
"""

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
from repro_torch.core.policy import QuantPolicy
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.dispatch import GemmConfig
from repro_torch.models import registry
from repro_torch.nn import attention
from repro_torch.nn.common import QCtx
from repro_torch.serve import engine

PAGED = dict(kv_block_size=4, prefill_chunk=5, shared_prefix=True)


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


def _assert_leaves_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g, w = got[name].numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        if name in ("pool_vs", "pool_ks", "k_scale", "v_scale") and g.ndim == 3:
            np.testing.assert_array_max_ulp(g, w, maxulp=4)  # 1-bit alpha
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# cache layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_bits", [None, 8, 1])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cache_ops_match_jax(layout, kv_bits):
    """insert -> write-masked decode fill -> (paged: window fill) -> reset
    leaves the same cache in both packages, and gathers the same view."""
    b, cache_len, bs, kvh, dh = 3, 16, 4, 2, 16
    jcfg = jattn.AttnConfig(d_model=32, n_heads=4, n_kv_heads=kvh, d_head=dh)
    tcfg = attention.AttnConfig(d_model=32, n_heads=4, n_kv_heads=kvh,
                                d_head=dh)
    if layout == "paged":
        jkv = jattn.PagedKVCache(block_size=bs, kv_bits=kv_bits)
        tkv = attention.PagedKVCache(block_size=bs, kv_bits=kv_bits)
    else:
        jkv = jattn.ContiguousKVCache(kv_bits=kv_bits)
        tkv = attention.ContiguousKVCache(kv_bits=kv_bits)
    rng = np.random.default_rng([kv_bits or 0, layout == "paged"])
    jc = jkv.init(b, jcfg, cache_len, jnp.float32)
    tc = tkv.init(b, tcfg, cache_len, torch.float32, "cpu")
    if layout == "paged":  # an allocator-like shuffled table, one hole
        table = rng.permutation(b * cache_len // bs).astype(np.int32)
        table = table.reshape(b, -1)
        table[1, 3] = -1
        jc = {**jc, "table": jnp.asarray(table)}
        tc["table"].copy_(torch.from_numpy(table))
    _assert_leaves_equal(tc, jc)

    # admission: a 2-row contiguous fp prefill sub-cache into slots (2, 0)
    sub_len = np.array([7, 11])
    ar = np.arange(cache_len)
    sub = {"k": rng.standard_normal((2, cache_len, kvh, dh)).astype(np.float32),
           "v": rng.standard_normal((2, cache_len, kvh, dh)).astype(np.float32),
           "slot_pos": np.where(ar < sub_len[:, None], ar, -1).astype(np.int32)}
    slots = np.array([2, 0], np.int32)
    jc = jkv.insert(jc, {k: jnp.asarray(v) for k, v in sub.items()},
                    jnp.asarray(slots))
    tkv.insert(tc, {k: torch.from_numpy(v) for k, v in sub.items()},
               torch.from_numpy(slots))
    _assert_leaves_equal(tc, jc)

    # a decode step with row 1 write-masked
    k1 = rng.standard_normal((b, 1, kvh, dh)).astype(np.float32)
    v1 = rng.standard_normal((b, 1, kvh, dh)).astype(np.float32)
    pos = np.array([[11], [5], [7]], np.int32)
    wm = np.array([True, False, True])
    jc = jkv.fill(jc, jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(pos),
                  jnp.asarray(wm))
    tkv.fill(tc, torch.from_numpy(k1), torch.from_numpy(v1),
             torch.from_numpy(pos), torch.from_numpy(wm))
    _assert_leaves_equal(tc, jc)

    if layout == "paged":  # a 3-token window at per-row starts
        kw = rng.standard_normal((b, 3, kvh, dh)).astype(np.float32)
        vw = rng.standard_normal((b, 3, kvh, dh)).astype(np.float32)
        wpos = np.array([12, 2, 8], np.int32)[:, None] + np.arange(3, dtype=np.int32)
        jc = jkv.fill_window(jc, jnp.asarray(kw), jnp.asarray(vw),
                             jnp.asarray(wpos), jnp.asarray([True, True, False]))
        tkv.fill_window(tc, torch.from_numpy(kw), torch.from_numpy(vw),
                        torch.from_numpy(wpos), torch.tensor([True, True, False]))
        _assert_leaves_equal(tc, jc)

    jg, tg = jkv.gather(jc), tkv.gather(tc)
    for got, want in zip(tg, jg):
        if kv_bits == 1 and got.dtype == torch.float32:  # +-alpha
            np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                            maxulp=4)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jc = jkv.reset(jc, jnp.int32(0))
    tkv.reset(tc, 0)
    _assert_leaves_equal(tc, jc)


def test_speculative_cache_ops_wait_for_their_slice():
    """The speculative-decoding cache operations arrived with their slice:
    the contiguous window write and ``truncate`` on both layouts give the
    JAX package's leaves (tests/test_torch_spec.py holds them at every KV
    tier, window width and table shape)."""
    jcfg = jattn.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, d_head=16)
    cfg = attention.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, d_head=16)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((1, 5, 2, 16)).astype(np.float32)
    pos = np.arange(1, 6, dtype=np.int32)[None]
    for jkv, kv in ((jattn.CONTIGUOUS, attention.CONTIGUOUS),
                    (jattn.PagedKVCache(block_size=4),
                     attention.PagedKVCache(block_size=4))):
        jc = jkv.init(1, jcfg, 8, jnp.float32)
        cache = kv.init(1, cfg, 8, torch.float32, "cpu")
        if "table" in cache:
            jc = {**jc, "table": jnp.asarray([[1, 0]], jnp.int32)}
            cache["table"].copy_(torch.tensor([[1, 0]]))
        jc = jkv.fill_window(jc, jnp.asarray(k), jnp.asarray(-k),
                             jnp.asarray(pos))
        kv.fill_window(cache, torch.from_numpy(k), torch.from_numpy(-k),
                       torch.from_numpy(pos))
        jc = jkv.truncate(jc, jnp.asarray([3], jnp.int32))
        kv.truncate(cache, torch.tensor([3], dtype=torch.int32))
        _assert_leaves_equal(cache, jc)


# ---------------------------------------------------------------------------
# block allocator
# ---------------------------------------------------------------------------


def test_block_allocator_matches_jax():
    """The same operation sequence — alloc, register, shared lookup,
    release into the cached state, LRU eviction, trim — gives the same ids
    and states, and a double release raises in both."""

    def drive(mod):
        a = mod.BlockAllocator(6, 4)
        log = []
        s1 = [a.alloc() for _ in range(3)]
        a.register(s1[0], "h0")
        a.register(s1[1], "h1")
        a.register(s1[2], "h0")  # first writer wins
        s2 = [a.lookup("h0"), a.lookup("h1"), a.lookup("nope"), a.alloc()]
        log.append((s1, s2, dict(a.refs), a.live_blocks))
        s1 = a.trim(s1, 0)
        log.append((s1, dict(a.refs), list(a.cached), sorted(a.free)))
        s2 = a.trim([x for x in s2 if x is not None], 1)
        log.append((s2, dict(a.refs), list(a.cached), sorted(a.free)))
        s3 = [a.alloc() for _ in range(5)]  # evicts the cached h1 block
        log.append((s3, dict(a.refs), list(a.cached), sorted(a.index),
                    a.lookup("h1")))
        with pytest.raises(RuntimeError, match="double release"):
            a.release(99)
        a.release(s3[0])
        with pytest.raises(RuntimeError, match="double release"):
            a.release(s3[0])
        return log

    assert drive(engine) == drive(jengine)


# ---------------------------------------------------------------------------
# the paged scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """(numpy params per quant, prompts with a shared 9-token prefix)."""
    jcfg = jregistry.get("granite-3-2b").smoke
    host = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(4), jcfg))
    packed = {}
    for name, pol in (("binary", JQuantPolicy.binary()),
                      ("w4a4", JQuantPolicy.quantized(4))):
        p, _ = jconverter.convert(host, pol)
        packed[name] = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, jcfg.vocab_size, (9,)).astype(np.int32)
    prompts = [np.concatenate(
        [prefix, rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32)])
        for n in (6, 2, 11, 4)]
    return host, packed, prompts


def _policies(quant):
    if quant == "binary":
        return JQuantPolicy.binary(), QuantPolicy.binary()
    return JQuantPolicy.quantized(4), QuantPolicy.quantized(4)


def _run(mod, eng, prompts):
    sched = mod.Scheduler(eng)
    for p in prompts:
        sched.submit(mod.Request(prompt=p))
    return sched.run(), sched


def _port_engine(params, policy, backend="vpu", **ecfg):
    spec = registry.get("granite-3-2b")
    ctx = QCtx(policy=policy, compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend=backend))
    return engine.Engine(spec, spec.smoke, ctx, params,
                         engine.EngineConfig(**ecfg))


@pytest.mark.parametrize("kv_bits", [None, 8, 1])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("quant,backend", [("binary", "vpu"),
                                           ("binary", "mxu"),
                                           ("w4a4", "vpu")])
def test_paged_scheduler_streams_match_jax(smoke, quant, backend, fused,
                                           kv_bits):
    """Chunked prefill + shared prefixes + write-masked decode on 2 slots,
    4 requests: the port's greedy streams and prefill counters equal the
    JAX scheduler's, and every block is released exactly once."""
    _, packed, prompts = smoke
    jpol, pol = _policies(quant)
    ecfg = dict(batch=2, cache_len=32, max_new_tokens=5, fused_attn=fused,
                kv_bits=kv_bits, **PAGED)
    spec = jregistry.get("granite-3-2b")
    jctx = JQCtx(policy=jpol, compute_dtype=jnp.float32,
                 gemm_config=JGemmConfig(backend=backend))
    jeng = jengine.Engine(spec, spec.smoke, jctx,
                          jax.tree.map(jnp.asarray, packed[quant]),
                          jengine.EngineConfig(**ecfg))
    want, jsched = _run(jengine, jeng, prompts)
    teng = _port_engine(params_from_numpy(packed[quant], "cpu"), pol,
                        backend, **ecfg)
    assert teng.paged
    got, sched = _run(engine, teng, prompts)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    js, ts = jsched.stats, sched.stats
    assert (ts.prefills, ts.prefill_tokens, ts.shared_tokens, ts.steps,
            ts.admissions) == (js.prefills, js.prefill_tokens,
                               js.shared_tokens, js.steps, js.admissions)
    assert ts.shared_tokens > 0
    assert ts.prefill_tokens + ts.shared_tokens == sum(map(len, prompts))
    assert sched.alloc.live_blocks == 0


@pytest.mark.parametrize("kv_bits", [8, 1])
def test_contiguous_kv_tiers_match_jax(smoke, kv_bits):
    """The contiguous layout's quantized tiers (encode on insert and on the
    decode write), read through ``flash_decode_contig``: the JAX
    scheduler's greedy streams."""
    _, packed, prompts = smoke
    ecfg = dict(batch=2, cache_len=32, max_new_tokens=5, fused_attn=True,
                kv_bits=kv_bits)
    spec = jregistry.get("granite-3-2b")
    jctx = JQCtx(policy=JQuantPolicy.binary(), compute_dtype=jnp.float32)
    jeng = jengine.Engine(spec, spec.smoke, jctx,
                          jax.tree.map(jnp.asarray, packed["binary"]),
                          jengine.EngineConfig(**ecfg))
    want, _ = _run(jengine, jeng, prompts)
    got, _ = _run(engine, _port_engine(params_from_numpy(packed["binary"],
                                                         "cpu"),
                                       QuantPolicy.binary(), **ecfg), prompts)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("fused", [False, True])
def test_paged_equals_contiguous_on_port(smoke, fused):
    """As tests/test_paged.py holds it for JAX: the paged + chunked +
    prefix-shared scheduler emits the contiguous scheduler's greedy streams
    (fp KV; ``fused`` runs both layouts through the plain flash-decode,
    contiguous through ``flash_decode_contig``)."""
    _, packed, prompts = smoke
    params = params_from_numpy(packed["binary"], "cpu")
    pol = QuantPolicy.binary()
    base, _ = _run(engine, _port_engine(params, pol, batch=2, cache_len=32,
                                        max_new_tokens=5, fused_attn=fused),
                   prompts)
    paged, sched = _run(engine, _port_engine(
        params, pol, batch=2, cache_len=32, max_new_tokens=5,
        fused_attn=fused, **PAGED), prompts)
    for rid in base:
        np.testing.assert_array_equal(paged[rid], base[rid])
    # the first two requests admit together (nothing registered yet); the
    # last two each reuse the full-block prefix: 2 * (9 // 4) blocks
    assert sched.stats.shared_tokens == 2 * (9 // 4) * 4
    assert sched.alloc.live_blocks == 0


def test_paged_engine_validation(smoke):
    _, packed, _ = smoke
    params = params_from_numpy(packed["binary"], "cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        _port_engine(params, QuantPolicy.binary(), batch=1, cache_len=30,
                     kv_block_size=4)
    with pytest.raises(ValueError, match="kv_bits must be None, 8 or 1"):
        _port_engine(params, QuantPolicy.binary(), batch=1, cache_len=32,
                     kv_bits=4)
    eng = _port_engine(params, QuantPolicy.binary(), batch=1, cache_len=32,
                       fused_attn=True, kv_bits=8)
    assert not eng.paged and eng.cfg.attn.fused_attn and eng.cfg.attn.kv_bits == 8
