"""PyTorch port vs the JAX package on the granite-3-2b smoke config: the
model's prefill / decode / forward logits, from the JAX package's own numpy
params loaded into both.

Tolerance: fp32, rtol = atol = 1e-4.  The integer GEMMs (±1 and DoReFa
k-bit codes) are exact in both packages, but the float ops around them
(norms, RoPE, softmax, the attention and tied-embedding einsums, the k-bit
dequant) round in another order in XLA and in PyTorch, so logits agree to a
few ulp of their magnitude, not bit for bit.

Denormals: XLA's CPU backend flushes them to zero, PyTorch's CPU kernels
keep them.  In a binarized model that matters: a softmax weight that
underflows makes an attention output of exactly 0.0 under XLA but
-2.7e-39 under PyTorch, and sign(0) = +1 while sign(-2.7e-39) = -1, so one
activation bit flips and the difference cascades.  The ``flush_denormals``
fixture gives PyTorch the same flush for these tests.
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
from repro.nn.common import QCtx as JQCtx
from repro_torch.core.policy import QuantPolicy
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.dispatch import GemmConfig
from repro_torch.models import lm, registry
from repro_torch.nn import attention
from repro_torch.nn.common import QCtx

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_LEN = 16


@pytest.fixture(autouse=True)
def flush_denormals():
    """Match XLA's CPU denormal flush (module docstring) for one test.
    ``set_flush_denormal`` sets the flag of the calling thread only, and
    PyTorch's intra-op worker threads keep the floating-point environment
    they were started with (an earlier test may have started them without
    the flush), so the test computes on the calling thread alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _setup(quant: str, backend: str = "vpu"):
    """(jax params, port params, jax ctx, port ctx, jax cfg, port cfg)."""
    jcfg = jregistry.get("granite-3-2b").smoke
    cfg = registry.get("granite-3-2b").smoke
    host = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(1), jcfg))
    quant, _, width = quant.partition("-")  # e.g. "packed-w4a4"
    if quant == "fp":
        jpol, pol = JQuantPolicy.full_precision(), QuantPolicy.full_precision()
    elif width:
        w_bits, a_bits = map(int, width[1:].split("a"))
        jpol = JQuantPolicy.quantized(w_bits, a_bits)
        pol = QuantPolicy.quantized(w_bits, a_bits)
    else:
        jpol, pol = JQuantPolicy.binary(), QuantPolicy.binary()
    if quant == "packed":
        host, _ = jconverter.convert(host, jpol)
        host = jax.tree.map(np.asarray, host)
    jctx = JQCtx(policy=jpol, compute_dtype=jnp.float32,
                 gemm_config=JGemmConfig(backend=backend))
    ctx = QCtx(policy=pol, compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend=backend))
    return (jax.tree.map(jnp.asarray, host), params_from_numpy(host, "cpu"),
            jctx, ctx, jcfg, cfg)


def test_configs_match_jax():
    jcfg = jregistry.get("granite-3-2b")
    cfg = registry.get("granite-3-2b")
    for a, b in ((cfg.config, jcfg.config), (cfg.smoke, jcfg.smoke)):
        assert (a.n_layers, a.d_model, a.vocab_size, a.padded_vocab,
                a.tie_embeddings, a.norm) == (
            b.n_layers, b.d_model, b.vocab_size, b.padded_vocab,
            b.tie_embeddings, b.norm)
        assert (a.attn.n_heads, a.attn.n_kv_heads, a.attn.d_head,
                a.attn.rope_theta, a.attn.scale) == (
            b.attn.n_heads, b.attn.n_kv_heads, b.attn.d_head,
            b.attn.rope_theta, b.attn.scale)
        assert (a.mlp.d_ff, a.mlp.act, a.mlp.gated) == (
            b.mlp.d_ff, b.mlp.act, b.mlp.gated)
    assert cfg.config.padded_vocab == 49408


@pytest.mark.parametrize("quant,backend", [("fp", "vpu"), ("fakequant", "vpu"),
                                           ("packed", "vpu"),
                                           ("packed", "mxu"),
                                           ("fakequant-w4a4", "vpu"),
                                           ("packed-w4a4", "vpu"),
                                           ("packed-w4a4", "mxu")])
def test_prefill_and_decode_logits_match_jax(quant, backend):
    jp, tp, jctx, ctx, jcfg, cfg = _setup(quant, backend)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 7))
    jl, jcache = jlm.prefill(jp, jcfg, jctx, jnp.asarray(tokens, jnp.int32),
                             cache_len=CACHE_LEN)
    with torch.inference_mode():
        tl, tcache = lm.prefill(tp, cfg, ctx, torch.from_numpy(tokens),
                                cache_len=CACHE_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(tcache["layers"], jcache["layers"]):
        np.testing.assert_allclose(a["k"].numpy(), np.asarray(b["k"]), **TOL)
        np.testing.assert_array_equal(a["slot_pos"].numpy(),
                                      np.asarray(b["slot_pos"]))
    # three decode steps with per-row positions (rows at different depths)
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
        assert tl.shape == (2, 1, cfg.padded_vocab)
        assert (tl[..., cfg.vocab_size:] == -1e30).all()
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("quant", ["fp", "packed"])
def test_forward_logits_match_jax(quant):
    jp, tp, jctx, ctx, jcfg, cfg = _setup(quant)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 9))
    jl, _ = jlm.forward(jp, jcfg, jctx, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        tl, aux = lm.forward(tp, cfg, ctx, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(aux) == 0.0


def test_port_fakequant_and_packed_logits_identical():
    """§2.2.2 on the port's model: fake-quant and packed logits are
    bit-identical (same integer dots, same float ops in the same order)."""
    _, tf, _, ctx, _, cfg = _setup("fakequant")
    _, tpk, _, _, _, _ = _setup("packed")
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 6)))
    with torch.inference_mode():
        a, _ = lm.prefill(tf, cfg, ctx, tokens, cache_len=CACHE_LEN)
        b, _ = lm.prefill(tpk, cfg, ctx, tokens, cache_len=CACHE_LEN)
    assert torch.equal(a, b)


def test_contiguous_cache_fill_insert_reset_match_jax():
    from repro.nn import attention as jattention

    acfg = registry.get("granite-3-2b").smoke.attn
    jacfg = jregistry.get("granite-3-2b").smoke.attn
    rng = np.random.default_rng(3)
    kv = [rng.standard_normal((2, 6, acfg.n_kv_heads, acfg.d_head)).astype(
        np.float32) for _ in range(2)]
    for cache_len in (8, 4):  # plain prefill write, and the ring wrap
        pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
        c = attention.CONTIGUOUS.init(2, acfg, cache_len, torch.float32, "cpu")
        jc = jattention.CONTIGUOUS.init(2, jacfg, cache_len, jnp.float32)
        attention.CONTIGUOUS.fill(c, *map(torch.from_numpy, kv),
                                  torch.from_numpy(pos.copy()))
        jc = jattention.CONTIGUOUS.fill(jc, *map(jnp.asarray, kv),
                                        jnp.asarray(pos))
        for name in ("k", "v", "slot_pos"):
            np.testing.assert_array_equal(c[name].numpy(), np.asarray(jc[name]))
        # decode write at per-row positions, then retire slot 1
        step = [rng.standard_normal((2, 1, acfg.n_kv_heads, acfg.d_head))
                .astype(np.float32) for _ in range(2)]
        p1 = np.array([[6], [9]], np.int32)
        attention.CONTIGUOUS.fill(c, *map(torch.from_numpy, step),
                                  torch.from_numpy(p1))
        jc = jattention.CONTIGUOUS.fill(jc, *map(jnp.asarray, step),
                                        jnp.asarray(p1))
        attention.CONTIGUOUS.reset(c, 1)
        jc = jattention.CONTIGUOUS.reset(jc, jnp.int32(1))
        for name in ("k", "v", "slot_pos"):
            np.testing.assert_array_equal(c[name].numpy(), np.asarray(jc[name]))
    # insert a 1-row sub-cache into slot 1
    sub = attention.CONTIGUOUS.init(1, acfg, 4, torch.float32, "cpu")
    sub["k"].fill_(3.0)
    sub["slot_pos"][0, :2] = torch.tensor([0, 1], dtype=torch.int32)
    attention.CONTIGUOUS.insert(c, sub, torch.tensor([1]))
    assert (c["k"][1] == 3.0).all() and (c["k"][0] != 3.0).any()
    assert c["slot_pos"][1].tolist() == [0, 1, -1, -1]


def test_slice_3_paths_raise():
    """Slice 3's paged / fused / quantized-KV half is ported and
    constructs, and so is its speculative half (ROADMAP A11: the window
    write and ``truncate``, held against JAX in tests/test_torch_spec.py);
    and no path raises any more: above ``full_attn_max_seq``
    ``_full_sdpa`` takes ``_sdpa_chunked``, which equals ``_sdpa`` within
    fp32 rounding (rtol = atol = 1e-5: both are fp32 softmax attention,
    the chunked one summed in another order; held against JAX in
    tests/test_torch_dense.py)."""
    acfg = registry.get("granite-3-2b").smoke.attn
    import dataclasses

    assert dataclasses.replace(acfg, fused_attn=True, kv_bits=8).kv_bits == 8
    assert attention.PagedKVCache(kv_bits=1).block_size == 16
    kv = attention.ContiguousKVCache(kv_bits=1)
    cache = kv.init(1, acfg, 8, torch.float32, "cpu")
    kw = torch.ones((1, 2, acfg.n_kv_heads, acfg.d_head))
    kv.fill_window(cache, kw, -kw, torch.tensor([[2, 3]]))
    assert cache["slot_pos"][0].tolist() == [-1, -1, 2, 3, -1, -1, -1, -1]
    kv.truncate(cache, torch.tensor([3]))
    assert cache["slot_pos"][0].tolist() == [-1, -1, 2, -1, -1, -1, -1, -1]
    long_cfg = dataclasses.replace(acfg, full_attn_max_seq=4, chunk_q=2,
                                   chunk_kv=3)
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal(
        (1, 6, acfg.n_kv_heads, acfg.groups, acfg.d_head), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal(
        (1, 5, acfg.n_kv_heads, acfg.d_head), np.float32)) for _ in range(2))
    q_pos, k_pos = torch.arange(6)[None], torch.arange(5)[None]
    got = attention._full_sdpa(long_cfg, q, k, v, q_pos, k_pos)
    want = attention._sdpa(acfg, q, k, v, attention._mask(acfg, q_pos, k_pos))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
