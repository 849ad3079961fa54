"""PyTorch port vs the JAX package: the KV storage codecs and the fused
flash-decode attention (``kernels/attn_decode.py``).

The same numpy inputs go through both packages.  The JAX kernel runs in
Pallas interpret mode, as tests/test_attn_fused.py runs it; the port runs
its plain version (the wrapper on CPU tensors).  Codes must be
bit-identical and so are the int8 scales; the 1-bit alpha, a mean over Dh
that the two packages sum in another order, agrees within 4 fp32 ulps
(XLA's CPU order differs from PyTorch's by up to 2 ulps at Dh 16 and 64).  Attention outputs agree within atol 2e-5 on rows
that see at least one key (the JAX test's ``_TOL``); rows that see none are
junk on both sides and are not compared, except a slot with no mapped
block, which must be exact zeros on both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attn_decode as jak
from repro_torch.kernels import attn_decode as ak

TOL = dict(rtol=0, atol=2e-5)
B, KVH, BS, BPS = 3, 2, 4, 5  # bps 5: not a multiple of the default spb 4


@pytest.fixture(autouse=True)
def one_thread_flushed():
    """As tests/test_torch_lm.py: XLA's CPU backend flushes denormals, and
    the flag is per thread, so the test computes on the calling thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("bits", [8, 1])
@pytest.mark.parametrize("dh", [16, 64])
def test_kv_codec_matches_jax(bits, dh):
    rng = np.random.default_rng([bits, dh])
    x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero head: scale floor, sign(0) = +1
    x[1, 2, 1, ::3] = -x[1, 2, 1, ::3]
    jc, js = jak.kv_quantize(bits, jnp.asarray(x))
    tc, ts = ak.kv_quantize(bits, torch.from_numpy(x))
    assert tc.dtype == {8: torch.int8, 1: torch.uint8}[bits]
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if bits == 8:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=4)
    want = jak.kv_dequantize(bits, jc, js, dh)
    got = ak.kv_dequantize(bits, torch.from_numpy(np.array(jc)),
                           torch.from_numpy(np.array(js)), dh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for tier in (None, bits):
        (jshape, jdt), jsc = jak.kv_code_shapes(tier, 3, dh, jnp.float32)
        (tshape, tdt), tsc = ak.kv_code_shapes(tier, 3, dh, torch.float32)
        assert tshape == jshape and str(tdt).split(".")[-1] == jnp.dtype(jdt).name
        assert (tsc is None) == (jsc is None)
        if tsc is not None:
            assert tsc[0] == jsc[0]
    assert ak.kv_scale_groups(dh) == jak.kv_scale_groups(dh)


def _codes(rng, kv_bits, shape_fp, dtype=np.float32):
    """Random storage for one pool: fp values, or codes and positive scales
    (independent of the codec, so the kernels are tested on their own)."""
    *lead, dh = shape_fp
    if kv_bits is None:
        return rng.standard_normal(shape_fp).astype(dtype), None
    if kv_bits == 8:
        codes = rng.integers(-127, 128, shape_fp).astype(np.int8)
        scale = rng.uniform(0.005, 0.02, (*lead, ak.kv_scale_groups(dh)))
        return codes, scale.astype(np.float32)
    codes = rng.integers(0, 256, (*lead, dh // 8)).astype(np.uint8)
    return codes, rng.uniform(0.5, 1.5, lead).astype(np.float32)


def _paged_inputs(rng, kv_bits, c, g, dh):
    """A shuffled pool with stale junk in unmapped blocks; slot 0 has a -1
    entry in the middle of its table, slot 1 is ragged, slot 2 has no
    mapped block at all."""
    nb = B * BPS + 2
    perm = rng.permutation(nb).astype(np.int32)
    table = perm[:B * BPS].reshape(B, BPS).copy()
    table[0, 2] = -1
    table[2, :] = -1
    lens = [17, 9, 0]
    pool_pos = rng.integers(0, 50, (nb, BS)).astype(np.int32)  # stale junk
    for r, ln in enumerate(lens):
        for j in range(BPS):
            if table[r, j] >= 0:
                p = np.arange(j * BS, (j + 1) * BS)
                pool_pos[table[r, j]] = np.where(p < ln, p, -1)
    pk, ks = _codes(rng, kv_bits, (nb, BS, KVH, dh))
    pv, vs = _codes(rng, kv_bits, (nb, BS, KVH, dh))
    q = rng.standard_normal((B, c, KVH, g, dh)).astype(np.float32)
    q_pos = np.stack([np.arange(ln - c + 2, ln + 2) for ln in lens]).astype(np.int32)
    return dict(table=table, q=q, q_pos=q_pos, pool_k=pk, pool_v=pv,
                pool_pos=pool_pos, k_scale=ks, v_scale=vs)


def _contig_inputs(rng, kv_bits, c, g, dh):
    cache_len = BS * BPS
    lens = [cache_len, 9, 0]
    ar = np.arange(cache_len)
    slot_pos = np.stack([np.where(ar < ln, ar, -1) for ln in lens]).astype(np.int32)
    k, ks = _codes(rng, kv_bits, (B, cache_len, KVH, dh))
    v, vs = _codes(rng, kv_bits, (B, cache_len, KVH, dh))
    q = rng.standard_normal((B, c, KVH, g, dh)).astype(np.float32)
    q_pos = np.stack([np.arange(ln - c, ln) for ln in lens]).astype(np.int32)
    return dict(q=q, q_pos=q_pos, k=k, v=v, slot_pos=slot_pos, k_scale=ks,
                v_scale=vs)


def _visible(inp, layout, causal, window):
    """(B, C) bool: does query row (b, c) see any key?"""
    if layout == "pgd":
        table, pool_pos = inp["table"], inp["pool_pos"]
        kpos = np.where(table[:, :, None] >= 0,
                        pool_pos[np.clip(table, 0, None)], -1).reshape(B, -1)
    else:
        kpos = inp["slot_pos"]
    qp, kp = inp["q_pos"][:, :, None], kpos[:, None, :]
    ok = (kp >= 0) & ((kp <= qp) | (not causal))
    if window is not None:
        ok = ok & (kp > qp - window)
    return ok.any(-1)


def _run_both(layout, inp, kv_bits, opts):
    def conv(mod, x):
        if x is None:
            return None
        return jnp.asarray(x) if mod == "jax" else torch.from_numpy(x)

    j = {k: conv("jax", v) for k, v in inp.items()}
    t = {k: conv("torch", v) for k, v in inp.items()}
    if layout == "pgd":
        want = jak.flash_decode_paged(block_size=BS, kv_bits=kv_bits,
                                      interpret=True, **j, **opts)
        got = ak.flash_decode_paged(block_size=BS, kv_bits=kv_bits, **t,
                                    **opts)
    else:
        want = jak.flash_decode_contig(kv_bits=kv_bits, kv_tile=8,
                                       interpret=True, **j, **opts)
        got = ak.flash_decode_contig(kv_bits=kv_bits, kv_tile=8, **t, **opts)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("kv_bits", [None, 8, 1])
@pytest.mark.parametrize("layout", ["pgd", "ctg"])
@pytest.mark.parametrize("c,g", [(1, 4), (3, 1)])
@pytest.mark.parametrize("cap,window", [(None, None), (4.0, 6)])
def test_plain_flash_decode_matches_jax(kv_bits, layout, c, g, cap, window):
    dh = 16
    rng = np.random.default_rng([kv_bits or 0, layout == "pgd", c, g,
                                 window or 0])
    make = _paged_inputs if layout == "pgd" else _contig_inputs
    inp = make(rng, kv_bits, c, g, dh)
    opts = dict(sm_scale=dh ** -0.5, logit_softcap=cap, causal=True,
                window=window)
    got, want = _run_both(layout, inp, kv_bits, opts)
    assert got.shape == want.shape == (B, c, KVH, g, dh)
    vis = _visible(inp, layout, True, window)
    assert vis.any() and not vis.all()
    np.testing.assert_allclose(got[vis], want[vis], **TOL)
    if layout == "pgd":  # slot 2 has no mapped block: exact zeros
        np.testing.assert_array_equal(got[2], 0.0)
        np.testing.assert_array_equal(want[2], 0.0)


def test_plain_flash_decode_non_causal_bf16_pool():
    """A bf16 fp pool (the contiguous cache's default dtype) and
    ``causal=False``, against JAX on the same bf16 values."""
    rng = np.random.default_rng(3)
    inp = _paged_inputs(rng, None, 2, 2, 16)
    opts = dict(sm_scale=0.25, causal=False)
    j = {k: jnp.asarray(v) for k, v in inp.items() if v is not None}
    j["pool_k"] = j["pool_k"].astype(jnp.bfloat16)
    j["pool_v"] = j["pool_v"].astype(jnp.bfloat16)
    want = np.asarray(jak.flash_decode_paged(block_size=BS, interpret=True,
                                             **j, **opts))
    t = {k: torch.from_numpy(v) for k, v in inp.items() if v is not None}
    t["pool_k"] = t["pool_k"].to(torch.bfloat16)
    t["pool_v"] = t["pool_v"].to(torch.bfloat16)
    got = ak.flash_decode_paged(block_size=BS, **t, **opts).numpy()
    vis = _visible(inp, "pgd", False, None)
    np.testing.assert_allclose(got[vis], want[vis], **TOL)


def test_contig_tile_rule_and_default_tiles():
    assert [ak.contig_tile(n) for n in (2048, 2040, 24, 7)] == [512, 8, 8, 1]
    assert ak.contig_tile(24, 16) == 8
    for layout in ("ctg", "pgd"):
        assert (ak.select_attn_tiles(4, 1, 2048, 64, layout)
                == jak.select_attn_tiles(4, 1, 2048, 64, layout))
    with pytest.raises(ValueError, match="layout"):
        ak.select_attn_tiles(4, 1, 2048, 64, "dense")


def test_wrapper_refuses_bad_operands():
    rng = np.random.default_rng(0)
    inp = {k: None if v is None else torch.from_numpy(v)
           for k, v in _paged_inputs(rng, 8, 1, 2, 16).items()}
    call = dict(block_size=BS, kv_bits=8, sm_scale=0.25)
    ak.flash_decode_paged(**inp, **call)
    with pytest.raises(TypeError, match="int8"):
        ak.flash_decode_paged(**{**inp, "pool_k": inp["pool_k"].to(torch.int16)},
                              **call)
    with pytest.raises(ValueError, match="needs v_scale"):
        ak.flash_decode_paged(**{**inp, "v_scale": None}, **call)
    with pytest.raises(ValueError, match="block size"):
        ak.flash_decode_paged(**inp, **{**call, "block_size": 8})
    fp = {k: None if v is None else torch.from_numpy(v)
          for k, v in _paged_inputs(rng, None, 1, 2, 16).items()}
    half = {**fp, "pool_k": fp["pool_k"].half(), "pool_v": fp["pool_v"].half()}
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ak.flash_decode_paged(**half, block_size=BS, sm_scale=0.25)
    with pytest.raises(TypeError, match="float32"):
        ak.flash_decode_paged(**{**inp, "q": inp["q"].double()}, **call)


# ---------------------------------------------------------------------------
# The CUDA decode tile's split plan, held against the plain versions: each
# range's partial from the plain recurrence, merged in split order as the
# kernel's combine does, must equal the one-pass plain version and JAX.
# ---------------------------------------------------------------------------

SPLIT_TOL = dict(rtol=0, atol=1e-5)
_JAX_REF = {}  # (kv_bits, cap, window) -> the JAX output on _split_inputs


def _split_inputs(kv_bits):
    return _paged_inputs(np.random.default_rng([7, kv_bits or 0]), kv_bits,
                         2, 2, 16)


@pytest.mark.parametrize("splits", [None, 1, 2, 3, 7, 20])
@pytest.mark.parametrize("pairs,rows,span", [(32, 4, 2048), (6, 8, 20),
                                             (1, 16, 37), (512, 4, 4096)])
def test_split_plan_covers_span_once(splits, pairs, rows, span):
    n, keys = ak.split_plan(pairs, rows, span, sms=132, splits=splits)
    ranges = ak.split_ranges(n, keys, span)
    covered = np.zeros(span, np.int32)
    for lo, hi in ranges:
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert [r[0] for r in ranges] == sorted(r[0] for r in ranges)
    assert 1 <= n <= ak.MAX_SPLITS
    if splits is None:
        assert keys % ak.SPLIT_KEY_GRAIN == 0
    else:
        assert n <= splits


def test_split_plan_at_the_serving_shapes():
    """B 4 x 8 kv-heads over a 2,048-key span on 132 SMs: 16 ranges of 128
    keys (4 blocks per SM); a batch that fills the card alone takes one."""
    assert ak.split_plan(32, 4, 2048, 132) == (16, 128)
    assert ak.split_plan(4 * 132, 4, 2048, 132) == (1, 2048)
    assert ak.split_plan(32, 16, 2048, 132) == (5, 416)
    with pytest.raises(ValueError, match="splits"):
        ak.split_plan(32, 4, 2048, 132, splits=0)


def test_window_tile_rule():
    pool = torch.zeros(64)
    assert not ak.window_tile(1, 4, 64, pool, pool)
    assert not ak.window_tile(4, 4, 64, pool, pool)  # C*G 16: decode tile
    assert ak.window_tile(37, 4, 64, pool, pool)
    assert ak.window_tile(5, 4, 128, pool, pool)
    assert not ak.window_tile(37, 4, 256, pool, pool)  # Dh > 128
    assert not ak.window_tile(37, 4, 24, pool, pool)  # Dh % 16
    assert not ak.window_tile(37, 4, 64, pool[1:], pool)  # unaligned pool


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("kv_bits", [None, 8, 1])
@pytest.mark.parametrize("cap,window", [(None, None), (4.0, 6)])
def test_split_partials_merged_in_order_match_plain_and_jax(splits, kv_bits,
                                                            cap, window):
    inp = _split_inputs(kv_bits)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in inp.items()}
    opts = dict(kv_bits=kv_bits, sm_scale=16 ** -0.5, logit_softcap=cap,
                causal=True, window=window)
    span = BS * BPS
    n, keys = ak.split_plan(B * KVH, 4, span, sms=132, splits=splits)
    assert n == splits
    parts = [ak.flash_decode_split_plain(**t, keys=r, **opts)
             for r in ak.split_ranges(n, keys, span)]
    got = ak.combine_splits_plain(parts, 2, 2).numpy()
    plain = ak.flash_decode_paged_plain(**t, **opts).numpy()
    key = (kv_bits, cap, window)
    if key not in _JAX_REF:
        j = {k: None if v is None else jnp.asarray(v) for k, v in inp.items()}
        _JAX_REF[key] = np.asarray(jak.flash_decode_paged(
            block_size=BS, interpret=True, **j, **opts))
    vis = _visible(inp, "pgd", True, window)
    assert vis.any() and not vis.all()
    np.testing.assert_allclose(got[vis], plain[vis], **SPLIT_TOL)
    np.testing.assert_allclose(got[vis], _JAX_REF[key][vis], **SPLIT_TOL)
    np.testing.assert_array_equal(got[2], 0.0)  # slot 2: no mapped block
