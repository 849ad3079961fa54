"""PyTorch port vs the JAX package: bit packing, the sign-pack prologue,
quantizers and STE gradients, policy; plus the port's import rule and its
refusal to fall back to the CPU.  Inputs are made with numpy from a seed and
fed to both packages; packed words are compared as int32 bit-views."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack
from repro.core import quant as jquant
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.kernels.pack_bits import pack_sign_pallas
from repro_torch import resolve_device
from repro_torch.core import bitpack, quant
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import pack_bits

ROOT = pathlib.Path(__file__).resolve().parents[1]
K_SWEEP = (1, 5, 31, 33, 63, 65, 100, 127, 161, 2049)


def _floats(rng, shape):
    """Random floats plus the sign edge cases: +0, -0, NaN, ±inf."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    edge = np.array([0.0, -0.0, np.nan, np.inf, -np.inf], np.float32)
    n = min(flat.size, edge.size)
    flat[rng.choice(flat.size, n, replace=False)] = edge[:n]
    return x


def _i32(words) -> np.ndarray:
    return np.asarray(words).view(np.int32)


@pytest.mark.parametrize("k", K_SWEEP)
def test_pack_sign_words_match_jax(k):
    x = _floats(np.random.default_rng(k), (3, k))
    got = bitpack.pack_sign(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _i32(jbitpack.pack_sign(jnp.asarray(x))))


@pytest.mark.parametrize("k", K_SWEEP)
def test_pack_unpack_bits_roundtrip_matches_jax(k):
    bits = np.random.default_rng(100 + k).random((2, 3, k)) < 0.5
    words = bitpack.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(words.numpy(),
                                  _i32(jbitpack.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(bitpack.unpack_bits(words, k).numpy(), bits)
    pm1 = bitpack.unpack_sign(words, k).numpy()
    np.testing.assert_array_equal(
        pm1, np.asarray(jbitpack.unpack_sign(
            jnp.asarray(_i32(words.numpy()).view(np.uint32)), k)))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_planes_match_jax(bits):
    codes = np.random.default_rng(bits).integers(0, 2**bits, (5, 70))
    got = bitpack.pack_planes(torch.from_numpy(codes), bits)
    want = jbitpack.pack_planes(jnp.asarray(codes, jnp.uint32), bits)
    np.testing.assert_array_equal(got.numpy(), _i32(want))
    np.testing.assert_array_equal(bitpack.unpack_planes(got, 70).numpy(), codes)


def test_packed_width_and_nbytes_match_jax():
    for k in K_SWEEP:
        assert bitpack.packed_width(k) == jbitpack.packed_width(k)
        assert (bitpack.packed_nbytes((3, 4, k))
                == jbitpack.packed_nbytes((3, 4, k)))


@pytest.mark.parametrize("k", K_SWEEP)
def test_pack_sign_plain_matches_pallas_kernel(k):
    """The sign-pack kernel's plain version vs the TPU kernel (interpret
    mode).  The Pallas kernel takes floats pre-padded with -1.0 to its
    blocks; the port's kernel masks the ragged edge itself."""
    m = 5
    x = _floats(np.random.default_rng(200 + k), (m, k))
    kw = bitpack.packed_width(k)
    bm, bkw = 8, 1
    xp = np.full((bm, kw * 32), -1.0, np.float32)
    xp[:m, :k] = x
    want = pack_sign_pallas(jnp.asarray(xp), bm=bm, bkw=bkw,
                            interpret=True)[:m, :kw]
    got = pack_bits.pack_sign(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (m, kw)
    np.testing.assert_array_equal(got.numpy(), _i32(want))


def test_sign_ste_forward_and_grad_match_jax():
    x = np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 0.5, 1.0, 1.0001, 3.0],
                 np.float32)
    g = np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
    want_y = np.asarray(jquant.sign_ste(jnp.asarray(x)))
    want_dx = np.asarray(jax.grad(
        lambda v: jnp.sum(jquant.sign_ste(v) * jnp.asarray(g)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = quant.sign_ste(xt)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(xt.grad.numpy(), want_dx)


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 32])
def test_quantizers_and_ste_grads_match_jax(bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((4, 33)) * 0.8).astype(np.float32)
    w = rng.standard_normal((33, 6)).astype(np.float32)
    for name in ("quantize_act", "quantize_weight"):
        jf, tf = getattr(jquant, name), getattr(quant, name)
        v = x if name == "quantize_act" else w
        want = np.asarray(jf(jnp.asarray(v), bits))
        want_g = np.asarray(jax.grad(
            lambda a: jnp.sum(jf(a, bits) ** 2))(jnp.asarray(v)))
        vt = torch.from_numpy(v).requires_grad_(True)
        y = tf(vt, bits)
        (y**2).sum().backward()
        # fp32 elementwise ops (tanh, round, divide) in two libraries:
        # values agree to a few ulp
        np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(vt.grad.numpy(), want_g, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_codes_scale_and_range_maps_match_jax(bits):
    rng = np.random.default_rng(10 + bits)
    x = rng.standard_normal((4, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        quant.act_codes(torch.from_numpy(x), bits).numpy(),
        np.asarray(jquant.act_codes(jnp.asarray(x), bits)))
    np.testing.assert_array_equal(
        quant.weight_codes(torch.from_numpy(x), bits).numpy(),
        np.asarray(jquant.weight_codes(jnp.asarray(x), bits)))
    np.testing.assert_allclose(
        quant.weight_scale(torch.from_numpy(x)).numpy(),
        np.asarray(jquant.weight_scale(jnp.asarray(x))), rtol=1e-6)
    dot = torch.arange(-8, 9, 2, dtype=torch.float32)
    np.testing.assert_array_equal(quant.xnor_range_map(dot, 8).numpy(),
                                  np.asarray(jquant.xnor_range_map(
                                      jnp.asarray(dot.numpy()), 8)))
    np.testing.assert_array_equal(
        quant.dot_range_map(quant.xnor_range_map(dot, 8), 8).numpy(),
        dot.numpy())


@pytest.mark.parametrize("path", ["embed", "layers/0/attn/q", "lm_head",
                                  "layers/1/mlp/down", "stage1/conv"])
def test_policy_spec_matches_jax(path):
    for mk in (lambda P: P.binary(scale=True),
               lambda P: P.binary().with_fp_stages(("stage1",)),
               lambda P: P.quantized(4), lambda P: P.full_precision()):
        got, want = mk(QuantPolicy).spec(path), mk(JQuantPolicy).spec(path)
        assert (got.w_bits, got.a_bits, got.scale, got.xnor_range) == (
            want.w_bits, want.a_bits, want.scale, want.xnor_range)
        assert (got.is_binary, got.is_fp) == (want.is_binary, want.is_fp)
    assert QuantPolicy().fp_patterns == JQuantPolicy().fp_patterns


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    """The port (and chip_smoke.py) must run where JAX is absent: no module
    of it imports jax or the JAX package, not even its jax-free modules."""
    bad = []
    for f in _port_files():
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{f.relative_to(ROOT)}: {n}")
    assert len(_port_files()) > 20
    assert not bad, bad


def test_cuda_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA entry points are live")
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve.main(["--arch", "granite-3-2b", "--smoke"])  # default cuda
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        params_from_numpy({"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError):
        resolve_device("meta")
    # a wrapper given a tensor on neither the CPU nor a GPU refuses
    with pytest.raises(ValueError, match="unsupported device"):
        pack_bits.pack_sign(torch.zeros((2, 40), device="meta"))
