"""PyTorch port vs the JAX package: the paper's binary CNNs — ``qconv``
(fake-quant and packed through im2col), conv packing in the converter,
``model_nbytes`` and the Table 1 / Table 2 size accounting, the packed
``.npz`` of a CNN, LeNet and ResNet-18 forwards, one binary LeNet train
step, and the two example twins (``launch/binary_mnist``,
``launch/partial_binarization``).  Inputs and weights are made with numpy
from fixed seeds and handed to both packages.  Denormals are flushed and the
port computes on one thread, as in tests/test_torch_lm.py (see its
docstring): XLA's CPU backend flushes them, and a binarized model sees the
sign of a denormal.

Tolerances, each measured on this CPU before it was set:
- 1-bit ``qconv``, fake-quant and packed ``vpu`` / ``mxu``: exact, against
  JAX and within the port (±1 sums are integers, exact in float32); with
  XNOR-Net alpha exact within the port and ``rtol=1e-6`` against JAX (the
  two round ``mean(|w|)`` an ulp apart);
- k-bit ``qconv``: ``rtol=1e-4, atol=2e-4`` (the JAX package's k-bit
  contract; measured up to 2.2e-5 on outputs up to 23): packed and
  fake-quant sum the DoReFa products in other orders;
- fp ``qconv``: ``rtol=1e-5, atol=1e-5`` (measured 3.8e-6 on outputs up to
  4.5: XLA's and oneDNN's conv sum in other orders);
- converter words, plane stacks, ``shape_hwio``, sizes and the ``.npz``:
  exact; alpha ``rtol=1e-6``;
- whole models: each layer fed JAX's input gives JAX's output (exact at
  1 bit, the k-bit contract at k bits, ``rtol=1e-5, atol=1e-5`` fp);
  run free, the logits agree within ``atol=1e-5`` (measured 1.6e-6) while
  no binarized activation (the sign at 1 bit, the DoReFa code at k bits)
  differs; where one does, it must lie within rounding (1e-5) of the sign
  or code boundary in the first layer where any differs, and the logits are
  reported, not gated (a flipped code moves everything after it: the smoke
  ResNet-18 at w4a4 flips one code in ``stage1/unit0/conv2`` and 4,627 in
  all);
- one binary LeNet train step: the loss ``rtol=2e-6``, gradients within
  2e-5 of the leaf's largest (measured 3.2e-6), new params within 1e-3 *
  lr where ``|m|`` is above 1e-3 of its leaf's largest and 2 * lr
  everywhere, as in tests/test_torch_train.py (measured 1.5e-5 * lr).
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import manager as jmanager
from repro.core import converter as jconverter
from repro.core import qlayers as jqlayers
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.core.policy import QuantSpec as JQuantSpec
from repro.kernels.dispatch import GemmConfig as JGemmConfig
from repro.models import cnn as jcnn
from repro.models import registry as jregistry
from repro.nn.common import QCtx as JQCtx
from repro.optim import adamw as jadamw
from repro_torch.ckpt import manager
from repro_torch.core import converter, qlayers
from repro_torch.core.policy import QuantPolicy, QuantSpec
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels.dispatch import GemmConfig
from repro_torch.launch import binary_mnist, partial_binarization
from repro_torch.models import cnn, registry
from repro_torch.nn.common import QCtx
from repro_torch.optim import adamw
from repro_torch.serve import engine
from repro_torch.train import losses, trainer
from repro_torch.tree import tree_leaves

KBIT_TOL = dict(rtol=1e-4, atol=2e-4)
FP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_ATOL = 1e-5
TIE_EPS = 1e-5
ARCHS = {"lenet-mnist": (jcnn.lenet_init, jcnn.lenet_forward,
                         cnn.lenet_forward),
         "resnet18-cifar10": (jcnn.resnet18_init, jcnn.resnet18_forward,
                              cnn.resnet18_forward)}
QUANTS = ("fp", "binary", "w4a4")


@pytest.fixture(autouse=True)
def flush_denormals():
    """Match XLA's CPU denormal flush (module docstring) for one test, on
    the calling thread alone (``set_flush_denormal`` is per thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _policies(quant: str):
    if quant == "fp":
        return JQuantPolicy.full_precision(), QuantPolicy.full_precision()
    if quant.startswith("binary"):
        scale = quant == "binary_scaled"
        return (JQuantPolicy.binary(scale=scale),
                QuantPolicy.binary(scale=scale))
    w, a = map(int, quant[1:].split("a"))
    return JQuantPolicy.quantized(w, a), QuantPolicy.quantized(w, a)


def _tol(bits: int) -> dict:
    return KBIT_TOL if 1 < bits < 32 else FP_TOL


def _conv_case(k: int, stride: int, c_in: int = 40, c_out: int = 24,
               hw: int = 10):
    """Weights and NHWC input from numpy.  C_in 40 makes K = 40, 360, 1000
    (Kw 2, 12, 32 with 8 tail bits); hw 10 at stride 2 splits SAME's padding
    unevenly at k 3 and 5."""
    rng = np.random.default_rng(100 * k + stride)
    w = (rng.standard_normal((k, k, c_in, c_out))
         / np.sqrt(k * k * c_in)).astype(np.float32)
    x = rng.standard_normal((2, hw, hw, c_in)).astype(np.float32)
    return w, x


# ---------------------------------------------------------------------------
# qconv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("bits", [32, 1, 2, 4, 8])
def test_qconv_matches_jax(bits, padding, stride, k):
    """Fake-quant ``qconv`` against JAX's; at 1..8 bits also the port's
    packed ``vpu`` / ``mxu`` paths (converted by the port) against JAX's
    fake-quant and against the port's own, and JAX's packed path (its
    ``xla`` backend) against the port's fake-quant."""
    w, x = _conv_case(k, stride)
    jy = np.asarray(jqlayers.qconv(
        {"w": jnp.asarray(w)}, jnp.asarray(x), JQuantSpec(bits, bits),
        stride=stride, padding=padding, compute_dtype=jnp.float32))
    spec = QuantSpec(bits, bits)
    ty = qlayers.qconv({"w": torch.from_numpy(w)}, torch.from_numpy(x), spec,
                       stride=stride, padding=padding,
                       compute_dtype=torch.float32).numpy()
    assert ty.shape == jy.shape
    exact = bits == 1
    if exact:
        np.testing.assert_array_equal(ty, jy)
    else:
        np.testing.assert_allclose(ty, jy, **_tol(bits))
    if bits == 32:
        return
    packed, _ = converter.convert({"c": {"w": torch.from_numpy(w)}},
                                  QuantPolicy(w_bits=bits, a_bits=bits))
    outs = {}
    for backend in ("vpu", "mxu"):
        outs[backend] = qlayers.qconv(
            packed["c"], torch.from_numpy(x), spec, stride=stride,
            padding=padding, compute_dtype=torch.float32,
            gemm_config=GemmConfig(backend=backend)).numpy()
        for want in (ty, jy):
            if exact:
                np.testing.assert_array_equal(outs[backend], want)
            else:
                np.testing.assert_allclose(outs[backend], want, **KBIT_TOL)
    # both kernels compute the same integer dot, dequantized alike
    np.testing.assert_array_equal(outs["vpu"], outs["mxu"])
    jpacked, _ = jconverter.convert({"c": {"w": jnp.asarray(w)}},
                                    JQuantPolicy(w_bits=bits, a_bits=bits))
    jpy = np.asarray(jqlayers.qconv(
        jpacked["c"], jnp.asarray(x), JQuantSpec(bits, bits), stride=stride,
        padding=padding, compute_dtype=jnp.float32,
        gemm_config=JGemmConfig(backend="xla")))
    if exact:
        np.testing.assert_array_equal(jpy, ty)
    else:
        np.testing.assert_allclose(jpy, ty, **KBIT_TOL)


@pytest.mark.parametrize("quant", ["binary_scaled", "binary_range"])
def test_qconv_epilogue_packed_equals_fakequant(quant):
    """XNOR-Net alpha and the Eq. 2 range map on a 1-bit conv: packed ==
    fake-quant in the port bit for bit.  Against JAX: exact with the range
    map; with alpha within ``rtol=1e-6`` (measured 4.1e-7: XLA and PyTorch
    sum ``mean(|w|)`` in other orders, an ulp of alpha)."""
    w, x = _conv_case(3, 2)
    kw = (dict(scale=True) if quant == "binary_scaled"
          else dict(xnor_range=True))
    spec, jspec = QuantSpec(1, 1, **kw), JQuantSpec(1, 1, **kw)
    ty = qlayers.qconv({"w": torch.from_numpy(w)}, torch.from_numpy(x), spec,
                       stride=2, compute_dtype=torch.float32).numpy()
    packed, _ = converter.convert({"c": {"w": torch.from_numpy(w)}},
                                  QuantPolicy.binary(**kw))
    for backend in ("vpu", "mxu"):
        py = qlayers.qconv(packed["c"], torch.from_numpy(x), spec, stride=2,
                           compute_dtype=torch.float32,
                           gemm_config=GemmConfig(backend=backend)).numpy()
        np.testing.assert_array_equal(py, ty)
    jy = np.asarray(jqlayers.qconv({"w": jnp.asarray(w)}, jnp.asarray(x),
                                   jspec, stride=2,
                                   compute_dtype=jnp.float32))
    if quant == "binary_scaled":
        np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("k,stride,padding", [(1, 1, "VALID"), (3, 2, "SAME"),
                                              (5, 1, "SAME"), (5, 2, "VALID")])
def test_im2col_and_pads_match_jax(k, stride, padding):
    """The patch matrix (``(h, w, C)`` order, -1.0 pad) and the -1 SAME pad
    of the binary fake-quant path, bit for bit."""
    _, x = _conv_case(k, stride, c_in=5, hw=9)
    got, geo = qlayers._im2col(torch.from_numpy(x), k, k, stride, padding)
    want, jgeo = jqlayers._im2col(jnp.asarray(x), k, k, stride, padding)
    assert geo == jgeo
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        qlayers._pad_same_pm1(torch.from_numpy(x), k, k, stride).numpy(),
        np.asarray(jqlayers._pad_same_pm1(jnp.asarray(x), k, k, stride)))


def test_qconv_packed_rejects_a_wrong_plane_layout():
    w, x = _conv_case(3, 1)
    packed, _ = converter.convert({"c": {"w": torch.from_numpy(w)}},
                                  QuantPolicy.binary())
    with pytest.raises(ValueError, match="plane stack"):
        qlayers.qconv(packed["c"], torch.from_numpy(x), QuantSpec(4, 4))


# ---------------------------------------------------------------------------
# converter, sizes, export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ["binary", "binary_scaled", "w2a2", "w4a4",
                                   "w8a8"])
def test_converter_conv_words_match_jax(quant):
    """Conv and dense layers packed by both converters: every leaf (sign
    words or plane stacks as uint32, ``shape_hwio`` as int64) and the size
    report equal, alpha within ``rtol=1e-6`` (measured 1.6e-7, an ulp:
    XLA and PyTorch sum ``mean(|w|)`` in other orders).  ``shape_hwio``
    stays on the host."""
    rng = np.random.default_rng(7)
    tree = {"stage1": {"conv1": {"w": rng.standard_normal(
                (3, 3, 40, 24)).astype(np.float32)},
                       "proj": {"w": rng.standard_normal(
                           (1, 1, 40, 24)).astype(np.float32)}},
            "fc1": {"w": rng.standard_normal((72, 16)).astype(np.float32)},
            "bn": {"scale": np.ones(24, np.float32)}}
    tree = jax.tree.map(np.asarray, tree)  # JAX's order: keys sorted
    jpol, pol = _policies(quant)
    jpacked, jrep = jconverter.convert(jax.tree.map(jnp.asarray, tree), jpol)
    packed, rep = converter.convert(params_from_numpy(tree, "cpu"), pol)
    assert packed["stage1"]["conv1"]["shape_hwio"].device.type == "cpu"
    want = jax.tree.map(np.asarray, jpacked)
    got = params_to_numpy(packed)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if "w_packed" in str(path) or "bn" in str(path):
            np.testing.assert_array_equal(g, w)
        else:  # alpha: mean(|w|), summed in another order (docstring)
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got["stage1"]["conv1"]["shape_hwio"],
                                  np.array([3, 3, 40, 24]))
    assert ([dataclasses.astuple(l) for l in rep.leaves]
            == [dataclasses.astuple(l) for l in jrep.leaves])
    assert converter.model_nbytes(packed) == jconverter.model_nbytes(jpacked)


def test_shape_hwio_round_trips_on_the_host():
    """``params_from_numpy`` keeps ``shape_hwio`` an int64 host tensor and
    ``params_to_numpy`` gives back JAX's int64 array."""
    tree = {"c": {"shape_hwio": np.array([3, 3, 8, 16]),
                  "w_packed": np.arange(6, dtype=np.uint32).reshape(2, 3)}}
    t = params_from_numpy(tree, "cpu")
    assert t["c"]["shape_hwio"].dtype == torch.int64
    assert t["c"]["w_packed"].dtype == torch.int32
    back = params_to_numpy(t)
    assert back["c"]["shape_hwio"].dtype == np.int64
    np.testing.assert_array_equal(back["c"]["shape_hwio"], [3, 3, 8, 16])
    assert back["c"]["w_packed"].dtype == np.uint32


def _imagenet_resnet(pkg_cfg):
    return dataclasses.replace(pkg_cfg, n_classes=1000, stem_stride=2,
                               in_hw=224)


SIZE_CASES = [("lenet-mnist", "table1", ()), ("resnet18-cifar10", "table1", ())]
SIZE_CASES += [("resnet18-cifar10", "table2", stages)
               for stages in partial_binarization.STAGES.values()]


@pytest.fixture(scope="module")
def full_hosts():
    """The JAX package's full-width inits as numpy: Table 1 LeNet and
    ResNet-18, and Table 2's ImageNet-head ResNet-18."""
    return {
        ("lenet-mnist", "table1"): jax.tree.map(np.asarray, jcnn.lenet_init(
            jax.random.PRNGKey(0), jregistry.get("lenet-mnist").config)),
        ("resnet18-cifar10", "table1"): jax.tree.map(
            np.asarray, jcnn.resnet18_init(
                jax.random.PRNGKey(0),
                jregistry.get("resnet18-cifar10").config)),
        ("resnet18-cifar10", "table2"): jax.tree.map(
            np.asarray, jcnn.resnet18_init(
                jax.random.PRNGKey(0),
                _imagenet_resnet(jregistry.get("resnet18-cifar10").config))),
    }


@pytest.mark.parametrize("arch,table,fp_stages", SIZE_CASES)
def test_sizes_match_jax(full_hosts, arch, table, fp_stages):
    """``model_nbytes`` and the converter's ``SizeReport`` (every leaf,
    the totals, the ratio and the summary line) byte for byte, for the
    Table 1 models and the four Table 2 variants."""
    host = full_hosts[(arch, table)]
    jpol = JQuantPolicy.binary().with_fp_stages(fp_stages)
    pol = QuantPolicy.binary().with_fp_stages(fp_stages)
    params = params_from_numpy(host, "cpu")
    assert converter.model_nbytes(params) == jconverter.model_nbytes(host)
    jpacked, jrep = jconverter.convert(host, jpol)
    packed, rep = converter.convert(params, pol)
    assert ([dataclasses.astuple(l) for l in rep.leaves]
            == [dataclasses.astuple(l) for l in jrep.leaves])
    assert (rep.bytes_fp32, rep.bytes_after, rep.n_packed, rep.ratio) == (
        jrep.bytes_fp32, jrep.bytes_after, jrep.n_packed, jrep.ratio)
    assert rep.summary() == jrep.summary()
    assert converter.model_nbytes(packed) == jconverter.model_nbytes(jpacked)


@pytest.mark.parametrize("arch,quant", [("lenet-mnist", "binary"),
                                        ("lenet-mnist", "w4a4"),
                                        ("resnet18-cifar10", "binary")])
def test_export_writes_the_jax_file(arch, quant, tmp_path):
    """``export_packed`` of a smoke CNN writes JAX's ``.npz`` byte for
    byte (``shape_hwio`` int64, words uint32)."""
    init = ARCHS[arch][0]
    host = jax.tree.map(np.asarray, init(jax.random.PRNGKey(5),
                                         jregistry.get(arch).smoke))
    jpol, pol = _policies(quant)
    want_path, got_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jmanager.export_packed(host, jpol, want_path)
    manager.export_packed(params_from_numpy(host, "cpu"), pol, got_path)
    with np.load(want_path) as w:
        assert any(k.endswith("shape_hwio") and w[k].dtype == np.int64
                   for k in w.files)
    with open(got_path, "rb") as g, open(want_path, "rb") as w:
        assert g.read() == w.read()


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    for arch in ARCHS:
        j, t = jregistry.get(arch), registry.get(arch)
        assert (t.arch_id, t.family) == (j.arch_id, j.family) == (arch, "cnn")
        for which in ("config", "smoke"):
            assert (dataclasses.asdict(getattr(t, which))
                    == dataclasses.asdict(getattr(j, which)))


def test_engine_and_trainer_refuse_the_cnn_family():
    spec = registry.get("lenet-mnist")
    params = cnn.lenet_init(torch.Generator().manual_seed(0), spec.smoke)
    with pytest.raises(NotImplementedError, match="lm family only"):
        engine.Engine(spec, spec.smoke, QCtx(policy=QuantPolicy.binary()),
                      params, engine.EngineConfig(batch=1, cache_len=8))
    with pytest.raises(ValueError):
        trainer.loss_fn_for(spec)
    with pytest.raises(ValueError):
        trainer.init_all(spec, spec.smoke, torch.Generator())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_shapes_match_jax(arch):
    """The port's init draws other numbers (a ``torch.Generator``) into the
    JAX package's tree: same keys, shapes and dtypes."""
    jinit = ARCHS[arch][0]
    cfg = registry.get(arch).config
    want = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0),
                                        jregistry.get(arch).config))
    tinit = cnn.lenet_init if arch == "lenet-mnist" else cnn.resnet18_init
    got = tinit(torch.Generator().manual_seed(0), cfg)
    got_np = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        tuple(x.shape), np.dtype(str(x.dtype).replace("torch.", ""))),
        params_to_numpy(got))
    assert (jax.tree_util.tree_structure(got_np)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)


class _JRecorder(JQCtx):
    """JAX QCtx that keeps each quantized layer's input and output."""

    def conv(self, params, x, path, **kw):
        y = super().conv(params, x, path, **kw)
        self.policy_log[path] = ("conv", kw, np.array(x), np.array(y))
        return y

    def dense(self, params, x, path):
        y = super().dense(params, x, path)
        self.policy_log[path] = ("dense", {}, np.array(x), np.array(y))
        return y


class _TRecorder(QCtx):
    """The port's QCtx, keeping each layer's input and output."""

    def conv(self, params, x, path, **kw):
        y = super().conv(params, x, path, **kw)
        self.policy_log[path] = ("conv", kw, x.detach().numpy().copy(),
                                 y.detach().numpy().copy())
        return y

    def dense(self, params, x, path):
        y = super().dense(params, x, path)
        self.policy_log[path] = ("dense", {}, x.detach().numpy().copy(),
                                 y.detach().numpy().copy())
        return y


def _recorder(cls, policy, dtype):
    ctx = cls(policy=policy, compute_dtype=dtype)
    object.__setattr__(ctx, "policy_log", {})
    return ctx


def _codes(x: np.ndarray, spec) -> np.ndarray:
    """The binarized activation a layer sees: its sign at 1 bit, its
    DoReFa code at k bits."""
    if spec.a_bits == 1:
        return x >= 0
    n = 2**spec.a_bits - 1
    return np.round(np.clip(x, 0.0, 1.0) * n)


def _boundary_distance(x: np.ndarray, spec) -> np.ndarray:
    if spec.a_bits == 1:
        return np.abs(x)
    n = 2**spec.a_bits - 1
    u = x * n
    return np.abs(u - np.floor(u) - 0.5) / n


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_smoke_forward_matches_jax(arch, quant):
    """Smoke LeNet / ResNet-18 from JAX's init: every layer fed JAX's input
    gives JAX's output, and the free-running logits agree (module
    docstring), with the binarized activations that differ counted; the
    converted model's packed ``vpu`` / ``mxu`` logits equal the port's
    fake-quant logits (bit for bit at 1 bit, the k-bit contract at
    w4a4)."""
    jinit, jforward, tforward = ARCHS[arch]
    jcfg, cfg = jregistry.get(arch).smoke, registry.get(arch).smoke
    host = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(3), jcfg))
    x = np.random.default_rng(1).standard_normal(
        (8, cfg.in_hw, cfg.in_hw, cfg.in_c)).astype(np.float32)
    jpol, pol = _policies(quant)
    jctx = _recorder(_JRecorder, jpol, jnp.float32)
    tctx = _recorder(_TRecorder, pol, torch.float32)
    params = params_from_numpy(host, "cpu")
    jy = np.asarray(jforward(host, jcfg, jctx, jnp.asarray(x)))
    ty = tforward(params, cfg, tctx, torch.from_numpy(x)).numpy()
    assert ty.shape == jy.shape == (8, cfg.n_classes)
    assert list(tctx.policy_log) == list(jctx.policy_log)

    flips = {}
    for path, (kind, kw, jin, jout) in jctx.policy_log.items():
        spec = pol.spec(path)
        node = params
        for seg in path.split("/"):
            node = node[seg]
        plain = QCtx(policy=pol, compute_dtype=torch.float32)
        fn = plain.conv if kind == "conv" else plain.dense
        got = fn(node, torch.from_numpy(jin), path, **kw).numpy()
        if spec.is_binary and spec.a_bits == 1:
            np.testing.assert_array_equal(got, jout, err_msg=path)
        else:
            np.testing.assert_allclose(
                got, jout, err_msg=path,
                **_tol(32 if spec.is_fp else spec.a_bits))
        if not spec.is_fp:
            tin = tctx.policy_log[path][2]
            diff = _codes(jin, spec) != _codes(tin, spec)
            if diff.any() and not flips:
                # the first layer where any differs: rounding, not a fault
                assert _boundary_distance(jin, spec)[diff].max() <= TIE_EPS
            flips[path] = int(diff.sum())
    n_flips = sum(flips.values())
    print(f"{arch} {quant}: {n_flips} binarized activations differ "
          f"({ {k: v for k, v in flips.items() if v} }); logits max |err| "
          f"{np.abs(ty - jy).max():.3g}")
    if n_flips == 0:
        np.testing.assert_allclose(ty, jy, rtol=0, atol=LOGITS_ATOL)
    if quant == "fp":
        return
    packed, _ = converter.convert(params, pol)
    outs = {}
    for backend in ("vpu", "mxu"):
        ctx = QCtx(policy=pol, compute_dtype=torch.float32,
                   gemm_config=GemmConfig(backend=backend))
        outs[backend] = tforward(packed, cfg, ctx, torch.from_numpy(x))
    np.testing.assert_array_equal(outs["vpu"].numpy(), outs["mxu"].numpy())
    if quant == "binary":
        np.testing.assert_array_equal(outs["vpu"].numpy(), ty)


def test_binary_lenet_train_step_matches_jax():
    """One step of the twin's training (binary LeNet smoke, AdamW at
    ``train_lenet``'s settings) against JAX's jitted step from the same
    init and batch: loss, gradients and new params (module docstring)."""
    jcfg = jregistry.get("lenet-mnist").smoke
    cfg = registry.get("lenet-mnist").smoke
    host = jax.tree.map(np.asarray, jcnn.lenet_init(jax.random.PRNGKey(0),
                                                    jcfg))
    x, y = binary_mnist._data(np.random.default_rng(0), 64, cfg.in_hw)
    opt = dict(lr=1e-2, warmup_steps=5, total_steps=100, weight_decay=0.0)
    jctx = JQCtx(policy=JQuantPolicy.binary(), compute_dtype=jnp.float32)

    def jloss(p, xb, yb):
        logits = jcnn.lenet_forward(p, jcfg, jctx, xb)
        return -jnp.mean(jnp.sum(
            jax.nn.log_softmax(logits) * jax.nn.one_hot(yb, 10), -1))

    @jax.jit
    def jstep(p, o, xb, yb):
        loss, g = jax.value_and_grad(jloss)(p, xb, yb)
        p, o, m = jadamw.update(g, o, p, jadamw.AdamWConfig(**opt))
        return p, o, loss, g, m

    jp, jo, jl, jg, jm = jstep(host, jadamw.init(host), jnp.asarray(x),
                               jnp.asarray(y))
    ctx = QCtx(policy=QuantPolicy.binary(), compute_dtype=torch.float32)
    params = params_from_numpy(host, "cpu")
    grad_fn = trainer._value_and_grad(lambda p, b: (losses.classifier_loss(
        cnn.lenet_forward(p, cfg, ctx, b["x"]), b["y"]), {}))
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    (loss, _), grads = grad_fn(params, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=2e-6)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 2e-5 * np.abs(w).max()
    step = trainer.make_classifier_step(cnn.lenet_forward, cfg, ctx,
                                        adamw.AdamWConfig(**opt))
    params, state, loss2 = step(params, adamw.init(params), batch["x"],
                                batch["y"])
    assert loss2.item() == loss.item() and state["step"].item() == 1
    lr = float(jm["lr"])
    for p, w, m in zip(tree_leaves(params), jax.tree.leaves(jp),
                       jax.tree.leaves(jo["m"])):
        d = np.abs(p.double().numpy() - np.asarray(w, np.float64))
        m = np.abs(np.asarray(m))
        big = m > 1e-3 * m.max()
        assert d.max() <= 2 * lr
        assert not big.any() or d[big].max() <= 1e-3 * lr


# ---------------------------------------------------------------------------
# the example twins
# ---------------------------------------------------------------------------


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue()


def test_binary_mnist_twin_cli(full_hosts):
    """``python -m repro_torch.launch.binary_mnist --device cpu --steps
    30``: both accuracies printed, and the size line the JAX example prints
    (fp32 4.56 MB, binary 0.196 MB, 23.2x)."""
    res, text = _run(binary_mnist.main, ["--device", "cpu", "--steps", "30"])
    host = full_hosts[("lenet-mnist", "table1")]
    _, jrep = jconverter.convert(host, JQuantPolicy.binary())
    want = (f"  model size     fp32={jconverter.model_nbytes(host) / 1e6:.2f}"
            f"MB  binary={jrep.bytes_after / 1e6:.3f}MB  "
            f"ratio={jrep.ratio:.1f}x (paper: 4.6MB / 0.206MB)")
    assert want in text.splitlines()
    assert "fp32=4.56MB  binary=0.196MB  ratio=23.2x" in want
    assert "  test accuracy  fp32=" in text
    assert 0.0 <= res["acc_binary"] <= 1.0 and 0.5 < res["acc_fp32"] <= 1.0


def test_partial_binarization_twin_cli(full_hosts):
    """``python -m repro_torch.launch.partial_binarization --device cpu
    --train --steps 30``: the Table 2 size lines JAX's converter gives
    (3.48 / 4.05 / 6.08 / 46.72 MB), and one accuracy per variant, all
    binary below full precision."""
    res, text = _run(partial_binarization.main,
                     ["--device", "cpu", "--train", "--steps", "30"])
    host = full_hosts[("resnet18-cifar10", "table2")]
    lines = text.splitlines()
    for name, stages in partial_binarization.STAGES.items():
        _, jrep = jconverter.convert(
            host, JQuantPolicy.binary().with_fp_stages(stages))
        assert (f"  fp_stages={name:<8} size={jrep.bytes_after / 1e6:6.2f}MB"
                in lines)
        assert res["sizes"][name] == jrep.bytes_after
    assert [round(res["sizes"][k] / 1e6, 2) for k in
            partial_binarization.STAGES] == [3.48, 4.05, 6.08, 46.72]
    acc = res["accuracy"]
    assert list(acc) == list(partial_binarization.STAGES)
    assert acc["none"] < acc["all"]


@pytest.mark.parametrize("main", [binary_mnist.main,
                                  partial_binarization.main])
def test_twins_default_to_the_card(main):
    """Without ``--device`` the twins ask for the GPU and raise without
    one instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main([])
