"""Packed serving checkpoints: the port's ``ckpt/manager.export_packed`` and
``launch/serve.load_packed`` against the JAX package's.  An ``.npz`` is
exact or wrong: keys, dtypes and words are compared bit for bit, and the
greedy streams served from a loaded file must equal JAX's exactly.
Denormals are flushed on one thread, as in tests/test_torch_lm.py (see its
docstring)."""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import manager as jmanager
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.nn.common import QCtx as JQCtx
from repro.serve import engine as jengine
from repro_torch.ckpt import manager
from repro_torch.core import converter
from repro_torch.core.policy import QuantPolicy
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import registry
from repro_torch.nn.common import QCtx
from repro_torch.serve import engine
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True)
def flush_denormals():
    """Match XLA's CPU denormal flush for one test, on the calling thread
    alone (``set_flush_denormal`` is per thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


CASES = [("granite-3-2b", "binary"), ("granite-3-2b", "w4a4"),
         ("deepseek-moe-16b", "binary")]


def _policies(quant: str):
    if quant == "binary":
        return JQuantPolicy.binary(), QuantPolicy.binary()
    return JQuantPolicy.quantized(4), QuantPolicy.quantized(4)


def _host(arch: str):
    cfg = jregistry.get(arch).smoke
    return jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(6), cfg))


def _zip_entries(path):
    """(name, CRC, size) of every member, in file order."""
    with zipfile.ZipFile(path) as z:
        return [(i.filename, i.CRC, i.file_size) for i in z.infolist()]


@pytest.mark.parametrize("arch,quant", CASES)
def test_export_writes_the_jax_file(arch, quant, tmp_path):
    host = _host(arch)
    jpol, pol = _policies(quant)
    want_path, got_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    want_report = jmanager.export_packed(host, jpol, want_path)
    got_report = manager.export_packed(params_from_numpy(host, "cpu"), pol,
                                       got_path)
    assert (got_report.bytes_fp32, got_report.bytes_after,
            got_report.n_packed) == (want_report.bytes_fp32,
                                     want_report.bytes_after,
                                     want_report.n_packed)
    with np.load(want_path) as w, np.load(got_path) as g:
        assert g.files == w.files
        packed = [k for k in w.files if k.endswith("_packed")]
        assert packed and all(w[k].dtype == np.uint32 for k in packed)
        for k in w.files:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
    assert _zip_entries(got_path) == _zip_entries(want_path)
    with open(got_path, "rb") as g, open(want_path, "rb") as w:
        assert g.read() == w.read()


@pytest.mark.parametrize("arch,quant", CASES)
def test_port_round_trip_is_bit_exact(arch, quant, tmp_path):
    spec = registry.get(arch)
    _, pol = _policies(quant)
    params = params_from_numpy(_host(arch), "cpu")
    path = str(tmp_path / "p.npz")
    manager.export_packed(params, pol, path)
    want, _ = converter.convert(params, pol)
    got = serve_cli.load_packed(path, serve_cli.packed_template(spec.smoke,
                                                                pol), "cpu")
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_load_rejects_a_file_of_another_layout(tmp_path):
    spec = registry.get("granite-3-2b")
    path = str(tmp_path / "p.npz")
    manager.export_packed(params_from_numpy(_host("granite-3-2b"), "cpu"),
                          QuantPolicy.binary(), path)
    with pytest.raises(ValueError, match="the model wants"):
        serve_cli.load_packed(path, serve_cli.packed_template(
            spec.smoke, QuantPolicy.quantized(4)), "cpu")


def test_flatten_matches_jax_with_empty_lists():
    tree = {"b": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "layers": [{"x": np.ones(2, np.uint32)}, {"y": np.zeros(1)}],
            "empty": [], "a": np.float32(3.0)}
    want = jmanager._flatten(tree)
    got = manager._flatten(tree)
    assert list(got) == list(want)
    assert "empty|__empty__" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = manager._unflatten_into(tree, got)
    assert back["empty"] == [] and back["layers"][1]["y"] is got[
        "layers|1|y"]


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_jax_exported_file_serves_jax_greedy_tokens(backend, tmp_path):
    """An ``.npz`` the JAX package exports, loaded by the port, gives the
    greedy streams JAX gives from loading it (``Scheduler``, slot
    recycling on 2 slots)."""
    jspec, spec = jregistry.get("granite-3-2b"), registry.get("granite-3-2b")
    path = str(tmp_path / "jax.npz")
    host = _host("granite-3-2b")
    jmanager.export_packed(host, JQuantPolicy.binary(), path)
    tmpl, _ = jserve.converter.convert(host, JQuantPolicy.binary())
    jparams = jax.tree.map(jnp.asarray, jserve.load_packed(path, tmpl))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, spec.smoke.vocab_size, (n,)).astype(np.int32)
               for n in (5, 5, 8, 3)]
    ecfg = dict(batch=2, cache_len=24, max_new_tokens=6)

    from repro.kernels.dispatch import GemmConfig as JGemmConfig
    from repro_torch.kernels.dispatch import GemmConfig

    jeng = jengine.Engine(jspec, jspec.smoke, JQCtx(
        policy=JQuantPolicy.binary(), compute_dtype=jnp.float32,
        gemm_config=JGemmConfig(backend=backend)), jparams,
        jengine.EngineConfig(**ecfg))
    sched = jengine.Scheduler(jeng)
    for p in prompts:
        sched.submit(jengine.Request(prompt=p))
    want = sched.run()

    params = serve_cli.load_packed(path, serve_cli.packed_template(
        spec.smoke, QuantPolicy.binary()), "cpu")
    ctx = QCtx(policy=QuantPolicy.binary(), compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend=backend))
    got, _, _ = serve_cli.serve(engine.Engine(
        spec, spec.smoke, ctx, params, engine.EngineConfig(**ecfg)), prompts)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
