"""PyTorch port vs the JAX package: continuous-batching ``Scheduler`` greedy
streams on the same packed granite-3-2b smoke params, for both backends and
mixed prompt lengths (slot recycling included); plus the port's own serving
semantics (EOS retirement, budgets, seeded sampling, the deprecated
``generate``, the launcher).  Greedy streams must be identical; sampled
streams cannot match JAX's threefry and are only checked for
reproducibility.  Denormals are flushed as in tests/test_torch_lm.py (see
its docstring): XLA's CPU backend does, and a binarized model sees the
sign of a denormal."""

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
from repro.serve import engine as jengine
from repro_torch.core import converter
from repro_torch.core.policy import QuantPolicy
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.dispatch import GemmConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import registry
from repro_torch.nn.common import QCtx
from repro_torch.serve import engine

LENS = (5, 5, 8, 3, 8, 5)  # FIFO same-length runs + recycling on 2 slots


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


@pytest.fixture(scope="module")
def smoke():
    """(numpy float params, numpy packed params, prompts)."""
    jcfg = jregistry.get("granite-3-2b").smoke
    host = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(4), jcfg))
    packed, _ = jconverter.convert(host, JQuantPolicy.binary())
    packed = jax.tree.map(np.asarray, packed)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32)
               for n in LENS]
    return host, packed, prompts


@pytest.fixture(scope="module")
def smoke_w4a4(smoke):
    """The smoke params converted to DoReFa w4a4 plane stacks by the JAX
    converter (numpy)."""
    host, _, prompts = smoke
    packed, _ = jconverter.convert(host, JQuantPolicy.quantized(4))
    return jax.tree.map(np.asarray, packed), prompts


def _port_engine(params, backend, policy=None, **ecfg):
    spec = registry.get("granite-3-2b")
    ctx = QCtx(policy=policy or QuantPolicy.binary(),
               compute_dtype=torch.float32,
               gemm_config=GemmConfig(backend=backend))
    return engine.Engine(spec, spec.smoke, ctx, params,
                         engine.EngineConfig(**ecfg))


def _run(mod, eng, prompts, **req):
    sched = mod.Scheduler(eng)
    for p in prompts:
        sched.submit(mod.Request(prompt=p, **req))
    return sched.run(), sched.stats


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_scheduler_greedy_streams_match_jax(smoke, backend):
    _, packed, prompts = smoke
    spec = jregistry.get("granite-3-2b")
    jctx = JQCtx(policy=JQuantPolicy.binary(), compute_dtype=jnp.float32,
                 gemm_config=JGemmConfig(backend=backend))
    ecfg = dict(batch=2, cache_len=24, max_new_tokens=5)
    jeng = jengine.Engine(spec, spec.smoke, jctx,
                          jax.tree.map(jnp.asarray, packed),
                          jengine.EngineConfig(**ecfg))
    want, jstats = _run(jengine, jeng, prompts)
    teng = _port_engine(params_from_numpy(packed, "cpu"), backend, **ecfg)
    got, stats = _run(engine, teng, prompts)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert (stats.steps, stats.prefills, stats.admissions) == (
        jstats.steps, jstats.prefills, jstats.admissions)


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_scheduler_w4a4_greedy_streams_match_jax(smoke_w4a4, backend):
    """DoReFa w4a4 packed serving (``vpu`` -> ``vpu-k4``, ``mxu`` ->
    ``mxu-k4``): the port's greedy streams equal the JAX package's."""
    packed, prompts = smoke_w4a4
    spec = jregistry.get("granite-3-2b")
    jctx = JQCtx(policy=JQuantPolicy.quantized(4), compute_dtype=jnp.float32,
                 gemm_config=JGemmConfig(backend=backend))
    ecfg = dict(batch=2, cache_len=24, max_new_tokens=5)
    jeng = jengine.Engine(spec, spec.smoke, jctx,
                          jax.tree.map(jnp.asarray, packed),
                          jengine.EngineConfig(**ecfg))
    want, _ = _run(jengine, jeng, prompts)
    teng = _port_engine(params_from_numpy(packed, "cpu"), backend,
                        QuantPolicy.quantized(4), **ecfg)
    got, _ = _run(engine, teng, prompts)
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_scheduler_packed_equals_fakequant_on_port(smoke):
    host, _, prompts = smoke
    params = params_from_numpy(host, "cpu")
    packed, _ = converter.convert(params, QuantPolicy.binary())
    ecfg = dict(batch=3, cache_len=24, max_new_tokens=6)
    want, _ = _run(engine, _port_engine(params, "vpu", **ecfg), prompts)
    for backend in ("vpu", "mxu"):
        got, _ = _run(engine, _port_engine(packed, backend, **ecfg), prompts)
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])


def test_eos_retirement_and_budgets_match_jax(smoke):
    """Per-request eos (suppressed below min_tokens), zero-token budgets and
    early retirement give the JAX scheduler's streams."""
    _, packed, prompts = smoke
    tparams = params_from_numpy(packed, "cpu")
    ref, _ = _run(engine, _port_engine(tparams, "vpu", batch=2, cache_len=24,
                                       max_new_tokens=6), prompts)
    eos = int(ref[0][2])  # a token the first request emits mid-stream
    spec = jregistry.get("granite-3-2b")
    jctx = JQCtx(policy=JQuantPolicy.binary(), compute_dtype=jnp.float32)
    ecfg = dict(batch=2, cache_len=24, max_new_tokens=6, eos_id=eos)
    jeng = jengine.Engine(spec, spec.smoke, jctx,
                          jax.tree.map(jnp.asarray, packed),
                          jengine.EngineConfig(**ecfg))
    teng = _port_engine(tparams, "vpu", **ecfg)

    def run(mod, eng):
        sched = mod.Scheduler(eng)
        for i, p in enumerate(prompts):
            sched.submit(mod.Request(prompt=p, min_tokens=2 * (i % 2),
                                     max_new_tokens=0 if i == 3 else None))
        return sched.run()

    want, got = run(jengine, jeng), run(engine, teng)
    assert len(got[3]) == 0
    assert len(got[0]) == 3 and got[0][-1] == eos
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_sampled_streams_reproducible_and_batch_invariant(smoke):
    _, packed, prompts = smoke
    tparams = params_from_numpy(packed, "cpu")
    sp = engine.SamplingParams(temperature=1.0, seed=11)
    a, _ = _run(engine, _port_engine(tparams, "vpu", batch=2, cache_len=24,
                                     max_new_tokens=5), prompts, sampling=sp)
    b, _ = _run(engine, _port_engine(tparams, "vpu", batch=3, cache_len=24,
                                     max_new_tokens=5), prompts, sampling=sp)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])
    greedy, _ = _run(engine, _port_engine(tparams, "vpu", batch=2,
                                          cache_len=24, max_new_tokens=5),
                     prompts)
    assert any(not np.array_equal(a[r], greedy[r]) for r in a)


def test_resolve_sampling_precedence_matches_jax():
    for req_kw, ecfg_kw in (
            (dict(), dict()),
            (dict(max_new_tokens=3, eos_id=7, min_tokens=2),
             dict(temperature=0.5, seed=3)),
            (dict(sampling=dict(temperature=0.0, max_new_tokens=9)),
             dict(sampling=dict(seed=4, eos_id=1), eos_id=2))):
        def build(mod):
            rk = dict(req_kw)
            if "sampling" in rk:
                rk["sampling"] = mod.SamplingParams(**rk["sampling"])
            ek = dict(ecfg_kw)
            if "sampling" in ek:
                ek["sampling"] = mod.SamplingParams(**ek["sampling"])
            return mod.resolve_sampling(
                mod.Request(prompt=np.zeros(2, np.int32), **rk),
                mod.EngineConfig(batch=1, cache_len=8, **ek))
        assert vars(build(engine)) == vars(build(jengine))


def test_generate_is_deprecated_and_matches_scheduler(smoke):
    _, packed, prompts = smoke
    eng = _port_engine(params_from_numpy(packed, "cpu"), "vpu", batch=2,
                       cache_len=24, max_new_tokens=4)
    rect = np.stack([prompts[0], prompts[1]])
    with pytest.warns(DeprecationWarning, match="Scheduler"):
        out = eng.generate(rect)
    ref, _ = _run(engine, eng, [prompts[0], prompts[1]])
    np.testing.assert_array_equal(out, np.stack([ref[0], ref[1]]))
    sched = engine.Scheduler(eng)
    sched.submit(engine.Request(prompt=prompts[0], rid=3))
    with pytest.raises(ValueError, match="duplicate rid"):
        sched.submit(engine.Request(prompt=prompts[1], rid=3))


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_serve_launcher_checks_fakequant(backend, capsys):
    out = serve_cli.main(["--arch", "granite-3-2b", "--smoke", "--device",
                          "cpu", "--backend", backend, "--layers", "1",
                          "--prompts", "2", "--prompt-len", "4",
                          "--new-tokens", "3", "--cache-len", "16",
                          "--check-fakequant"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    assert "packed == fake-quant: True" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["vpu", "mxu"])
def test_serve_launcher_kbit_checks_fakequant(backend, capsys):
    out = serve_cli.main(["--arch", "granite-3-2b", "--smoke", "--device",
                          "cpu", "--quant", "w4a4", "--backend", backend,
                          "--layers", "1", "--prompts", "2", "--prompt-len",
                          "4", "--new-tokens", "3", "--cache-len", "16",
                          "--check-fakequant"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    assert "quant w4a4" in text and "(7 layers packed)" in text
    assert "packed == fake-quant: True (6 of 6 tokens agree" in text
    assert serve_cli.stream_agreement(
        {0: np.array([1, 2, 3])}, {0: np.array([1, 5, 3])}) == (2, 3, 1)
    assert serve_cli.parse_quant("w4a8") == QuantPolicy.quantized(4, 8)
    with pytest.raises(ValueError, match="bad quant"):
        serve_cli.parse_quant("int4")
