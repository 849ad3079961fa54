"""Shared test fixtures.

Virtual multi-device CPU: this conftest sets
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` at import time —
BEFORE any test module imports jax (jax locks the device count on first
init) — so the mesh/shard_map tests (tests/test_shard_gemm.py, the
sharded-engine smoke in tests/test_serve.py) run on plain CPU CI with an
8-device host platform.  The session-scoped ``mesh_factory`` fixture
builds 1-D/2-D meshes from those devices and gracefully skips a test when
the flag did not take effect (jax already imported, or an XLA build that
ignores it).  An explicit device count in a pre-set XLA_FLAGS is
respected.

Also provides a deterministic ``hypothesis`` stand-in (below) since the
container has no hypothesis package and nothing may be pip-installed.
"""

import os
import random
import sys
import types
import zlib

if "jax" not in sys.modules:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            "--xla_force_host_platform_device_count=8 " + _flags
        ).strip()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def mesh_factory():
    """``make(shape, axes=("model",)) -> jax.Mesh`` over the virtual host
    devices; skips the requesting test when the device pool is too small
    (see module docstring)."""
    import jax

    n_dev = len(jax.devices())

    def make(shape, axes=("model",)):
        if isinstance(shape, int):
            shape = (shape,)
        need = 1
        for s in shape:
            need *= s
        if need > n_dev:
            pytest.skip(
                f"mesh {shape} needs {need} devices, have {n_dev} "
                "(XLA_FLAGS=--xla_force_host_platform_device_count "
                "unavailable?)"
            )
        return jax.make_mesh(tuple(shape), tuple(axes))

    return make


# ---------------------------------------------------------------------------
# hypothesis fallback: this container has no `hypothesis` package and
# nothing may be pip-installed.  Rather than skip the property tests, a
# minimal deterministic stand-in runs each @given test over `max_examples`
# seeded random draws (seeded from the test name, so failures reproduce).
# If real hypothesis is installed it is used untouched.
# ---------------------------------------------------------------------------

try:
    import hypothesis  # noqa: F401
except ImportError:

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _integers(min_value, max_value):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def _sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda r: elements[r.randrange(len(elements))])

    def _booleans():
        return _Strategy(lambda r: bool(r.getrandbits(1)))

    def _floats(min_value=0.0, max_value=1.0, **_kw):
        return _Strategy(lambda r: r.uniform(min_value, max_value))

    def _settings(max_examples=20, deadline=None, **_kw):
        def deco(f):
            f._fallback_max_examples = max_examples
            return f

        return deco

    def _given(**strategies):
        def deco(f):
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_fallback_max_examples", 20)
                r = random.Random(zlib.crc32(f.__qualname__.encode()))
                for _ in range(n):
                    drawn = {k: s.draw(r) for k, s in strategies.items()}
                    f(*args, **kwargs, **drawn)

            wrapper.__name__ = f.__name__
            wrapper.__doc__ = f.__doc__
            wrapper.__module__ = f.__module__
            return wrapper

        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.sampled_from = _sampled_from
    _st.booleans = _booleans
    _st.floats = _floats

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__is_fallback__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (CUDA kernels of the PyTorch port); skipped "
        "without one. Run on the card: python -m pytest -q -m gpu "
        "tests/test_torch_gpu.py")
