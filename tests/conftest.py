"""Test harness configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding paths
(parallel/) execute without accelerators, per SURVEY.md §4's strategy of
testing distributed logic via --xla_force_host_platform_device_count.
Must set env before jax imports.

Tests that need the GPU carry the `gpu` marker and request the `gpu_device`
fixture, which skips them when JAX finds no GPU; chip_smoke.py runs the
same checks on the card.
"""

import os

# CPU unless the caller chose (the card's tests: JAX_PLATFORMS=cuda,cpu
# python -m pytest -m gpu tests/test_gpu.py)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# no persistent compilation cache in tests (an empty value disables it;
# utils/compile_cache.py then leaves JAX's setting alone), so CLI mains
# called in-process do not write <repo>/.jax_cache
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# ETDRK4 phi-table disk cache: without this, every etd model build in
# the suite would write table files into ./output/etd_cache relative to
# the test CWD. One shared per-run tmp dir keeps the repo clean AND
# lets repeated same-config builds across tests hit the cache. Tests of
# the cache itself override the env per-test (tests/test_etd_scalar.py).
if "XFB_ETD_CACHE" not in os.environ:
    import tempfile

    os.environ["XFB_ETD_CACHE"] = tempfile.mkdtemp(prefix="xfb_etd_")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from xlab_fftbarotropic.config import ModelConfig  # noqa: E402


@pytest.fixture
def small_cfg():
    """Small square grid for fast differential tests."""
    return ModelConfig(nx=64, ny=64, lx=600_000.0, ly=600_000.0,
                       dt=3.0, nu=6.5, record_step=10, total_steps=20)


@pytest.fixture
def cfg128():
    return ModelConfig(nx=128, ny=128)


@pytest.fixture
def rng():
    return np.random.RandomState(1234)


# --------------------------------------------------------------------------
# Fast/slow test tiers: the adjoint soaks below cost tens of seconds EACH
# on the CPU mesh. Default `pytest -q` skips them; the FULL suite is
# `pytest --slow`. Each has a fast differential counterpart; what they add
# is long-horizon / cross-path coverage that must stay green before a
# commit that touches adjoint.py or parallel/.
# --------------------------------------------------------------------------

_SLOW_NODEID_PATTERNS = (
    "test_adjoint.py::test_segmented_rollout_matches_unsegmented",
    "test_adjoint.py::test_sharded_gradient_matches_single_device",
    "test_adjoint.py::test_assimilate_cli_end_to_end",
    "test_adjoint.py::test_sw_and_tracer_grads_finite",
    "test_beta.py::test_adjoint_rollout_carries_beta",
)


def pytest_addoption(parser):
    parser.addoption(
        "--slow", action="store_true", default=False,
        help="run the FULL suite including the slow adjoint soaks "
             "(the pre-commit gate)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow"):
        return
    skip = pytest.mark.skip(
        reason="slow tier — run `pytest --slow` for the full gate")
    for item in items:
        if any(p in item.nodeid for p in _SLOW_NODEID_PATTERNS):
            item.add_marker(skip)


@pytest.fixture
def gpu_device():
    """The first GPU JAX finds; skips the test when there is none. Decided
    here, at run time, never at import or collection time."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run: python chip_smoke.py on the card)")
    return devs[0]


@pytest.fixture
def p4_mesh():
    """decomp -> a mesh over the first 4 virtual devices, laid out the way
    a four-card host runs it: 1-D for slab/xpencil, 2x2 for pencil."""
    import jax

    from xlab_fftbarotropic.parallel import make_mesh, pencil

    def make(decomp):
        devs = jax.devices()[:4]
        if decomp == "pencil":
            return pencil.make_pencil_mesh((2, 2), devs)
        return make_mesh(devs)
    return make
