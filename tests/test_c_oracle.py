"""Triple-implementation differential: the independent C++ oracle
(native/ref_oracle.cpp — own radix-2 float32 FFT, no numpy/pocketfft/XLA
code shared) vs the numpy oracle (oracle/reference_cpu.py) vs the JAX
model, on BASELINE config #1 (256^2 gaussian, 100 RK4 steps).

FFTW3f cannot be installed or vendored offline, so instead of
diffing the numpy transcription against the real FFTW binaries, we diff it
against a second from-scratch implementation of the same written contract
(SURVEY.md §5). Agreement of three independent codebases to float32
round-off is strong evidence the contract is implemented, not just
transcribed consistently.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.io.fieldio import read_field, write_field

REPO = Path(__file__).resolve().parents[1]
ORACLE = REPO / "native" / "ref_oracle.out"


def _build():
    if ORACLE.exists():
        return True
    if shutil.which("g++") is None and shutil.which("make") is None:
        return False
    r = subprocess.run(["make", "-C", str(REPO / "native"), "ref_oracle.out"],
                       capture_output=True, text=True)
    return r.returncode == 0 and ORACLE.exists()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def c_run(tmp_path_factory):
    if not _build():
        pytest.skip("no C++ toolchain to build native/ref_oracle.out")
    d = tmp_path_factory.mktemp("c_oracle")
    cfg = ModelConfig(nx=256, ny=256, dt=3.0, total_steps=100,
                      record_step=50)
    vort0 = makefields.gaussian(cfg)
    write_field(d / "init.bin", vort0)
    (d / "out").mkdir()
    subprocess.run([str(ORACLE), "256", "256", str(cfg.lx), str(cfg.ly),
                    "3.0", str(cfg.nu), "100", "50",
                    str(d / "init.bin"), str(d / "out")],
                   check=True, timeout=300)
    return cfg, vort0, d / "out"


def test_c_oracle_roundtrip_ic(c_run):
    """vort_step_0.bin is the IC after one r2c+c2r roundtrip of the
    hand-written FFT — pins the FFT itself to float32 round-off."""
    cfg, vort0, out = c_run
    step0 = read_field(out / "vort_step_0.bin", cfg.grid_shape)
    assert _rel(step0, vort0) < 1e-6


def test_c_oracle_matches_numpy_oracle(c_run):
    """100-step trajectories of the two independent serial oracles agree
    to float32 round-off (measured 2.1e-7)."""
    from xlab_fftbarotropic.oracle.reference_cpu import OracleBarotropic
    cfg, vort0, out = c_run
    recorded = {}
    np_final = OracleBarotropic(cfg).run(
        vort0, 100, record=lambda s, f: recorded.update({s: f["vort"]}))
    c_final = read_field(out / "vort_final.bin", cfg.grid_shape)
    assert _rel(c_final, np_final) < 3e-6
    c_mid = read_field(out / "vort_step_50.bin", cfg.grid_shape)
    assert _rel(c_mid, recorded[50]) < 2e-6


def test_c_oracle_matches_jax_model(c_run):
    """The JAX model reproduces the C oracle trajectory
    (measured 2.1e-7 after 100 steps on the CPU backend)."""
    import jax.numpy as jnp  # noqa: F401
    from xlab_fftbarotropic.models.barotropic import BarotropicModel
    from xlab_fftbarotropic.ops import fft
    cfg, vort0, out = c_run
    model = BarotropicModel.build(cfg)
    z = model.segment(model.init_state(vort0), model.zero_source(), 100)
    jx_final = np.asarray(fft.inverse(z, cfg.grid_shape))
    c_final = read_field(out / "vort_final.bin", cfg.grid_shape)
    assert _rel(c_final, jx_final) < 3e-6


@pytest.mark.parametrize("icname", ["kuo2004", "elliptic-vortex",
                                    "const-vortex"])
def test_c_oracle_other_ics(tmp_path, icname):
    """Widen the triple-implementation differential beyond config #1's
    gaussian: the reference's other IC families (binary-vortex merger,
    elliptic vortex, Rankine-like constant vortex — C11-C13) drive much
    sharper gradients through the dealias mask and Laplacian inversion,
    so agreement here pins the contract under structured dynamics, not
    just a smooth blob. 128^2, 60 RK4 steps, C++ oracle vs numpy oracle
    vs the JAX model (the jnp.fft and DFT-as-matmul backends)."""
    if not _build():
        pytest.skip("no C++ toolchain to build native/ref_oracle.out")
    from xlab_fftbarotropic.models.barotropic import BarotropicModel
    from xlab_fftbarotropic.ops import fft
    from xlab_fftbarotropic.oracle.reference_cpu import OracleBarotropic

    cfg = ModelConfig(nx=128, ny=128, dt=3.0, total_steps=60,
                      record_step=60)
    vort0 = makefields.make(icname, cfg)
    write_field(tmp_path / "init.bin", vort0)
    (tmp_path / "out").mkdir()
    subprocess.run([str(ORACLE), "128", "128", str(cfg.lx), str(cfg.ly),
                    "3.0", str(cfg.nu), "60", "60",
                    str(tmp_path / "init.bin"), str(tmp_path / "out")],
                   check=True, timeout=300)
    c_final = read_field(tmp_path / "out" / "vort_final.bin",
                         cfg.grid_shape)
    np_final = OracleBarotropic(cfg).run(vort0, 60)
    assert _rel(c_final, np_final) < 3e-6
    for backend in ("xla", "mxu"):
        m = BarotropicModel.build(cfg.replace(fft_backend=backend))
        z = m.segment(m.init_state(vort0), m.zero_source(), 60)
        jx = np.asarray(fft.inverse(z, cfg.grid_shape))
        assert _rel(c_final, jx) < 3e-6, backend
