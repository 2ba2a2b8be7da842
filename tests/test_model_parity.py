"""Differential tests: the JAX model vs. the float32 CPU oracle.

The oracle (oracle/reference_cpu.py) is a statement-level numpy transcription
of /root/reference/src/main.cpp — the executable spec standing in for the
unbuildable reference binaries (SURVEY.md Phase 0(b)). These tests assert the
production jitted model reproduces it allclose over multi-step integrations,
the round-1 analogue of the 'vort_step_*.bin allclose' gate in BASELINE.md.
"""

import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.oracle.reference_cpu import OracleBarotropic


def rel_err(a, b):
    scale = np.max(np.abs(b)) + 1e-30
    return np.max(np.abs(a - b)) / scale


class TestSingleStep:
    def test_tendency_matches_oracle(self, small_cfg):
        vort0 = makefields.gaussian(small_cfg)
        model = BarotropicModel.build(small_cfg)
        oracle = OracleBarotropic(small_cfg)
        z = model.init_state(vort0)
        z_np = np.fft.rfft2(vort0).astype(np.complex64)
        np.testing.assert_allclose(np.asarray(z), z_np, rtol=1e-4, atol=1e-6)

        from xlab_fftbarotropic.models.barotropic import tendency
        d_jax = np.asarray(tendency(model.tables, z, model.zero_source(),
                                    small_cfg.nu, small_cfg.grid_shape))
        d_np, _, _, _ = oracle.rhs(z_np)
        assert rel_err(d_jax, d_np) < 1e-3

    def test_one_rk4_step(self, small_cfg):
        vort0 = makefields.gaussian(small_cfg)
        model = BarotropicModel.build(small_cfg)
        oracle = OracleBarotropic(small_cfg)
        z1 = np.asarray(model.step(model.init_state(vort0),
                                   model.zero_source()))
        z1_np = oracle.rk4_step(np.fft.rfft2(vort0).astype(np.complex64))
        assert rel_err(z1, z1_np) < 1e-3


class TestMultiStep:
    @pytest.mark.parametrize("n_steps", [10, 50])
    def test_gaussian_run(self, small_cfg, n_steps):
        """64^2 Gaussian vortex, physical-vorticity allclose after N steps."""
        vort0 = makefields.gaussian(small_cfg)
        model = BarotropicModel.build(small_cfg)
        oracle = OracleBarotropic(small_cfg)

        z = model.init_state(vort0)
        z = model.segment(z, model.zero_source(), n_steps)
        vort_jax = np.asarray(model.diags(z).vort)

        vort_np = oracle.run(vort0, n_steps)
        # tolerance grows mildly with step count (float32 chaotic system)
        tol = 1e-3 * (1 + n_steps / 10)
        assert rel_err(vort_jax, vort_np) < tol

    def test_kuo2004_merger_short(self):
        """The vortex-merger case (makefield-Kuo2004.cpp) on a small grid."""
        cfg = ModelConfig(nx=96, ny=96, dt=3.0)
        vort0 = makefields.kuo2004(cfg)
        model = BarotropicModel.build(cfg)
        oracle = OracleBarotropic(cfg)
        z = model.segment(model.init_state(vort0), model.zero_source(), 20)
        vort_jax = np.asarray(model.diags(z).vort)
        vort_np = oracle.run(vort0, 20)
        assert rel_err(vort_jax, vort_np) < 5e-3

    def test_forced_run_matches_oracle(self, small_cfg):
        """Forcing held fixed across RK stages (main-shallow-water.cpp:304)."""
        vort0 = makefields.gaussian(small_cfg)
        src = makefields.cake_kuo2004(
            small_cfg, small_cfg.lx / 2 + 50_000.0, small_cfg.ly / 2,
            3e-3 / 10800.0, 30_000.0)
        model = BarotropicModel.build(small_cfg)
        oracle = OracleBarotropic(small_cfg)
        oracle.vort_src = src

        import jax.numpy as jnp
        z = model.segment(model.init_state(vort0), jnp.asarray(src), 15)
        vort_jax = np.asarray(model.diags(z).vort)
        vort_np = oracle.run(vort0, 15)
        assert rel_err(vort_jax, vort_np) < 3e-3


class TestDiagnosticsParity:
    def test_recorded_fields_match(self, small_cfg):
        vort0 = makefields.gaussian(small_cfg)
        model = BarotropicModel.build(small_cfg)
        oracle = OracleBarotropic(small_cfg)
        z = model.segment(model.init_state(vort0), model.zero_source(), 10)
        d = model.diags(z)

        records = {}
        oracle_cfg = small_cfg.replace(record_step=10)
        oracle2 = OracleBarotropic(oracle_cfg)
        oracle2.run(vort0, 11, record=lambda s, f: records.update({s: f}))
        f = records[10]
        for name in ("vort", "psi", "u", "v"):
            assert rel_err(np.asarray(getattr(d, name)), f[name]) < 3e-3, name


class TestConservation:
    def test_energy_enstrophy_nearly_conserved(self, small_cfg):
        """Inviscid-limit sanity: with nu=0 the truncated system conserves
        energy and enstrophy up to dealiasing/time-discretization error."""
        cfg = small_cfg.replace(nu=0.0)
        vort0 = makefields.gaussian(cfg)
        model = BarotropicModel.build(cfg)
        z = model.init_state(vort0)
        s0 = model.stats(z)
        z = model.segment(z, model.zero_source(), 50)
        s1 = model.stats(z)
        assert abs(float(s1.energy - s0.energy)) < 1e-3 * float(s0.energy)
        assert abs(float(s1.enstrophy - s0.enstrophy)) < 1e-2 * float(s0.enstrophy)


def test_paired_fft_path_stays_on_oracle_trajectory():
    """Regression for the Hermitian-packing leak: the default (paired-FFT)
    step must track the oracle to round-off over 20 chaotic steps, not just
    within loose drift tolerances. Without the column-0/Nyquist
    symmetrization in ops/fft.py:_hermitian_full this error is ~5e-3."""
    import numpy as np
    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.models.barotropic import BarotropicModel
    from xlab_fftbarotropic.oracle import reference_cpu as oracle

    cfg = ModelConfig(nx=64, ny=64)
    v0 = makefields.kuo2004(cfg)
    m = BarotropicModel.build(cfg)
    z = m.segment(m.init_state(v0), m.zero_source(), 20)
    mine = np.asarray(m.diags(z).vort)
    want = oracle.OracleBarotropic(cfg).run(v0, 20)
    rel = np.abs(mine - want).max() / np.abs(want).max()
    assert rel < 1e-6, rel
