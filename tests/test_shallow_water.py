"""Shallow-water model tests.

The reference has no SW implementation to diff against (TODO.md:5), so per
SURVEY.md §4 the strategy is physics-based: exact invariants (rest state,
mass), the analytic linear gravity-wave solution, geostrophic balance, and
energy conservation.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.models.shallow_water import ShallowWaterModel


def build(**kw):
    cfg = ModelConfig(nx=64, ny=64, **kw)
    return cfg, ShallowWaterModel.build(cfg)


def test_rest_state_is_steady():
    cfg, m = build(nu=0.0)
    s = m.init_state(np.zeros(cfg.grid_shape, np.float32))
    s2 = m.segment(s, None, 10)
    for a, b in zip(s, s2):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-4)


def test_mass_exactly_conserved():
    cfg, m = build()
    s = m.geostrophic_init(makefields.gaussian(cfg))
    m0 = float(m.stats(s).mass)
    s = m.segment(s, None, 30)
    m1 = float(m.stats(s).mass)
    assert abs(m1 - m0) / m0 < 1e-6


def test_linear_gravity_wave_matches_analytic():
    """f=0, nu=0, tiny amplitude: h' = A cos(kx) evolves as
    A cos(kx) cos(c k t) with c = sqrt(g H) — standing gravity wave."""
    cfg = ModelConfig(nx=64, ny=64, f=0.0, nu=0.0, dt=3.0,
                      gravity=9.81, mean_depth=1000.0)
    m = ShallowWaterModel.build(cfg)
    k = 2 * np.pi * 4 / cfg.lx
    x, _ = cfg.coords()
    A = 1e-3 * cfg.mean_depth
    hp0 = (A * np.cos(k * x))[:, None] * np.ones((1, cfg.ny), np.float32)
    s = m.init_state(np.zeros(cfg.grid_shape), h0=cfg.mean_depth + hp0)

    c = np.sqrt(cfg.gravity * cfg.mean_depth)
    omega = c * k
    n_steps = 40
    s = m.segment(s, None, n_steps)
    t = n_steps * cfg.dt
    want = cfg.mean_depth + hp0 * np.cos(omega * t)
    got = np.asarray(m.diags(s).h)
    # linear theory exact to O(A/H)=1e-3 in the nonlinear model
    np.testing.assert_allclose(got, want, atol=3e-3 * A)


def test_geostrophic_balance_stays_balanced():
    """Balanced vortex: divergence stays tiny vs the vorticity scale and
    the height field barely moves over an inertial-fraction run."""
    cfg = ModelConfig(nx=64, ny=64, nu=0.0, dt=3.0,
                      gravity=9.81, mean_depth=1000.0)
    m = ShallowWaterModel.build(cfg)
    vort0 = makefields.gaussian(cfg, zeta0=1e-5)  # Ro ~ zeta/f = 1
    s0 = m.geostrophic_init(vort0)
    h0 = np.asarray(m.diags(s0).h)
    s = m.segment(s0, None, 100)
    d = m.diags(s)
    zeta_scale = float(jnp.max(jnp.abs(d.vort)))
    assert float(jnp.max(jnp.abs(d.div))) < 0.2 * zeta_scale
    dh = np.abs(np.asarray(d.h) - h0)
    eta_scale = max(1e-12, float(np.max(np.abs(h0 - cfg.mean_depth))))
    assert float(dh.max()) < 0.25 * eta_scale


def test_energy_conservation_inviscid():
    cfg = ModelConfig(nx=64, ny=64, nu=0.0, dt=3.0,
                      gravity=9.81, mean_depth=1000.0)
    m = ShallowWaterModel.build(cfg)
    s = m.geostrophic_init(makefields.kuo2004(cfg))
    e0 = float(m.stats(s).energy)
    pe_rest = 0.5 * cfg.gravity * cfg.mean_depth**2
    s = m.segment(s, None, 50)
    e1 = float(m.stats(s).energy)
    # compare against the dynamic part (total is dominated by 0.5*g*H^2)
    assert abs(e1 - e0) / max(1e-30, abs(e0 - pe_rest)) < 1e-3


def test_vorticity_source_forcing_enters():
    cfg, m = build()
    s = m.geostrophic_init(makefields.gaussian(cfg))
    src = np.zeros(cfg.grid_shape, np.float32)
    src[10:20, 10:20] = 1e-6
    s_forced = m.step(s, jnp.asarray(src))
    s_free = m.step(s, None)
    dz = np.abs(np.asarray(s_forced.zeta_hat) - np.asarray(s_free.zeta_hat))
    assert dz.max() > 0.0
    # h is not directly forced within a single stage's first evaluation,
    # but the coupled RK stages propagate it; just check state validity
    assert np.isfinite(np.asarray(s_forced.eta_hat)).all()


def test_sw_reduces_toward_barotropic_at_large_depth():
    """With huge mean depth (fast gravity waves already balanced away by
    geostrophic init) the vorticity evolution approaches the barotropic
    model's over a short run."""
    from xlab_fftbarotropic.models.barotropic import BarotropicModel
    cfg = ModelConfig(nx=64, ny=64, nu=6.5, dt=1.0,
                      gravity=9.81, mean_depth=1e5)
    sw = ShallowWaterModel.build(cfg)
    bt = BarotropicModel.build(cfg)
    vort0 = makefields.kuo2004(cfg)
    s = sw.geostrophic_init(vort0)
    z = bt.init_state(vort0)
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    n = 20
    s = sw.segment(s, None, n)
    z = bt.segment(z, src, n)
    vort_sw = np.asarray(sw.diags(s).vort)
    vort_bt = np.asarray(bt.diags(z)[0])
    scale = np.abs(vort_bt).max()
    assert np.abs(vort_sw - vort_bt).max() < 0.05 * scale


def test_gravity_wave_cfl_warning():
    """dt above the RK4 gravity-wave bound must warn at build time (the
    4096^2 default-dt NaN, BASELINE.md); a compliant dt must not."""
    import warnings

    from xlab_fftbarotropic.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)

    cfg = ModelConfig(nx=64, ny=64, dt=10 * max_stable_dt(
        ModelConfig(nx=64, ny=64)))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ShallowWaterModel.build(cfg)
    assert any("CFL" in str(x.message) for x in w)

    ok = ModelConfig(nx=64, ny=64)
    assert ok.dt < max_stable_dt(ok)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ShallowWaterModel.build(ok)
    assert not any("CFL" in str(x.message) for x in w)


def test_tendency_split_linear_equivalence():
    """tendency(split=True) — nonlinear-only products + exact spectral
    f0/gravity terms (the form the ETDRK4 nonlinear tendency uses) —
    against a float64
    numpy ground truth of the same contract: the split form must be at
    least as accurate as the default per component (it removes the
    transform round-off of the large f0*u / g*eta terms), including at
    the mean mode, where curl_z(f0 u) and div(f0 u) vanish exactly (a
    state with nonzero mean zeta/div/eta exposes a missing guard)."""
    from xlab_fftbarotropic.models.shallow_water import SWState, tendency
    from xlab_fftbarotropic.ops import fft
    from xlab_fftbarotropic.ops.spectral import SpectralTables

    cfg = ModelConfig(nx=64, ny=64)
    t = SpectralTables.from_config(cfg)
    g = cfg.grid_shape
    rng = np.random.default_rng(9)

    def fld(amp, mean):
        return jnp.asarray(
            (amp * rng.standard_normal(g) + mean).astype(np.float32))

    s = SWState(zeta_hat=fft.forward(fld(1e-4, 2e-5)),
                div_hat=fft.forward(fld(1e-6, 3e-6)),
                eta_hat=fft.forward(fld(2.0, 1.2)))
    f0, grav, nu, H = (float(cfg.f), float(cfg.gravity), float(cfg.nu),
                       float(cfg.mean_depth))
    kw = dict(f=f0, g=grav, nu=nu, mean_depth=H, grid_shape=g)
    a = tendency(t, s, None, split=False, **kw)
    b = tendency(t, s, None, split=True, **kw)

    # ----- float64 ground truth (same f32-rounded tables, so table
    # rounding cancels; the two f32 formulations agree in f64 to ~1e-16,
    # far below the f32 errors measured here) -----
    ikx = 1j * np.asarray(t.kx, np.float64)[:, None]
    iky = 1j * np.asarray(t.ky, np.float64)[None, :]
    lap = np.asarray(t.lap, np.float64)
    inv_lap = np.asarray(t.inv_lap, np.float64)
    z64 = np.asarray(s.zeta_hat).astype(np.complex128)
    d64 = np.asarray(s.div_hat).astype(np.complex128)
    e64 = np.asarray(s.eta_hat).astype(np.complex128)
    psi, chi = z64 / inv_lap, d64 / inv_lap     # mean mode passthrough
    psi[0, 0], chi[0, 0] = z64[0, 0], d64[0, 0]
    u = np.fft.irfft2(-iky * psi + ikx * chi, s=g)   # inverse-only norm
    v = np.fft.irfft2(ikx * psi + iky * chi, s=g)    # == numpy irfft2
    zeta = np.fft.irfft2(z64, s=g)
    eta = np.fft.irfft2(e64, s=g)
    q = zeta + f0
    qu, qv = np.fft.rfft2(q * u), np.fft.rfft2(q * v)
    eu, ev = np.fft.rfft2(eta * u), np.fft.rfft2(eta * v)
    phi = np.fft.rfft2(grav * eta + 0.5 * (u * u + v * v))
    ref = {
        "zeta_hat": -(ikx * qu + iky * qv) + nu * lap * z64,
        "div_hat": (ikx * qv - iky * qu) - lap * phi + nu * lap * d64,
        "eta_hat": -(ikx * eu + iky * ev) - H * d64,
    }

    # The two formulations legitimately differ OUTSIDE the dealias mask
    # (measured: only at the Nyquist column + mean mode): the exact
    # spectral f-term disagrees there with the transform route, whose
    # irfft2 discards non-Hermitian Nyquist content under the
    # positive-Nyquist gradient convention. rk4_step dealiases every
    # stage tendency, so the dynamics only ever see the masked modes —
    # compare those.
    mask = np.asarray(t.mask).astype(np.float64)
    for name in ("zeta_hat", "div_hat", "eta_hat"):
        x = mask * np.asarray(getattr(a, name)).astype(np.complex128)
        y = mask * np.asarray(getattr(b, name)).astype(np.complex128)
        r = mask * ref[name]
        err_def = np.max(np.abs(x - r))
        err_spl = np.max(np.abs(y - r))
        scale = np.max(np.abs(r))
        # both formulations are correct f32 implementations: the error
        # floor is transform round-off amplified by the spectral
        # gradients, relative to INTERMEDIATE magnitudes (|qu_hat| etc.)
        # that dwarf the near-cancelling output — measured ~2e-3 of the
        # output scale for zeta; a wrong formulation would be O(1)
        assert err_def < 1e-2 * scale, (name, err_def, scale)
        assert err_spl < 1e-2 * scale, (name, err_spl, scale)
        # ...and on the dealiased modes split never loses accuracy (it
        # usually gains: the f0/g linear terms no longer ride f32
        # transforms)
        assert err_spl <= err_def * 1.2 + 1e-12 * scale, \
            (name, err_spl, err_def)
        # mean-mode guard (inside the mask): both match f64 tightly
        assert abs(y[0, 0] - ref[name][0, 0]) <= \
            max(1e-6 * abs(ref[name][0, 0]), 1e-8 * scale), name
