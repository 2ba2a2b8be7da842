"""Scalar-family ETDRK4 (models/etdrk4.py scalar section), the
phi-table disk cache, and the advective-CFL guard.

Round-5 capabilities: barotropic and tracer exponential integration
(the linear operator is a per-mode SCALAR — nu*lap - r - nu4*lap^2
(+ i*beta*kx*rlap) for the flow, kappa*lap for the tracer), the
(config, dt, hpad)-keyed on-disk phi-table cache, and the runtime
advective-CFL guard wired through the runner
(utils/guards.py:check_etd_cfl). No reference counterpart (the
reference is RK4-only, /root/reference/src/main.cpp:288-317).
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.models import etdrk4 as etd
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.models.tracer import TracerModel, tracer_ic
from xlab_fftbarotropic.ops import spectral as sp


def _cfg(**kw):
    return ModelConfig(nx=64, ny=64, **kw)


def _rel(a, b):
    return float(jnp.linalg.norm(a - b)
                 / jnp.maximum(jnp.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# scalar phi functions
# ---------------------------------------------------------------------------

def test_scalar_phi_identities():
    """z*phi1 = E-1, z^2*phi2 = E-1-z, z^3*phi3 = E-1-z-z^2/2 on real,
    complex, stiff-negative and zero arguments; exact RK4-limit values
    at z = 0."""
    z = np.array([0.0, 1e-6, -30.0, 0.3 + 2.0j, -2.0 + 8.0j, 12.0],
                 np.complex128)
    E, p1, p2, p3 = etd._phi_functions_scalar(z)
    assert np.max(np.abs(z * p1 - (E - 1))) < 1e-12 * np.max(np.abs(E))
    assert np.max(np.abs(z * z * p2 - (E - 1 - z))) \
        < 1e-12 * np.max(np.abs(E))
    assert np.max(np.abs(z ** 3 * p3 - (E - 1 - z - z * z / 2))) \
        < 1e-11 * np.max(np.abs(E))
    assert E[0] == 1.0 and p1[0] == 1.0
    assert p2[0] == 0.5 and abs(p3[0] - 1 / 6) < 1e-15
    # agreement with the 3x3 path on diagonal matrices
    A = np.zeros((6, 3, 3))
    for i, v in enumerate((-0.5, 2.0, -30.0, 0.0, 7.0, -1e-8)):
        A[i] = v * np.eye(3)
    E3, q1, q2, q3 = etd._phi_functions(A)
    Es, s1, s2, s3 = etd._phi_functions_scalar(
        np.array([-0.5, 2.0, -30.0, 0.0, 7.0, -1e-8]))
    for got, want in ((E3, Es), (q1, s1), (q2, s2), (q3, s3)):
        np.testing.assert_allclose(got[:, 0, 0], want.real, rtol=1e-12)


def test_scalar_linear_operator_matches_tendency():
    """L reproduces the linear terms of the barotropic tendency.

    Part 1 (nu/r_drag/nu4, exact): these are applied SPECTRALLY in the
    tendency, so full - advection-only equals L*zeta_hat to float32
    round-off on a random O(1) state.
    Part 2 (beta, tiny amplitude): the RK4 path computes -beta*v inside
    the physical advection product, so a finite-amplitude difference is
    dominated by eps*|advection| transform round-off; at amplitude
    1e-6 the advection is O(eps^2) and the difference isolates the
    beta diagonal -i*beta*kx*rlap."""
    from xlab_fftbarotropic.models import barotropic as bt
    cfg = _cfg(r_drag=1e-4, nu4=1e10)
    t = sp.SpectralTables.from_config(cfg)
    rng = np.random.default_rng(0)
    shape = cfg.spectral_shape
    z = jnp.asarray((rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))
                    .astype(np.complex64))
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    full = bt.tendency(t, z, src, nu=float(cfg.nu),
                       grid_shape=cfg.grid_shape,
                       r_drag=float(cfg.r_drag), nu4=float(cfg.nu4))
    adv = bt.tendency(t, z, src, nu=0.0, grid_shape=cfg.grid_shape)
    L = etd.scalar_linear_operator(cfg, "barotropic")
    want = np.asarray(L.astype(np.complex64)) * np.asarray(z)
    got = np.asarray(full - adv)
    assert np.linalg.norm(got - want) < 1e-5 * np.linalg.norm(want)

    # beta probe: a VALID real-field spectrum (random spectra violate
    # the Hermitian column-0/Nyquist symmetry and the +ik Nyquist
    # convention is not a pure diagonal under the physical roundtrip —
    # those modes sit outside the dealias mask, where ETD freezes the
    # state anyway), amplitude 1e-6 so advection is O(eps^2), beta
    # large enough to dominate the transform round-off
    from xlab_fftbarotropic.ops import fft as _fft
    cfgb = _cfg(beta=1e-5)
    v0 = 1e-6 * rng.standard_normal(cfg.grid_shape).astype(np.float32)
    zb = _fft.forward(jnp.asarray(v0))
    fullb = bt.tendency(t, zb, src, nu=0.0, grid_shape=cfg.grid_shape,
                        beta=float(cfgb.beta))
    advb = bt.tendency(t, zb, src, nu=0.0, grid_shape=cfg.grid_shape)
    Lb = etd.scalar_linear_operator(cfgb, "barotropic")
    wantb = np.asarray(Lb.astype(np.complex64)) * np.asarray(zb)
    gotb = np.asarray(fullb - advb)
    m = np.asarray(t.mask) != 0
    assert np.linalg.norm((gotb - wantb)[m]) \
        < 1e-4 * np.linalg.norm(wantb[m])


# ---------------------------------------------------------------------------
# barotropic family
# ---------------------------------------------------------------------------

def test_bt_etd_linear_decay_exact():
    """Tiny-amplitude single-mode state: ETDRK4 reproduces the exact
    exp((nu*lap - r - nu4*lap^2) t) decay at a dt where the explicit
    scheme's viscous stability is long gone."""
    cfg = _cfg(nu=200.0, r_drag=1e-5, nu4=1e13, dt=600.0,
               time_scheme="etdrk4")
    m = BarotropicModel.build(cfg)
    x, y = cfg.coords()
    X, Y = np.asarray(x)[:, None], np.asarray(y)[None, :]
    v0 = (1e-9 * np.cos(2 * np.pi * (3 * X / cfg.lx + 2 * Y / cfg.ly))
          ).astype(np.float32)
    s0 = m.init_state(jnp.asarray(v0))
    out = m.segment(s0, m.zero_source(), 8)
    kx = sp.wavenumbers_x(64, cfg.lx)
    ky = sp.wavenumbers_y(64, cfg.ly)
    lap = -(kx[3] ** 2 + ky[2] ** 2)
    lam = cfg.nu * lap - cfg.r_drag - cfg.nu4 * lap * lap
    want = complex(np.asarray(s0)[3, 2]) * np.exp(lam * 8 * cfg.dt)
    got = complex(np.asarray(out)[3, 2])
    assert abs(got - want) < 1e-5 * abs(want), (got, want)


def test_bt_etd_beta_rossby_dispersion_exact():
    """beta-plane: the linear Rossby phase rotation
    exp(i*beta*kx/k^2 * t) is integrated exactly (the complex scalar
    tables carry the dispersion), at a dt far beyond what explicit
    phase resolution would need."""
    cfg = _cfg(beta=1e-9, nu=200.0, dt=500.0, time_scheme="etdrk4")
    m = BarotropicModel.build(cfg)
    x, y = cfg.coords()
    X, Y = np.asarray(x)[:, None], np.asarray(y)[None, :]
    v0 = (1e-9 * np.cos(2 * np.pi * (2 * X / cfg.lx + Y / cfg.ly))
          ).astype(np.float32)
    s0 = m.init_state(jnp.asarray(v0))
    out = m.segment(s0, m.zero_source(), 10)
    kx = sp.wavenumbers_x(64, cfg.lx)
    ky = sp.wavenumbers_y(64, cfg.ly)
    lap = -(kx[2] ** 2 + ky[1] ** 2)
    lam = cfg.nu * lap - 1j * cfg.beta * kx[2] / lap
    want = complex(np.asarray(s0)[2, 1]) * np.exp(lam * 10 * cfg.dt)
    got = complex(np.asarray(out)[2, 1])
    assert abs(got - want) < 1e-5 * abs(want), (got, want)
    # tables really went complex
    tabs = etd.build_scalar_tables(cfg, cfg.dt, kind="barotropic",
                                   cached=False)
    assert jnp.iscomplexobj(tabs.E)


def test_bt_etd_rk4_parity_small_dt():
    """Both schemes are 4th order; at the reference dt they agree to
    the float32 plateau over 20 steps (measured 4.8e-7)."""
    cfg = _cfg()
    v0 = jnp.asarray(makefields.gaussian(cfg))
    m_rk = BarotropicModel.build(cfg)
    m_et = BarotropicModel.build(cfg.replace(time_scheme="etdrk4"))
    s0 = m_rk.init_state(v0)
    a = m_rk.segment(s0, m_rk.zero_source(), 20)
    b = m_et.segment(s0, m_et.zero_source(), 20)
    assert _rel(b, a) < 1e-5


def test_bt_etd_stable_above_viscous_bound():
    """High-nu4 configuration where RK4's real-axis stability bound
    |nu4*k_max^4|*dt <= 2.785 is violated 10x: RK4 blows up, ETDRK4
    stays finite and matches a fine-dt RK4 reference trajectory —
    the dt cap the scheme exists to remove
    (VERDICT r4 item 2 / __graft_entry__.py:90-91 rationale)."""
    import math
    cfg0 = _cfg()
    k_max2 = (math.pi * 64 / cfg0.lx) ** 2 + (math.pi * 64 / cfg0.ly) ** 2
    nu4 = 10.0 * 2.785 / (k_max2 ** 2 * cfg0.dt)   # |lam|*dt = 10*2.785
    cfg = cfg0.replace(nu4=nu4)
    v0 = jnp.asarray(makefields.gaussian(cfg))
    m_rk = BarotropicModel.build(cfg)
    m_et = BarotropicModel.build(cfg.replace(time_scheme="etdrk4"))
    s0 = m_rk.init_state(v0)
    bad = m_rk.segment(s0, m_rk.zero_source(), 60)
    assert not bool(jnp.all(jnp.isfinite(jnp.abs(bad))))
    out = m_et.segment(s0, m_et.zero_source(), 60)
    assert bool(jnp.all(jnp.isfinite(jnp.abs(out))))
    # fine-dt RK4 (stable: |lam*dt| = 0.56) as the truth
    m_fine = BarotropicModel.build(cfg.replace(dt=cfg.dt / 50))
    ref = m_fine.segment(s0, m_fine.zero_source(), 60 * 50)
    assert _rel(out, ref) < 1e-4


def test_bt_etd_above_mask_modes_frozen():
    """Dealias contract: state modes outside the circular mask stay
    bit-frozen (identity-blended propagators, zeroed weights)."""
    cfg = _cfg(time_scheme="etdrk4")
    t = sp.SpectralTables.from_config(cfg)
    m = BarotropicModel.build(cfg)
    s0 = m.init_state(jnp.asarray(makefields.gaussian(cfg)))
    assert np.asarray(t.mask)[30, 30] == 0.0
    z = np.asarray(s0).copy()
    z[30, 30] = 7.0 + 3.0j
    out = m.segment(jnp.asarray(z), m.zero_source(), 10)
    assert np.asarray(out)[30, 30] == np.complex64(7.0 + 3.0j)


# ---------------------------------------------------------------------------
# tracer family
# ---------------------------------------------------------------------------

def test_tracer_etd_rk4_parity_small_dt():
    cfg = _cfg()
    v0 = jnp.asarray(makefields.gaussian(cfg))
    q0 = tracer_ic(cfg, "gaussian")
    m_rk = TracerModel.build(cfg, kappa=50.0)
    m_et = TracerModel.build(cfg.replace(time_scheme="etdrk4"),
                             kappa=50.0)
    s0 = m_rk.init_state(v0, q0)
    a = m_rk.segment(s0, m_rk.zero_source(), 20)
    b = m_et.segment(s0, m_et.zero_source(), 20)
    assert _rel(b.zeta_hat, a.zeta_hat) < 1e-5
    assert _rel(b.q_hat, a.q_hat) < 1e-5


def test_tracer_etd_kappa_decay_exact():
    """The tracer slot's kappa*lap diffusion is exact at any dt for a
    frozen flow (zero vorticity -> zero advection)."""
    cfg = _cfg(dt=3000.0, time_scheme="etdrk4")
    m = TracerModel.build(cfg, kappa=500.0)
    x, y = cfg.coords()
    X, Y = np.asarray(x)[:, None], np.asarray(y)[None, :]
    q0 = np.cos(2 * np.pi * (X / cfg.lx + 4 * Y / cfg.ly)
                ).astype(np.float32)
    s0 = m.init_state(np.zeros(cfg.grid_shape, np.float32), q0)
    out = m.segment(s0, m.zero_source(), 5)
    kx = sp.wavenumbers_x(64, cfg.lx)
    ky = sp.wavenumbers_y(64, cfg.ly)
    lam = 500.0 * -(kx[1] ** 2 + ky[4] ** 2)
    want = complex(np.asarray(s0.q_hat)[1, 4]) * np.exp(lam * 5 * cfg.dt)
    got = complex(np.asarray(out.q_hat)[1, 4])
    assert abs(got - want) < 1e-5 * abs(want)


@pytest.mark.parametrize("decomp", ["slab", "xpencil"])
def test_sharded_bt_etd_matches_single(decomp):
    from xlab_fftbarotropic.parallel import (ShardedBarotropicModel,
                                                 make_mesh)
    cfg = _cfg(time_scheme="etdrk4")
    mesh = make_mesh(jax.devices())
    v0 = jnp.asarray(makefields.gaussian(cfg))
    single = BarotropicModel.build(cfg)
    multi = ShardedBarotropicModel.build(cfg, mesh, decomp=decomp)
    s1 = single.segment(single.init_state(v0), single.zero_source(), 3)
    sN = multi.unshard_spectral(
        multi.segment(multi.init_state(v0), multi.zero_source(), 3))
    assert _rel(jnp.asarray(sN), s1) < 1e-5


def test_sharded_tracer_etd_matches_single():
    from xlab_fftbarotropic.parallel import (ShardedTracerModel,
                                                 make_mesh)
    cfg = _cfg(time_scheme="etdrk4")
    mesh = make_mesh(jax.devices())
    v0 = jnp.asarray(makefields.gaussian(cfg))
    q0 = tracer_ic(cfg, "gaussian")
    single = TracerModel.build(cfg, kappa=50.0)
    multi = ShardedTracerModel.build(cfg, mesh, kappa=50.0)
    a = single.segment(single.init_state(v0, q0),
                       single.zero_source(), 3)
    b = multi.unshard_state(
        multi.segment(multi.init_state(v0, q0), multi.zero_source(), 3))
    assert _rel(jnp.asarray(b.zeta_hat), a.zeta_hat) < 1e-5
    assert _rel(jnp.asarray(b.q_hat), a.q_hat) < 1e-5


# ---------------------------------------------------------------------------
# phi-table disk cache
# ---------------------------------------------------------------------------

def test_table_cache_roundtrip_and_invalidation(tmp_path, monkeypatch):
    """Second build of the same (config numerics, dt) loads from disk
    (the host builder is NOT called again) bit-identically; a numerics
    change produces a different key; record/path fields do not
    invalidate."""
    monkeypatch.setenv("XFB_ETD_CACHE", str(tmp_path))
    cfg = _cfg()
    t1 = etd.build_scalar_tables(cfg, 3.0, kind="barotropic")
    assert len(list(tmp_path.glob("barotropic_etd_*.npy"))) == 1

    def boom(*a, **k):
        raise AssertionError("cache miss: host builder re-ran")

    monkeypatch.setattr(etd, "_build_scalar_tables_host", boom)
    t2 = etd.build_scalar_tables(cfg, 3.0, kind="barotropic")
    for a, b in zip(t1, t2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # path/cadence fields are excluded from the key
    t3 = etd.build_scalar_tables(
        cfg.replace(output_dir="elsewhere", record_step=7), 3.0,
        kind="barotropic")
    del t3
    monkeypatch.undo()
    monkeypatch.setenv("XFB_ETD_CACHE", str(tmp_path))
    # numerics change -> new key (rebuilds)
    etd.build_scalar_tables(cfg.replace(nu=1.0), 3.0, kind="barotropic")
    assert len(list(tmp_path.glob("barotropic_etd_*.npy"))) == 2
    # kappa keys the tracer tables
    etd.build_scalar_tables(cfg, 3.0, kind="tracer", kappa=1.0)
    etd.build_scalar_tables(cfg, 3.0, kind="tracer", kappa=2.0)
    assert len(list(tmp_path.glob("tracer_etd_*.npy"))) == 2


def test_sw_table_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("XFB_ETD_CACHE", str(tmp_path))
    cfg = _cfg()
    t1 = etd.build_tables_cached(cfg, 5.0)

    def boom(*a, **k):
        raise AssertionError("cache miss: host builder re-ran")

    monkeypatch.setattr(etd, "_build_tables_host", boom)
    t2 = etd.build_tables_cached(cfg, 5.0)
    for a, b in zip(t1, t2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # dt is part of the key: another dt must rebuild -> second file
    monkeypatch.undo()
    monkeypatch.setenv("XFB_ETD_CACHE", str(tmp_path))
    etd.build_tables_cached(cfg, 7.0)
    assert len(list(tmp_path.glob("sw_etd_*.npy"))) == 2


def test_cache_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("XFB_ETD_CACHE", "0")
    cfg = _cfg()
    etd.build_scalar_tables(cfg, 3.0, kind="barotropic")
    assert list(tmp_path.iterdir()) == []


def test_bench_cache_key_is_stable():
    """Pin the cache key `bench.py`'s sw-etdrk4 family resolves for the
    default 4096^2 / dt=7.5 configuration. The end-of-round bench budget
    depends on the pre-built `output/etd_cache/sw_etd_<key>.npy` staying
    WARM (cold host derivation costs ~300 s, BASELINE.md 2026-08-21); a
    change to the key fields, their serialization, or the key version
    silently cold-starts it. If this pin fails on a DELIBERATE numerics/
    key change, rebuild the cache for the new key (the prebuild recipe in
    BASELINE.md) and update the hash here."""
    cfg = ModelConfig(nx=4096, ny=4096, dt=7.5, time_scheme="etdrk4")
    assert etd.tables_cache_key(cfg, 7.5, kind="sw") == "78d5353e25b4bfb7"


# ---------------------------------------------------------------------------
# advective-CFL guard
# ---------------------------------------------------------------------------

def test_max_advective_dt_formula():
    import math
    cfg = _cfg()
    u = 10.0
    k_max = math.pi * math.hypot(64 / cfg.lx, 64 / cfg.ly)
    assert abs(etd.max_advective_dt(cfg, u) - 2.8 / (u * k_max)) < 1e-12
    # consistency with the stat-space limit: for an axis-aligned wind
    # the sharp bound dt = 2.8*dx/(pi*u) is LOOSER than the isotropic
    # estimate (hypot >= single-axis)
    assert etd.max_advective_dt(cfg, u) <= 2.8 * cfg.dx / (math.pi * u)


def test_check_etd_cfl_warns_then_raises():
    from xlab_fftbarotropic.utils.guards import (AdvectiveCflError,
                                                     ETD_CFL_LIMIT,
                                                     check_etd_cfl)
    cfg = _cfg(dt=100.0)
    check_etd_cfl(0, 0.5 * ETD_CFL_LIMIT, cfg, at_start=True)   # quiet
    with pytest.warns(UserWarning, match="advective CFL"):
        check_etd_cfl(0, 2.0, cfg, at_start=True)
    with pytest.raises(AdvectiveCflError, match="reduce dt below"):
        check_etd_cfl(300, 2.0, cfg, at_start=False)
    check_etd_cfl(300, float("nan"), cfg, at_start=False)        # defers
    check_etd_cfl(300, None, cfg, at_start=False)


def test_runner_guard_trips_on_violating_etd_run(tmp_path):
    """An over-dt ETDRK4 run warns at the initial record and aborts
    with AdvectiveCflError at the first violating later record —
    instead of integrating on to a NaN BlowUpError."""
    from xlab_fftbarotropic import runner
    from xlab_fftbarotropic.utils.guards import AdvectiveCflError
    cfg = _cfg(time_scheme="etdrk4", record_step=1, total_steps=5,
               output_dir=str(tmp_path / "out"))
    # scale the vortex so the initial cfl stat lands above 2.8/pi but
    # the state survives the first couple of steps finite
    from xlab_fftbarotropic.models.shallow_water import (
        ShallowWaterModel)
    base = makefields.gaussian(cfg)
    m = ShallowWaterModel.build(cfg)
    s0 = m.geostrophic_init(jnp.asarray(base))
    cfl0 = float(m.stats(s0).cfl)
    amp = 1.5 * (2.8 / np.pi) / cfl0
    with pytest.warns(UserWarning, match="advective CFL"), \
            pytest.raises(AdvectiveCflError):
        runner.run(cfg, vort0=amp * np.asarray(base),
                   model_kind="shallow-water", record=True,
                   manifest_path=str(tmp_path / "log"))


def test_runner_etd_run_under_limit_completes(tmp_path):
    from xlab_fftbarotropic import runner
    cfg = _cfg(time_scheme="etdrk4", record_step=5, total_steps=10,
               output_dir=str(tmp_path / "out"))
    res = runner.run(cfg, vort0=makefields.gaussian(cfg),
                     model_kind="barotropic", record=True,
                     manifest_path=str(tmp_path / "log"))
    assert res.steps_run == 10
    assert all(s["cfl"] < 2.8 / np.pi for s in res.stats_history)
