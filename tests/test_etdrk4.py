"""ETDRK4 exponential SW integrator (models/etdrk4.py).

Pinning strategy: the scheme's value is exact linear propagation at any
dt, so the load-bearing tests are (1) the phi-function table algebra
against its defining identities, (2) near-exactness in the linear
regime at a dt far above the gravity-wave CFL bound, (3) agreement
with the RK4 reference path at small dt (both 4th-order; differences
sit at the float32 round-off floor ~3e-5 of the state norm, the same
plateau RK4 shows against its own dt-refinement), and (4) stability +
exact mass conservation at 5x the RK4 bound, where RK4 verifiably
blows up.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.models import etdrk4 as etd
from xlab_fftbarotropic.models.shallow_water import (
    ShallowWaterModel, max_stable_dt)
from xlab_fftbarotropic.ops.spectral import SpectralTables


def _cfg(**kw):
    return ModelConfig(nx=64, ny=64, **kw)


def _rel(a, b):
    return float(jnp.linalg.norm(a - b)
                 / jnp.maximum(jnp.linalg.norm(b), 1e-30))


def test_phi_identities_and_expm():
    """E, phi1..phi3 satisfy their defining identities
    A phi1 = E - I, A^2 phi2 = E - I - A, A^3 phi3 = E - I - A - A^2/2,
    and E(A) == E2(A/2)^2, on matrices spanning the physical regimes
    (tiny, wave-dominated, the stiff H-coupling block, zero)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 3, 3))
    A[0] *= 1e-3
    A[1] = np.array([[0.0, -1e-5, 0.0], [1e-5, 0.0, 9.0e-3],
                     [0.0, -1000.0, 0.0]]) * 8.0   # gravity block * dt
    A[2] *= 5.0
    A[2] -= 6.0 * np.eye(3)      # damped
    A[3] = 0.0
    E, p1, p2, p3 = etd._phi_functions(A)
    E2, _, _, _ = etd._phi_functions(A * 0.5)
    eye = np.eye(3)
    for i in range(len(A)):
        sc = max(np.linalg.norm(E[i]), 1.0)
        assert np.linalg.norm(A[i] @ p1[i] - (E[i] - eye)) < 1e-9 * sc
        assert np.linalg.norm(
            A[i] @ A[i] @ p2[i] - (E[i] - eye - A[i])) < 1e-9 * sc
        assert np.linalg.norm(
            A[i] @ A[i] @ A[i] @ p3[i]
            - (E[i] - eye - A[i] - A[i] @ A[i] / 2)) < 1e-8 * sc
        assert np.linalg.norm(E2[i] @ E2[i] - E[i]) < 1e-9 * sc
    # zero matrix: exact RK4-limit values
    assert np.allclose(E[3], eye)
    assert np.allclose(p1[3], eye)
    assert np.allclose(p2[3], eye / 2)
    assert np.allclose(p3[3], eye / 6)


def test_linear_matrix_matches_tendency():
    """L agrees with the split-linear terms of the tendency function:
    applying L to a random state reproduces tendency() minus its
    nonlinear part (i.e. tendency at zero velocity products — evaluated
    by zeroing the state fed to the transforms via the nonlinear-only
    call)."""
    cfg = _cfg(r_drag=1e-4, nu4=1e2)
    t = SpectralTables.from_config(cfg)
    from xlab_fftbarotropic.models import shallow_water as swm
    rng = np.random.default_rng(1)
    shape = cfg.spectral_shape
    s = swm.SWState(*(jnp.asarray(
        (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        .astype(np.complex64)) for _ in range(3)))
    full = swm.tendency(t, s, None, f=float(cfg.f),
                        g=float(cfg.gravity), nu=float(cfg.nu),
                        mean_depth=float(cfg.mean_depth),
                        grid_shape=cfg.grid_shape, split=True,
                        r_drag=float(cfg.r_drag), nu4=float(cfg.nu4))
    nonlin = swm.tendency(t, s, None, f=0.0, g=0.0, nu=0.0,
                          mean_depth=0.0, grid_shape=cfg.grid_shape,
                          split=True)
    L = etd.sw_linear_matrix(cfg)         # (nx, hny, 3, 3)
    vec = jnp.stack(list(s), axis=-1)     # (nx, hny, 3)
    lin = jnp.einsum("xyij,xyj->xyi", jnp.asarray(L, jnp.complex64), vec)
    for i, (a, b) in enumerate(zip(full, nonlin)):
        got = np.asarray(a - b)
        want = np.asarray(lin[..., i])
        assert np.linalg.norm(got - want) < 1e-4 * max(
            np.linalg.norm(want), 1.0), i


def test_linear_regime_near_exact_above_cfl():
    """Tiny-amplitude (linear) dynamics at dt ABOVE the gravity-wave
    bound: ETDRK4 matches a fine-dt RK4 reference to float32 round-off
    — the linear propagation is exact by construction."""
    cfg = _cfg()
    dtg = max_stable_dt(cfg)
    T = 8 * dtg
    vort = 1e-6 * jnp.asarray(makefields.gaussian(cfg))
    m_ref = ShallowWaterModel.build(cfg.replace(dt=T / 64))
    s0 = m_ref.init_state(vort)
    ref = m_ref.segment(s0, None, 64)
    m = ShallowWaterModel.build(cfg.replace(dt=T / 4,
                                            time_scheme="etdrk4"))
    out = m.segment(s0, None, 4)         # dt = 2x the RK4 bound
    nrm = sum(float(jnp.linalg.norm(x)) for x in ref)
    err = sum(float(jnp.linalg.norm(x - y)) for x, y in zip(out, ref))
    assert err < 2e-5 * nrm, err / nrm


def test_rk4_parity_small_dt():
    """Nonlinear amplitude, dt well under the CFL bound: the two
    4th-order schemes agree to the float32 plateau."""
    cfg = _cfg()
    dts = 0.1 * max_stable_dt(cfg)
    vort = jnp.asarray(makefields.gaussian(cfg))
    m_rk = ShallowWaterModel.build(cfg.replace(dt=dts))
    m_et = ShallowWaterModel.build(cfg.replace(dt=dts,
                                               time_scheme="etdrk4"))
    s0 = m_rk.init_state(vort)
    a = m_rk.segment(s0, None, 50)
    b = m_et.segment(s0, None, 50)
    assert _rel(b.zeta_hat, a.zeta_hat) < 3e-4
    assert _rel(b.eta_hat, a.eta_hat) < 3e-4


def test_stable_and_mass_conserving_far_above_cfl():
    """5x the RK4 gravity-wave bound: stable, finite, mass conserved
    (the mean mode's nilpotent block is integrated exactly); RK4 at
    the same dt blows up (establishes the bound is really lifted)."""
    cfg = _cfg()
    dtg = max_stable_dt(cfg)
    vort = jnp.asarray(makefields.gaussian(cfg))
    with pytest.warns(UserWarning, match="CFL"):
        m_rk = ShallowWaterModel.build(cfg.replace(dt=5 * dtg))
    m_et = ShallowWaterModel.build(cfg.replace(dt=5 * dtg,
                                               time_scheme="etdrk4"))
    s0 = m_et.geostrophic_init(vort)
    out = m_et.segment(s0, None, 200)
    assert all(bool(jnp.all(jnp.isfinite(jnp.abs(x)))) for x in out)
    st = m_et.stats(out)
    assert abs(float(st.mass) - float(cfg.mean_depth)) < 1e-3
    bad = m_rk.segment(s0, None, 200)
    assert not bool(jnp.all(jnp.isfinite(jnp.abs(bad.zeta_hat))))


def test_above_mask_modes_frozen():
    """The dealias contract (tendency masked, state untouched) carries
    over: a state mode outside the circular mask stays bit-frozen."""
    cfg = _cfg()
    t = SpectralTables.from_config(cfg)
    m = ShallowWaterModel.build(cfg.replace(dt=2 * max_stable_dt(cfg),
                                            time_scheme="etdrk4"))
    vort = jnp.asarray(makefields.gaussian(cfg))
    s0 = m.init_state(vort)
    mask = np.asarray(t.mask)
    iu, ju = 30, 30                      # far outside ceil(64/3)=22
    assert mask[iu, ju] == 0.0
    z = np.asarray(s0.zeta_hat).copy()
    z[iu, ju] = 7.0 + 3.0j
    s0 = s0._replace(zeta_hat=jnp.asarray(z))
    out = m.segment(s0, None, 10)
    got = np.asarray(out.zeta_hat)[iu, ju]
    assert got == np.complex64(7.0 + 3.0j)


@pytest.mark.parametrize("decomp", ["slab", "xpencil", "pencil"])
def test_sharded_etdrk4_matches_single(decomp):
    """Sharded ETDRK4 (slab, padded-xpencil, and 2-D pencil table
    layouts) matches the single-device ETDRK4 trajectory on the
    8-virtual-device mesh, at a dt above the RK4 gravity-wave bound."""
    from xlab_fftbarotropic.parallel import (
        ShardedShallowWaterModel, make_mesh)
    cfg = ModelConfig(nx=64, ny=64, time_scheme="etdrk4")
    cfg = cfg.replace(dt=2 * max_stable_dt(cfg))
    if decomp == "pencil":
        from xlab_fftbarotropic.parallel import pencil
        mesh = pencil.make_pencil_mesh((2, 4), jax.devices())
    else:
        mesh = make_mesh(jax.devices())
    vort0 = jnp.asarray(makefields.gaussian(cfg, zeta0=1e-5))
    single = ShallowWaterModel.build(cfg)
    multi = ShardedShallowWaterModel.build(cfg, mesh, decomp=decomp)
    s1 = single.segment(single.geostrophic_init(vort0),
                        single.zero_source(), 3)
    sN = multi.unshard_state(
        multi.segment(multi.geostrophic_init(vort0),
                      multi.zero_source(), 3))
    scale = max(float(jnp.max(jnp.abs(f))) for f in s1)
    for a, b in zip(sN, s1):
        np.testing.assert_allclose(np.asarray(a) / scale,
                                   np.asarray(b) / scale,
                                   rtol=0, atol=5e-5)


def test_checkpoint_scheme_mismatch_rejected(tmp_path):
    """time_scheme is in the restart hash (the two schemes produce
    different trajectories at big dt — resuming one from the other
    would silently splice them), so a resume across schemes fails
    loudly while a same-scheme resume round-trips exactly."""
    from xlab_fftbarotropic.io.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
    cfg = _cfg(time_scheme="etdrk4")
    m = ShallowWaterModel.build(cfg)
    s = m.init_state(jnp.asarray(makefields.gaussian(cfg)))
    packed = np.stack([np.asarray(a) for a in s])
    p = tmp_path / "ck.npz"
    save_checkpoint(p, cfg, packed, step=7, kind="sw")
    got, step, _ = load_checkpoint(p, cfg=cfg, kind="sw")
    assert step == 7
    np.testing.assert_array_equal(got, packed)
    with pytest.raises(ValueError, match="config mismatch"):
        load_checkpoint(p, cfg=cfg.replace(time_scheme="rk4"),
                        kind="sw")


def test_unknown_time_scheme_rejected():
    """Every family rejects an unknown scheme loudly (a silent RK4
    fall-back would misreport the integrator actually used). The
    etdrk4 scheme itself is supported by ALL spectral families since
    round 5 — scalar-family coverage lives in tests/test_etd_scalar.py."""
    from xlab_fftbarotropic.models.barotropic import BarotropicModel
    from xlab_fftbarotropic.models.tracer import TracerModel
    cfg = _cfg(time_scheme="leapfrog")
    with pytest.raises(ValueError, match="time_scheme"):
        BarotropicModel.build(cfg)
    with pytest.raises(ValueError, match="time_scheme"):
        TracerModel.build(cfg, kappa=1.0)


def test_adjoint_through_etdrk4():
    """jax.grad through an ETDRK4 SW rollout (adjoint.make_rollout
    picks the scheme up from the config) is finite and matches a
    central finite difference along a random direction — the
    differentiable-simulation stack needs no ETD-specific rules (the
    matvecs are linear; the kernels' custom VJPs are shared with RK4)."""
    from xlab_fftbarotropic import adjoint
    cfg = _cfg(time_scheme="etdrk4")
    cfg = cfg.replace(dt=2 * max_stable_dt(cfg))
    roll = adjoint.make_rollout(cfg, 3, model_kind="sw")
    v0 = jnp.asarray(makefields.gaussian(cfg))
    src = jnp.zeros(cfg.grid_shape, jnp.float32)

    def loss(v, s):
        out = roll(v, s)
        return sum(jnp.sum(jnp.square(jnp.abs(x)))
                   for x in jax.tree_util.tree_leaves(out)) * 1e-6

    g = jax.grad(loss)(v0, src)
    assert bool(jnp.all(jnp.isfinite(g)))
    rng = np.random.default_rng(3)
    d = jnp.asarray(rng.standard_normal(cfg.grid_shape)
                    .astype(np.float32))
    # FD sweep (2026-08-20): at this 2x-bound dt the rollout is
    # strongly nonlinear in v, so large probes are truncation-dominated
    # (eps=5%: fd 0.57 vs an 1.095) while eps=1% converges to the
    # analytic value within 1.2%; at 0.5x-bound dt the two agree to 4
    # digits. 1% probe + 5% tolerance pins the gradient.
    eps = 1e-2 * float(jnp.max(jnp.abs(v0)))
    fd = (float(loss(v0 + eps * d, src))
          - float(loss(v0 - eps * d, src))) / (2 * eps)
    an = float(jnp.vdot(g, d))
    assert abs(fd - an) < 5e-2 * max(abs(fd), abs(an)), (fd, an)


def test_forcing_enters_like_rk4():
    """The vorticity source rides N (fixed across stages); at small dt
    the forced trajectories of the two schemes agree."""
    cfg = _cfg()
    dts = 0.1 * max_stable_dt(cfg)
    vort = jnp.asarray(makefields.gaussian(cfg))
    src = 1e-7 * jnp.asarray(makefields.gaussian(cfg))
    m_rk = ShallowWaterModel.build(cfg.replace(dt=dts))
    m_et = ShallowWaterModel.build(cfg.replace(dt=dts,
                                               time_scheme="etdrk4"))
    s0 = m_rk.init_state(vort)
    a = m_rk.segment(s0, src, 25)
    b = m_et.segment(s0, src, 25)
    assert _rel(b.zeta_hat, a.zeta_hat) < 3e-4
