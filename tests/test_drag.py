"""Boundary-layer feedback (Ekman/Rayleigh drag) — the capability the
reference left as TODO.md:11 ("Add boundary layer feedback mechanism").

Implemented as linear spin-down -r_drag*zeta on the vorticity equation
(and -r_drag*delta on the SW divergence; the mass equation untouched),
applied per RK stage exactly like the viscous term. r_drag=0 (default)
is a static trace-time branch, so every existing parity pin is
untouched by construction.

Correctness anchors:
* a single Fourier mode self-advects to zero (1-D field => J(psi,zeta)=0),
  so its exact trajectory is zeta0 * exp(-(nu*k^2 + r) t) — an analytic
  pin the RK4 solution must hit to integrator accuracy;
* sharded (shard_map) and adjoint paths thread the same coefficient.
"""

import jax
import jax.numpy as jnp
import numpy as np

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.models import shallow_water as sw
from xlab_fftbarotropic.models import tracer as tr
from xlab_fftbarotropic.ops import fft
from xlab_fftbarotropic.ops.spectral import SpectralTables


R = 2e-3   # e-folding 500 s — visible decay over a few hundred steps


def _single_mode_ic(cfg: ModelConfig, amp: float = 1.0) -> np.ndarray:
    """zeta(x) = amp * sin(2 pi x / Lx): a 1-D field, so u*zeta_x +
    v*zeta_y = 0 exactly and the evolution is purely linear."""
    x, _ = cfg.coords()
    X = np.asarray(x)[:, None]
    return (amp * np.sin(2 * np.pi * X / cfg.lx)
            * np.ones((1, cfg.ny))).astype(np.float32)


def test_single_mode_analytic_decay():
    cfg = ModelConfig(nx=64, ny=64, dt=3.0, r_drag=R)
    m = BarotropicModel.build(cfg)
    v0 = _single_mode_ic(cfg)
    n = 100
    z = m.segment(m.init_state(v0), m.zero_source(), n)
    got = np.asarray(fft.inverse(z, cfg.grid_shape))
    k1 = 2 * np.pi / cfg.lx
    lam = cfg.nu * k1 * k1 + R
    ref = v0 * np.exp(-lam * n * cfg.dt)
    assert np.max(np.abs(got - ref)) < 1e-5 * np.max(np.abs(v0))


def test_drag_strictly_damps_energy():
    """Same turbulent IC with and without drag: drag run must carry
    strictly less enstrophy after a burst of steps."""
    from xlab_fftbarotropic.ic import makefields
    cfg0 = ModelConfig(nx=64, ny=64)
    cfg1 = cfg0.replace(r_drag=5e-3)
    v0 = makefields.kuo2004(cfg0)
    m0, m1 = BarotropicModel.build(cfg0), BarotropicModel.build(cfg1)
    src = m0.zero_source()
    z0 = m0.segment(m0.init_state(v0), src, 30)
    z1 = m1.segment(m1.init_state(v0), src, 30)
    s0 = m0.stats(z0)
    s1 = m1.stats(z1)
    assert float(s1.enstrophy) < float(s0.enstrophy) * 0.9
    assert float(s1.energy) < float(s0.energy)


def test_sw_drag_tendency_exact():
    """SW: drag adds exactly (-r*zeta_hat, -r*div_hat, 0)."""
    cfg = ModelConfig(nx=32, ny=32)
    t = SpectralTables.from_config(cfg)
    rng = np.random.default_rng(3)
    sh = cfg.spectral_shape

    def spec():
        return jnp.asarray(
            (rng.standard_normal(sh) + 1j * rng.standard_normal(sh))
            .astype(np.complex64))

    s = sw.SWState(zeta_hat=spec(), div_hat=spec(), eta_hat=spec())
    args = (t, s, None, cfg.f, cfg.gravity, cfg.nu, cfg.mean_depth,
            cfg.grid_shape)
    d0 = sw.tendency(*args)
    d1 = sw.tendency(*args, r_drag=R)
    np.testing.assert_allclose(np.asarray(d1.zeta_hat - d0.zeta_hat),
                               np.asarray(-R * s.zeta_hat), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(d1.div_hat - d0.div_hat),
                               np.asarray(-R * s.div_hat), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(np.asarray(d1.eta_hat),
                                  np.asarray(d0.eta_hat))


def test_tracer_drag_flow_only():
    """Tracer family: the flow spins down, the tracer equation itself is
    drag-free (it feels the boundary layer via the velocities only)."""
    cfg = ModelConfig(nx=32, ny=32)
    t = SpectralTables.from_config(cfg)
    rng = np.random.default_rng(5)
    sh = cfg.spectral_shape

    def spec():
        return jnp.asarray(
            (rng.standard_normal(sh) + 1j * rng.standard_normal(sh))
            .astype(np.complex64))

    s = tr.TracerState(zeta_hat=spec(), q_hat=spec())
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    d0 = tr.tendency(t, s, src, cfg.nu, 0.0, cfg.grid_shape)
    d1 = tr.tendency(t, s, src, cfg.nu, 0.0, cfg.grid_shape, r_drag=R)
    np.testing.assert_allclose(np.asarray(d1.zeta_hat - d0.zeta_hat),
                               np.asarray(-R * s.zeta_hat), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(np.asarray(d1.q_hat),
                                  np.asarray(d0.q_hat))


def test_fd_core_drag_decay():
    """FD/Arakawa core: with nu=0 a single mode decays as exp(-r t)
    (the Arakawa Jacobian of a 1-D field is identically zero)."""
    from xlab_fftbarotropic.models.fd_core import FDBarotropicModel
    cfg = ModelConfig(nx=32, ny=32, nu=0.0, dt=3.0, r_drag=R)
    m = FDBarotropicModel.build(cfg)
    v0 = jnp.asarray(_single_mode_ic(cfg))
    psi0 = m.init_psi(v0)
    n = 50
    z, _ = m.segment(v0, psi0, m.zero_source(), n)
    ref = np.asarray(v0) * np.exp(-R * n * cfg.dt)
    assert np.max(np.abs(np.asarray(z) - ref)) < 1e-5


def test_sharded_drag_matches_single_device():
    from xlab_fftbarotropic.parallel import (ShardedBarotropicModel,
                                                 make_mesh)
    from xlab_fftbarotropic.ic import makefields
    cfg = ModelConfig(nx=64, ny=64, r_drag=R)
    mesh = make_mesh(jax.devices())
    v0 = makefields.kuo2004(cfg)
    m1 = BarotropicModel.build(cfg)
    z1 = m1.segment(m1.init_state(v0), m1.zero_source(), 5)
    ms = ShardedBarotropicModel.build(cfg, mesh)
    zs = ms.segment(ms.init_state(v0), ms.zero_source(), 5)
    a = np.asarray(fft.inverse(z1, cfg.grid_shape))
    b = np.asarray(fft.inverse(jnp.asarray(zs), cfg.grid_shape))
    assert np.max(np.abs(a - b)) < 1e-5 * max(1.0, np.max(np.abs(a)))


def test_adjoint_gradient_carries_drag():
    """d(final amplitude)/d(IC amplitude) of the advection-free mode is
    exactly exp(-lam*T): the rollout gradient must see the drag."""
    from xlab_fftbarotropic.adjoint import make_rollout
    cfg = ModelConfig(nx=32, ny=32, dt=3.0, r_drag=R)
    n = 20
    roll = make_rollout(cfg, n)
    v0 = jnp.asarray(_single_mode_ic(cfg))
    src = jnp.zeros(cfg.grid_shape, jnp.float32)

    def amp_out(a):
        return jnp.vdot(v0, roll(a * v0, src)) / jnp.vdot(v0, v0)

    g = float(jax.grad(amp_out)(1.0))
    k1 = 2 * np.pi / cfg.lx
    lam = cfg.nu * k1 * k1 + R
    assert abs(g - np.exp(-lam * n * cfg.dt)) < 1e-5


def test_cli_flag_roundtrip():
    import argparse
    from xlab_fftbarotropic.config import (add_config_args,
                                               config_from_args)
    p = add_config_args(argparse.ArgumentParser())
    cfg = config_from_args(p.parse_args(["--r-drag", "0.004"]))
    assert cfg.r_drag == 0.004
    assert ModelConfig.from_json(cfg.to_json()).r_drag == 0.004
    # default stays exactly zero => static no-drag branch
    assert config_from_args(p.parse_args([])).r_drag == 0.0
