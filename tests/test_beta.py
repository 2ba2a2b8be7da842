"""Beta-plane Rossby dynamics — a new capability (the reference is
strictly f-plane, configuration.hpp:11; f enters only the pressure
diagnostic there).

Implemented as the planetary-vorticity advection -beta*v folded into the
advection product (-u*zx - v*(zy + beta)): zero extra transforms on every
path. beta=0 (default)
is a static trace-time branch, so every existing parity pin is untouched
by construction.

Correctness anchors:
* a single zonal mode zeta = A sin(k1 x) self-advects to zero exactly, so
  its trajectory is the analytic westward-propagating Rossby wave
  A exp(-nu k1^2 t) sin(k1 x - omega t) with omega = -beta/k1 — a phase
  AND amplitude pin the RK4 solution must hit to integrator accuracy;
* sharded / adjoint paths pinned against the single-device core under
  beta;
* the FD/Arakawa core satisfies its own DISCRETE dispersion relation
  (centered-difference k_d = sin(k1 dx)/dx over the 5-point k_eff^2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.models import tracer as tr
from xlab_fftbarotropic.ops import fft
from xlab_fftbarotropic.ops import spectral as sp
from xlab_fftbarotropic.ops.spectral import SpectralTables

# exaggerated beta (Earth ~1.6e-11) so the phase moves visibly within a
# few hundred steps on the 600 km reference domain
BETA = 1e-8


def _zonal_mode_ic(cfg: ModelConfig, amp: float = 1e-3) -> np.ndarray:
    """zeta(x) = amp * sin(2 pi x / Lx): u = 0 and J(psi, zeta) = 0
    pointwise, so the evolution is the pure linear Rossby wave."""
    x, _ = cfg.coords()
    X = np.asarray(x)[:, None]
    return (amp * np.sin(2 * np.pi * X / cfg.lx)
            * np.ones((1, cfg.ny))).astype(np.float32)


def _rossby_analytic(cfg: ModelConfig, amp: float, t: float) -> np.ndarray:
    """A exp(-nu k1^2 t) sin(k1 x - omega t), omega = -beta/k1."""
    k1 = 2 * np.pi / cfg.lx
    omega = -cfg.beta / k1
    x, _ = cfg.coords()
    X = np.asarray(x, np.float64)[:, None]
    z = amp * np.exp(-cfg.nu * k1 * k1 * t) * np.sin(k1 * X - omega * t)
    return (z * np.ones((1, cfg.ny))).astype(np.float32)


def test_rossby_wave_analytic_dispersion():
    cfg = ModelConfig(nx=64, ny=64, dt=3.0, beta=BETA)
    m = BarotropicModel.build(cfg)
    amp = 1e-3
    v0 = _zonal_mode_ic(cfg, amp)
    n = 200
    z = m.segment(m.init_state(v0), m.zero_source(), n)
    got = np.asarray(fft.inverse(z, cfg.grid_shape))
    ref = _rossby_analytic(cfg, amp, n * cfg.dt)
    # the wave must actually have MOVED (phase ~0.57 rad from the IC)
    assert np.max(np.abs(ref - v0)) > 0.25 * amp
    assert np.max(np.abs(got - ref)) < 1e-4 * amp


def test_rossby_wave_westward_only():
    """The phase moves against +x (omega/k1 < 0 for beta > 0): the signal
    at the IC's zero crossing grows with the sign of -d(zeta)/dx there."""
    cfg = ModelConfig(nx=64, ny=64, dt=3.0, beta=BETA, nu=0.0)
    m = BarotropicModel.build(cfg)
    v0 = _zonal_mode_ic(cfg)
    z = m.segment(m.init_state(v0), m.zero_source(), 100)
    got = np.asarray(fft.inverse(z, cfg.grid_shape))
    # at x=0 the IC is 0 with positive slope; westward motion makes the
    # value at x=0 positive (sin(k1*0 - omega*t) = sin(beta/k1 * t) > 0)
    assert got[0, 0] > 1e-5


def test_tracer_beta_flow_only():
    """Tracer family: beta enters the flow tendency as exactly -beta*v̂;
    the tracer equation is untouched at a fixed state."""
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
    d1 = tr.tendency(t, s, src, cfg.nu, 0.0, cfg.grid_shape, beta=BETA)
    psi_hat = sp.invert_laplacian(t, s.zeta_hat)
    v_hat = sp.gradx(t, psi_hat)
    v = fft.inverse(v_hat, cfg.grid_shape)
    ref = np.asarray(fft.forward(-BETA * v))
    got = np.asarray(d1.zeta_hat - d0.zeta_hat)
    scale = np.max(np.abs(np.asarray(d0.zeta_hat)))
    assert np.max(np.abs(got - ref)) < 1e-6 * scale
    np.testing.assert_array_equal(np.asarray(d1.q_hat),
                                  np.asarray(d0.q_hat))


def test_fd_core_discrete_rossby_dispersion():
    """FD/Arakawa core: the zonal mode follows the DISCRETE dispersion
    omega_FD = -beta * k_d / k_eff^2 with k_d = sin(k1 dx)/dx (centered
    difference) and k_eff^2 = (2 - 2cos(k1 dx))/dx^2 (5-point
    Laplacian)."""
    from xlab_fftbarotropic.models.fd_core import FDBarotropicModel
    cfg = ModelConfig(nx=64, ny=64, nu=0.0, dt=3.0, beta=BETA)
    m = FDBarotropicModel.build(cfg)
    amp = 1e-3
    v0 = jnp.asarray(_zonal_mode_ic(cfg, amp))
    psi0 = m.init_psi(v0)
    n = 200
    z, _ = m.segment(v0, psi0, m.zero_source(), n)
    k1 = 2 * np.pi / cfg.lx
    dx = cfg.dx
    k_d = np.sin(k1 * dx) / dx
    k_eff2 = (2.0 - 2.0 * np.cos(k1 * dx)) / (dx * dx)
    omega = -cfg.beta * k_d / k_eff2
    x, _ = cfg.coords()
    X = np.asarray(x, np.float64)[:, None]
    ref = (amp * np.sin(k1 * X - omega * n * cfg.dt)
           * np.ones((1, cfg.ny))).astype(np.float32)
    assert np.max(np.abs(np.asarray(z) - ref)) < 1e-4 * amp


def test_sharded_beta_matches_single_device():
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.parallel import (ShardedBarotropicModel,
                                                 make_mesh)
    cfg = ModelConfig(nx=64, ny=64, beta=BETA)
    mesh = make_mesh(jax.devices())
    v0 = makefields.kuo2004(cfg)
    m1 = BarotropicModel.build(cfg)
    z1 = m1.segment(m1.init_state(v0), m1.zero_source(), 5)
    ms = ShardedBarotropicModel.build(cfg, mesh)
    zs = ms.segment(ms.init_state(v0), ms.zero_source(), 5)
    a = np.asarray(fft.inverse(z1, cfg.grid_shape))
    b = np.asarray(fft.inverse(jnp.asarray(zs), cfg.grid_shape))
    assert np.max(np.abs(a - b)) < 1e-5 * max(1.0, np.max(np.abs(a)))


def test_adjoint_rollout_carries_beta():
    """The differentiable rollout must integrate the same beta dynamics:
    its final field matches the model segment, and the amplitude
    gradient of the advection-free mode is exp(-nu k1^2 T) (beta only
    rotates the phase; the projection onto the rotated analytic wave
    isolates the amplitude factor)."""
    from xlab_fftbarotropic.adjoint import make_rollout
    cfg = ModelConfig(nx=32, ny=32, dt=3.0, beta=BETA)
    n = 50
    roll = make_rollout(cfg, n)
    v0 = jnp.asarray(_zonal_mode_ic(cfg))
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    out = np.asarray(roll(v0, src))
    m = BarotropicModel.build(cfg)
    z = m.segment(m.init_state(v0), src, n)
    ref = np.asarray(fft.inverse(z, cfg.grid_shape))
    assert np.max(np.abs(out - ref)) < 1e-6 * max(1e-30, np.max(np.abs(ref)))

    w = jnp.asarray(_rossby_analytic(cfg, 1e-3, n * cfg.dt))

    def amp_out(a):
        return jnp.vdot(w, roll(a * v0, src)) / jnp.vdot(w, w)

    g = float(jax.grad(amp_out)(1.0))
    k1 = 2 * np.pi / cfg.lx
    assert abs(g - np.exp(-cfg.nu * k1 * k1 * n * cfg.dt)) < 1e-4


def test_sw_refuses_beta():
    from xlab_fftbarotropic.models.shallow_water import ShallowWaterModel
    cfg = ModelConfig(nx=32, ny=32, dt=0.1, beta=BETA)
    with pytest.raises(NotImplementedError):
        ShallowWaterModel.build(cfg)


def test_cli_flag_roundtrip():
    import argparse
    from xlab_fftbarotropic.config import (add_config_args,
                                               config_from_args)
    p = add_config_args(argparse.ArgumentParser())
    cfg = config_from_args(p.parse_args(["--beta", "1.6e-11"]))
    assert cfg.beta == 1.6e-11
    assert ModelConfig.from_json(cfg.to_json()).beta == 1.6e-11
    # default stays exactly zero => static f-plane branch
    assert config_from_args(p.parse_args([])).beta == 0.0
