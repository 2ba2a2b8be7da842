"""Biharmonic hyperviscosity (-nu4*lap^2) — scale-selective dissipation
(new capability; the reference has only the plain Laplacian nu,
configuration.hpp:17).

Anchors mirror tests/test_drag.py: a single Fourier mode self-advects to
zero, so its exact trajectory is zeta0 * exp(-(nu k^2 + nu4 k^4 + r) t);
SW applies it to zeta AND div (mass
untouched); tracer flow only; sharded/adjoint thread the coefficient.
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

# RK4 stability bounds nu4 by the GRID-scale rate: nu4*k_max^4*dt <~
# 2.8, i.e. nu4 <~ 8e13 at 64^2 (k_max ~ 3.3e-4 within the dealias
# circle) and ~6e12 at 128^2 — the k^4 growth is exactly why
# hyperviscosity is scale-selective. Tests therefore use a HIGHER test
# mode (m=4) so the decay is well above float32 tolerance while the
# grid scale stays stable.
NU4 = 2e13          # 64^2-stable
NU4_128 = 2e12      # 128^2-stable (parity test only)
M = 4               # test mode index


def _single_mode_ic(cfg: ModelConfig, amp: float = 1e-3,
                    m: int = M) -> np.ndarray:
    x, _ = cfg.coords()
    X = np.asarray(x)[:, None]
    return (amp * np.sin(2 * np.pi * m * X / cfg.lx)
            * np.ones((1, cfg.ny))).astype(np.float32)


def test_single_mode_analytic_decay():
    cfg = ModelConfig(nx=64, ny=64, dt=3.0, nu4=NU4, r_drag=1e-3)
    m = BarotropicModel.build(cfg)
    v0 = _single_mode_ic(cfg)
    n = 100
    z = m.segment(m.init_state(v0), m.zero_source(), n)
    got = np.asarray(fft.inverse(z, cfg.grid_shape))
    k1 = 2 * np.pi * M / cfg.lx
    lam = cfg.nu * k1 ** 2 + NU4 * k1 ** 4 + cfg.r_drag
    # the nu4 share of the decay must itself be resolvable
    assert NU4 * k1 ** 4 * n * cfg.dt > 1e-3
    ref = v0 * np.exp(-lam * n * cfg.dt)
    assert np.max(np.abs(got - ref)) < 1e-5 * np.max(np.abs(v0))


def test_sw_nu4_tendency_exact():
    """SW: nu4 adds exactly (-nu4 lap^2 zeta, -nu4 lap^2 div, 0)."""
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
    d1 = sw.tendency(*args, nu4=NU4)
    l2 = np.asarray(t.lap) ** 2
    np.testing.assert_allclose(np.asarray(d1.zeta_hat - d0.zeta_hat),
                               np.asarray(-NU4 * l2 * s.zeta_hat),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(d1.div_hat - d0.div_hat),
                               np.asarray(-NU4 * l2 * s.div_hat),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(d1.eta_hat),
                                  np.asarray(d0.eta_hat))


def test_tracer_nu4_flow_only():
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
    d1 = tr.tendency(t, s, src, cfg.nu, 0.0, cfg.grid_shape, nu4=NU4)
    l2 = np.asarray(t.lap) ** 2
    np.testing.assert_allclose(np.asarray(d1.zeta_hat - d0.zeta_hat),
                               np.asarray(-NU4 * l2 * s.zeta_hat),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(d1.q_hat),
                                  np.asarray(d0.q_hat))


def test_fd_core_nu4_decay():
    """FD core: with nu=0 the zonal mode decays at the DISCRETE rate
    nu4 * k_eff^4 (iterated 5-point Laplacian)."""
    from xlab_fftbarotropic.models.fd_core import FDBarotropicModel
    cfg = ModelConfig(nx=32, ny=32, nu=0.0, dt=3.0, nu4=NU4)
    m = FDBarotropicModel.build(cfg)
    v0 = jnp.asarray(_single_mode_ic(cfg, amp=1.0))
    psi0 = m.init_psi(v0)
    n = 50
    z, _ = m.segment(v0, psi0, m.zero_source(), n)
    k1 = 2 * np.pi * M / cfg.lx
    dx = cfg.dx
    k_eff2 = (2.0 - 2.0 * np.cos(k1 * dx)) / (dx * dx)
    assert NU4 * k_eff2 ** 2 * n * cfg.dt > 1e-3
    ref = np.asarray(v0) * np.exp(-NU4 * k_eff2 ** 2 * n * cfg.dt)
    assert np.max(np.abs(np.asarray(z) - ref)) < 1e-5


def test_sharded_nu4_matches_single_device():
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.parallel import (ShardedBarotropicModel,
                                                 make_mesh)
    cfg = ModelConfig(nx=64, ny=64, nu4=NU4)
    mesh = make_mesh(jax.devices())
    v0 = makefields.kuo2004(cfg)
    m1 = BarotropicModel.build(cfg)
    z1 = m1.segment(m1.init_state(v0), m1.zero_source(), 5)
    ms = ShardedBarotropicModel.build(cfg, mesh)
    zs = ms.segment(ms.init_state(v0), ms.zero_source(), 5)
    a = np.asarray(fft.inverse(z1, cfg.grid_shape))
    b = np.asarray(fft.inverse(jnp.asarray(zs), cfg.grid_shape))
    assert np.max(np.abs(a - b)) < 1e-5 * max(1.0, np.max(np.abs(a)))


def test_adjoint_gradient_carries_nu4():
    from xlab_fftbarotropic.adjoint import make_rollout
    cfg = ModelConfig(nx=32, ny=32, dt=3.0, nu4=NU4)
    n = 20
    roll = make_rollout(cfg, n)
    v0 = jnp.asarray(_single_mode_ic(cfg))
    src = jnp.zeros(cfg.grid_shape, jnp.float32)

    def amp_out(a):
        return jnp.vdot(v0, roll(a * v0, src)) / jnp.vdot(v0, v0)

    g = float(jax.grad(amp_out)(1.0))
    k1 = 2 * np.pi * M / cfg.lx
    lam = cfg.nu * k1 ** 2 + NU4 * k1 ** 4
    assert NU4 * k1 ** 4 * n * cfg.dt > 1e-3
    assert abs(g - np.exp(-lam * n * cfg.dt)) < 1e-5


def test_cli_flag_roundtrip():
    import argparse
    from xlab_fftbarotropic.config import (add_config_args,
                                               config_from_args)
    p = add_config_args(argparse.ArgumentParser())
    cfg = config_from_args(p.parse_args(["--nu4", "1e15"]))
    assert cfg.nu4 == 1e15
    assert ModelConfig.from_json(cfg.to_json()).nu4 == 1e15
    assert config_from_args(p.parse_args([])).nu4 == 0.0
