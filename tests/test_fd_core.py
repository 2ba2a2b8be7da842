"""FD cross-check core tests: operator correctness against closed forms and
the convergence-to-spectral suite the reference only planned (TODO.md:13)."""

import jax.numpy as jnp
import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.models.barotropic import BarotropicModel
from xlab_fftbarotropic.models.fd_core import (
    FDBarotropicModel, arakawa_jacobian, laplacian5, poisson_fft,
    poisson_jacobi)


def wave(cfg, kx, ky):
    x, y = cfg.coords()
    return np.sin(2 * np.pi * kx * x / cfg.lx)[:, None] * \
        np.cos(2 * np.pi * ky * y[None, :] / cfg.ly)


def test_laplacian5_eigenfunction():
    cfg = ModelConfig(nx=128, ny=128)
    f = wave(cfg, 3, 2).astype(np.float32)
    got = np.asarray(laplacian5(jnp.asarray(f), cfg.dx, cfg.dy))
    k2 = (2 * np.pi * 3 / cfg.lx) ** 2 + (2 * np.pi * 2 / cfg.ly) ** 2
    # FD eigenvalue differs from -k^2 by O(k dx)^2
    np.testing.assert_allclose(got, -k2 * f, rtol=0,
                               atol=0.02 * k2 * np.abs(f).max())


def test_poisson_jacobi_inverts_laplacian():
    cfg = ModelConfig(nx=64, ny=64)
    psi_true = wave(cfg, 2, 1).astype(np.float32)
    rhs = laplacian5(jnp.asarray(psi_true), cfg.dx, cfg.dy)
    got = np.array(poisson_jacobi(rhs, cfg.dx, cfg.dy, tol=1e-6))
    got -= got.mean()
    ref = psi_true - psi_true.mean()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-4 * np.abs(ref).max())


def test_poisson_fft_exactly_inverts_laplacian5():
    rng = np.random.RandomState(3)
    cfg = ModelConfig(nx=64, ny=64)
    psi_true = rng.randn(64, 64).astype(np.float32)
    psi_true -= psi_true.mean()
    rhs = laplacian5(jnp.asarray(psi_true), cfg.dx, cfg.dy)
    got = np.array(poisson_fft(rhs, cfg.dx, cfg.dy))
    got -= got.mean()
    np.testing.assert_allclose(got, psi_true, rtol=0,
                               atol=1e-5 * np.abs(psi_true).max())


def test_jacobi_matches_fft_solver():
    cfg = ModelConfig(nx=32, ny=32)
    psi_true = wave(cfg, 2, 1).astype(np.float32)
    rhs = laplacian5(jnp.asarray(psi_true), cfg.dx, cfg.dy)
    a = np.array(poisson_fft(rhs, cfg.dx, cfg.dy))
    b = np.array(poisson_jacobi(rhs, cfg.dx, cfg.dy, tol=1e-6))
    a -= a.mean(); b -= b.mean()
    np.testing.assert_allclose(b, a, rtol=0, atol=5e-4 * np.abs(a).max())


def test_arakawa_jacobian_analytic():
    """J(sin kx, sin ly-type fields) vs exact z_x p_y - z_y p_x."""
    cfg = ModelConfig(nx=256, ny=256)
    x, y = cfg.coords()
    kx = 2 * np.pi * 2 / cfg.lx
    ky = 2 * np.pi * 3 / cfg.ly
    z = np.sin(kx * x)[:, None] * np.ones((1, cfg.ny))
    p = np.ones((cfg.nx, 1)) * np.sin(ky * y)[None, :]
    # exact: z_x p_y - z_y p_x = (kx cos kx x)(ky cos ky y)
    exact = (kx * np.cos(kx * x))[:, None] * (ky * np.cos(ky * y))[None, :]
    got = np.asarray(arakawa_jacobian(jnp.asarray(z, jnp.float32),
                                      jnp.asarray(p, jnp.float32),
                                      cfg.dx, cfg.dy))
    np.testing.assert_allclose(got, exact, rtol=0,
                               atol=5e-3 * np.abs(exact).max())


def test_arakawa_conserves_enstrophy_and_energy():
    """The discrete conservation property that motivates the scheme:
    sum(z * J(p, z)) = 0 and sum(p * J(p, z)) = 0."""
    rng = np.random.RandomState(7)
    cfg = ModelConfig(nx=64, ny=64)
    z = rng.randn(64, 64).astype(np.float32)
    p = rng.randn(64, 64).astype(np.float32)
    J = np.asarray(arakawa_jacobian(jnp.asarray(p), jnp.asarray(z),
                                    cfg.dx, cfg.dy), dtype=np.float64)
    scale = np.abs(J).max() * 64 * 64
    assert abs((z.astype(np.float64) * J).sum()) < 1e-5 * scale
    assert abs((p.astype(np.float64) * J).sum()) < 1e-5 * scale


def test_fd_converges_to_spectral():
    """Grid-refinement convergence of the FD core toward the spectral core
    on a smooth vortex — the reference's planned convergence suite."""
    errs = []
    for n in (32, 64, 128):
        cfg = ModelConfig(nx=n, ny=n, dt=3.0, nu=6.5)
        vort0 = makefields.gaussian(cfg)
        spec = BarotropicModel.build(cfg)
        fd = FDBarotropicModel.build(cfg)  # exact FFT FD inversion
        z_hat = spec.init_state(vort0)
        src = spec.zero_source()
        n_steps = 10
        z_hat = spec.segment(z_hat, src, n_steps)
        vort_spec = np.asarray(spec.diags(z_hat).vort)
        z_fd, _ = fd.segment(jnp.asarray(vort0), fd.init_psi(vort0),
                             src, n_steps)
        err = np.abs(np.asarray(z_fd) - vort_spec).max() / \
            np.abs(vort_spec).max()
        errs.append(err)
    # roughly 2nd order: each doubling should cut the error ~4x; accept >2.5x
    assert errs[1] < errs[0] / 2.5, errs
    assert errs[2] < errs[1] / 2.5, errs
    assert errs[-1] < 5e-3, errs
