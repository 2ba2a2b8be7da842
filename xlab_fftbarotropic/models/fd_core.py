"""Finite-difference barotropic core — the cross-check path.

Capability of the reference's main-jacobian.cpp (C16 in SURVEY.md §2),
which does not build there (missing external `xdmlab` header,
main-jacobian.cpp:4) — so this is the capability re-designed, not ported:
an Arakawa-Jacobian advection core with an iterative Jacobi Poisson solver
and RK4, used as an independent numerical path to cross-validate the
spectral core (and testable entirely on CPU).

Differences by design from the reference variant:
  * periodic BCs via jnp.roll (the reference clamps edges and zeroes a
    boundary ring, main-jacobian.cpp:96-98,172-198) so the FD core solves
    the SAME problem as the spectral core and the two converge to each
    other under grid refinement — the convergence test suite the reference
    only planned (TODO.md:13);
  * the Jacobi relaxation (main-jacobian.cpp:137-170) runs as a
    lax.while_loop of full-grid vectorized sweeps — compiler-friendly
    bounded iteration with the reference's relative-residual stopping rule;
  * everything is a pure function of the state; rolls lower to cheap
    slices.

Numerics:
  * Arakawa (1966) 9-point Jacobian J(zeta, psi) / (12 dx dy) — the energy-
    and enstrophy-conserving J1+J2+J3 average the reference implements at
    main-jacobian.cpp:218-243.
  * 5-point Laplacian (main-jacobian.cpp:172-198, periodic here).
  * d zeta/dt = -J(psi, zeta) + nu lap(zeta) + S; u = -psi_y, v = psi_x.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import ModelConfig


def _roll(a, dx_, dy_):
    return jnp.roll(a, shift=(dx_, dy_), axis=(0, 1))


def laplacian5(a: jax.Array, dx: float, dy: float) -> jax.Array:
    """Periodic 5-point Laplacian."""
    return ((_roll(a, 1, 0) + _roll(a, -1, 0) - 2.0 * a) / (dx * dx)
            + (_roll(a, 0, 1) + _roll(a, 0, -1) - 2.0 * a) / (dy * dy))


def arakawa_jacobian(z: jax.Array, p: jax.Array,
                     dx: float, dy: float) -> jax.Array:
    """Arakawa's conserving J(z, p) = z_x p_y - z_y p_x discretization.

    The (J1+J2+J3)/3 form over the 9-point stencil, equal to the reference's
    expanded expression divided by 12 dx dy (main-jacobian.cpp:218-243,
    272-273).
    """
    zp1 = _roll(z, -1, 0)   # z[i+1, j]
    zm1 = _roll(z, 1, 0)    # z[i-1, j]
    zq1 = _roll(z, 0, -1)   # z[i, j+1]
    zr1 = _roll(z, 0, 1)    # z[i, j-1]
    zpq = _roll(z, -1, -1)  # z[i+1, j+1]
    zpr = _roll(z, -1, 1)   # z[i+1, j-1]
    zmq = _roll(z, 1, -1)   # z[i-1, j+1]
    zmr = _roll(z, 1, 1)    # z[i-1, j-1]
    pp1 = _roll(p, -1, 0)
    pm1 = _roll(p, 1, 0)
    pq1 = _roll(p, 0, -1)
    pr1 = _roll(p, 0, 1)
    ppq = _roll(p, -1, -1)
    ppr = _roll(p, -1, 1)
    pmq = _roll(p, 1, -1)
    pmr = _roll(p, 1, 1)

    j1 = ((zp1 - zm1) * (pq1 - pr1) - (zq1 - zr1) * (pp1 - pm1))
    j2 = (zp1 * (ppq - ppr) - zm1 * (pmq - pmr)
          - zq1 * (ppq - pmq) + zr1 * (ppr - pmr))
    j3 = (zpq * (pq1 - pp1) - zmr * (pm1 - pr1)
          - zmq * (pq1 - pm1) + zpr * (pp1 - pr1))
    return (j1 + j2 + j3) / (12.0 * dx * dy)


def poisson_jacobi(rhs: jax.Array, dx: float, dy: float,
                   tol: float = 1e-6, max_iter: int = 10_000,
                   x0: Optional[jax.Array] = None) -> jax.Array:
    """Solve lap(x) = rhs (periodic) by Jacobi relaxation.

    The reference's jacobi_relaxation with its relative-residual stopping
    strategy (main-jacobian.cpp:137-170), as a lax.while_loop of fully
    vectorized sweeps. The periodic problem requires mean(rhs)=0; the mean
    is removed and the solution returned with zero mean (the spectral
    invertLaplacian similarly passes the mean through untouched).
    """
    rhs = rhs - jnp.mean(rhs)
    cx, cy = 1.0 / (dx * dx), 1.0 / (dy * dy)
    denom = 2.0 * (cx + cy)
    rhs_norm = jnp.maximum(jnp.sqrt(jnp.mean(rhs * rhs)), 1e-30)
    x_init = jnp.zeros_like(rhs) if x0 is None else x0 - jnp.mean(x0)

    def residual(x):
        return laplacian5(x, dx, dy) - rhs

    def cond(carry):
        x, it, res = carry
        return jnp.logical_and(it < max_iter, res > tol)

    def body(carry):
        x, it, _ = carry
        nbr = (cx * (_roll(x, 1, 0) + _roll(x, -1, 0))
               + cy * (_roll(x, 0, 1) + _roll(x, 0, -1)))
        x = (nbr - rhs) / denom
        x = x - jnp.mean(x)
        r = residual(x)
        res = jnp.sqrt(jnp.mean(r * r)) / rhs_norm
        return x, it + 1, res

    x, _, _ = jax.lax.while_loop(
        cond, body, (x_init, jnp.int32(0), jnp.float32(jnp.inf)))
    return x


def poisson_fft(rhs: jax.Array, dx: float, dy: float) -> jax.Array:
    """EXACT inverse of the periodic 5-point Laplacian via FFT.

    The 5-point stencil is diagonalized by the DFT with eigenvalues
    -4 sin^2(pi i / nx)/dx^2 - 4 sin^2(pi j / ny)/dy^2, so one rfft2 /
    irfft2 pair inverts laplacian5 to round-off — the default
    for the FD core (Jacobi remains as the reference-parity iterative
    path, main-jacobian.cpp:137-170). Mean mode passes through as zero.
    """
    nx, ny = rhs.shape
    i = jnp.arange(nx)
    j = jnp.arange(ny // 2 + 1)
    lam = (-4.0 * jnp.sin(jnp.pi * i / nx) ** 2 / (dx * dx))[:, None] \
        + (-4.0 * jnp.sin(jnp.pi * j / ny) ** 2 / (dy * dy))[None, :]
    lam = lam.at[0, 0].set(1.0)
    rhs_hat = jnp.fft.rfft2(rhs)
    x_hat = rhs_hat / lam
    x_hat = x_hat.at[0, 0].set(0.0)
    return jnp.fft.irfft2(x_hat, s=(nx, ny)).astype(rhs.dtype)


def gradients(psi: jax.Array, dx: float, dy: float):
    """Centered first derivatives; u = -psi_y, v = +psi_x."""
    psi_x = (_roll(psi, -1, 0) - _roll(psi, 1, 0)) / (2.0 * dx)
    psi_y = (_roll(psi, 0, -1) - _roll(psi, 0, 1)) / (2.0 * dy)
    return -psi_y, psi_x


@dataclasses.dataclass(frozen=True)
class FDBarotropicModel:
    """RK4 FD stepper: state is PHYSICAL vorticity (nx, ny) float32.

    Each tendency solves Poisson iteratively (warm-started from the carried
    psi), forms the Arakawa Jacobian, and adds 5-point viscosity — the
    structure of main-jacobian.cpp's evolution (:248-279) with periodic BCs.
    """

    cfg: ModelConfig
    step: Callable
    segment: Callable
    tol: float
    solver: str

    @classmethod
    def build(cls, cfg: ModelConfig, tol: float = 1e-6,
              max_iter: int = 10_000,
              solver: str = "fft") -> "FDBarotropicModel":
        """solver='fft' (default): exact FD inversion via poisson_fft.
        solver='jacobi': the reference-parity iterative relaxation."""
        dx, dy = float(cfg.dx), float(cfg.dy)
        dt, nu = float(cfg.dt), float(cfg.nu)
        r_drag = float(cfg.r_drag)
        beta = float(cfg.beta)
        nu4 = float(cfg.nu4)
        if solver == "fft":
            def solve(rhs_z, guess):
                return poisson_fft(rhs_z, dx, dy)
        elif solver == "jacobi":
            def solve(rhs_z, guess):
                return poisson_jacobi(rhs_z, dx, dy, tol, max_iter, guess)
        else:
            raise ValueError(f"unknown solver {solver!r}")

        def rhs(zeta, psi):
            out = -arakawa_jacobian(psi, zeta, dx, dy) \
                + nu * laplacian5(zeta, dx, dy)
            if r_drag != 0.0:
                # boundary-layer feedback, same linear spin-down as the
                # spectral cores (models/barotropic.py:tendency)
                out = out - r_drag * zeta
            if beta != 0.0:
                # beta-plane: -beta*v with v = psi_x, centered FD (same
                # term the spectral cores fold into the advection
                # product, models/barotropic.py:tendency)
                v = (jnp.roll(psi, -1, axis=0) - jnp.roll(psi, 1, axis=0)
                     ) / (2.0 * dx)
                out = out - beta * v
            if nu4 != 0.0:
                # biharmonic hyperviscosity: the iterated 5-point
                # Laplacian (config.py nu4 note)
                out = out - nu4 * laplacian5(laplacian5(zeta, dx, dy),
                                             dx, dy)
            return out

        def rk4(zeta, psi_guess, src):
            psi1 = solve(zeta, psi_guess)
            k1 = rhs(zeta, psi1) + src
            z = zeta + k1 * (dt * 0.5)
            psi2 = solve(z, psi1)
            k2 = rhs(z, psi2) + src
            z = zeta + k2 * (dt * 0.5)
            psi3 = solve(z, psi2)
            k3 = rhs(z, psi3) + src
            z = zeta + k3 * dt
            psi4 = solve(z, psi3)
            k4 = rhs(z, psi4) + src
            z_new = zeta + (k1 + 2 * k2 + 2 * k3 + k4) * (dt / 6.0)
            return z_new, psi4

        @jax.jit
        def step(zeta, psi_guess, src):
            return rk4(zeta, psi_guess, src)

        @functools.partial(jax.jit, static_argnames=("n_steps",))
        def segment(zeta, psi_guess, src, n_steps: int):
            def body(carry, _):
                z, p = carry
                return rk4(z, p, src), None
            (z, p), _ = jax.lax.scan(body, (zeta, psi_guess), None,
                                     length=n_steps)
            return z, p

        return cls(cfg=cfg, step=step, segment=segment, tol=tol,
                   solver=solver)

    def init_psi(self, zeta) -> jax.Array:
        return jnp.zeros_like(jnp.asarray(zeta, jnp.float32))

    def zero_source(self) -> jax.Array:
        return jnp.zeros(self.cfg.grid_shape, jnp.float32)

    @staticmethod
    def note_arakawa_jacobian(z, p, dx, dy):
        return arakawa_jacobian(z, p, dx, dy)
