"""Nonlinear-balance pressure inversion.

Equivalent of invert_pres.out (/root/reference/src/
invert_pres.cpp:132-187): from a streamfunction field psi, solve

    lap(p) = rho * ( f * lap(psi) + 2 * (psi_xx * psi_yy - psi_xy^2) )

spectrally, with dealiasing of the three quadratic ingredients
(invert_pres.cpp:148-150), inverting with the mean-preserving Laplacian
inverse, and anchoring by subtracting the value at a reference grid point.

The reference anchors at flat index ref_x + XPTS*ref_y
(invert_pres.cpp:182-185) — note this is INCONSISTENT with its own
IDX(i,j)=YPTS*i+j convention (SURVEY.md §5.8); with the default (0,0) it
doesn't matter. We replicate the reference's formula for parity.

Where the reference re-plans 6 FFTW transforms and loops files through
stdin one at a time, this is a single jitted pure function, vmappable over
batches of psi fields for high-throughput postprocessing on the device.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..ops import fft
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables


def invert_pressure(t: SpectralTables, psi: jax.Array, rho: float, f: float,
                    grid_shape, ref_x: int = 0, ref_y: int = 0) -> jax.Array:
    """psi (nx, ny) float32 -> pressure anomaly (nx, ny) float32."""
    psi_hat = fft.forward(psi)                       # invert_pres.cpp:135
    gx = sp.gradx(t, psi_hat)
    gy = sp.grady(t, psi_hat)
    psi_xx_hat = sp.gradx(t, gx)                     # invert_pres.cpp:139-140
    psi_yy_hat = sp.grady(t, gy)                     # invert_pres.cpp:142-143
    psi_xy_hat = sp.gradx(t, gy)                     # invert_pres.cpp:145
    psi_xx = fft.inverse(sp.dealias(t, psi_xx_hat), grid_shape)
    psi_yy = fft.inverse(sp.dealias(t, psi_yy_hat), grid_shape)
    psi_xy = fft.inverse(sp.dealias(t, psi_xy_hat), grid_shape)
    gaus_curv = psi_xx * psi_yy - psi_xy * psi_xy    # invert_pres.cpp:159
    lap_pres_hat = fft.forward(gaus_curv)            # invert_pres.cpp:161
    lap_pres_hat = rho * (f * sp.laplacian(t, psi_hat)
                          + 2.0 * lap_pres_hat)      # invert_pres.cpp:164-169
    pres = fft.inverse(sp.invert_laplacian(t, lap_pres_hat), grid_shape)
    # reference anchor: flat index ref_x + nx*ref_y (invert_pres.cpp:182-185)
    nx = grid_shape[0]
    flat = ref_x + nx * ref_y
    ref_val = pres.reshape(-1)[flat]
    return pres - ref_val


class PressureInverter:
    """Compiled inverter for a fixed configuration; batch-friendly."""

    def __init__(self, cfg: ModelConfig, ref_x: int = 0, ref_y: int = 0,
                 tables: Optional[SpectralTables] = None):
        self.cfg = cfg
        t = tables if tables is not None else SpectralTables.from_config(cfg)
        self.tables = t
        self._fn = jax.jit(functools.partial(
            invert_pressure, t, rho=float(cfg.rho), f=float(cfg.f),
            grid_shape=cfg.grid_shape, ref_x=ref_x, ref_y=ref_y))
        # vmapped batch path: (B, nx, ny) -> (B, nx, ny)
        self._batch_fn = jax.jit(jax.vmap(functools.partial(
            invert_pressure, t, rho=float(cfg.rho), f=float(cfg.f),
            grid_shape=cfg.grid_shape, ref_x=ref_x, ref_y=ref_y)))

    def __call__(self, psi):
        return self._fn(jnp.asarray(psi, jnp.float32))

    def batch(self, psis):
        return self._batch_fn(jnp.asarray(psis, jnp.float32))
