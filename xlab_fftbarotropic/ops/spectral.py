"""Spectral operator library.

Re-design of the reference's fftwf_operation template class
(/root/reference/src/fftwfop.{hpp,cpp}). The reference precomputes float*
coefficient tables at construction and loops over the half-spectrum applying
them pointwise; here the tables live in a pytree-registered dataclass of
device arrays and every operator is a pure function of (tables, array) —
a single fused elementwise multiply under jit, sharded transparently by
whatever NamedSharding the caller put on the spectral array.

Exact numerics contract reproduced (see SURVEY.md §5.3-5.6):

* gradx coefficients (fftwfop.cpp:14-19): k_x[i] = 2*pi*i/Lx for i in
  [0, nx/2] **inclusive** — the x-Nyquist mode keeps a POSITIVE coefficient —
  and k_x[i] = -k_x[nx-i] for i > nx/2.
* grady coefficients (fftwfop.cpp:22-24): k_y[j] = 2*pi*j/Ly for the r2c half
  axis j in [0, ny/2]; the y-Nyquist is also positive.
* d/dx is multiplication by (i * k_x): (re,im) -> (-im*k, re*k)
  (fftwfop.cpp:87-94); complex64 arithmetic expresses this directly.
* laplacian coefficient -(k_x^2 + k_y^2) (fftwfop.cpp:39-54); the inverse
  table is identical except entry (0,0) is 1.0 so invertLaplacian passes the
  mean mode through unchanged (fftwfop.cpp:43,112-117).
* dealiasing mask (fftwfop.cpp:56-68): with kc = ceil(N/3) per axis, zero the
  modes with i'^2 + j^2 >= kc_x^2 + kc_y^2 where i' is the reflected x index
  min(i, nx-i) — a CIRCULAR mask of radius sqrt(2)*kc on square grids, NOT
  the textbook tensor-product 2/3 rule. The textbook rule is available as
  dealias_rule='twothirds'.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def wavenumbers_x(nx: int, lx: float) -> np.ndarray:
    """Full-axis x wavenumbers with positive Nyquist (fftwfop.cpp:14-19)."""
    k = np.empty(nx, dtype=np.float64)
    half = nx // 2 + 1
    k[:half] = 2.0 * np.pi * np.arange(half) / lx
    for i in range(half, nx):
        k[i] = -k[nx - i]
    return k.astype(np.float32)


def wavenumbers_y(ny: int, ly: float) -> np.ndarray:
    """Half-axis y wavenumbers, all positive (fftwfop.cpp:22-24)."""
    half = ny // 2 + 1
    return (2.0 * np.pi * np.arange(half) / ly).astype(np.float32)


def dealias_mask(nx: int, ny: int, rule: str = "circular") -> np.ndarray:
    """Dealiasing mask over the half-spectrum (fftwfop.cpp:56-68).

    'circular' replicates the reference: kc = ceil(N/3) per axis and the
    kill region is i'^2 + j^2 >= kc_x^2 + kc_y^2 (i' reflected). 'twothirds'
    is the standard tensor-product rule i' >= kc_x or j >= kc_y.
    """
    kcx = int(np.ceil(nx / 3.0))
    kcy = int(np.ceil(ny / 3.0))
    half_ny = ny // 2 + 1
    i = np.arange(nx)
    i_refl = np.minimum(i, nx - i)  # reflected index; i=0 maps to 0
    j = np.arange(half_ny)
    ii = i_refl[:, None].astype(np.float64)
    jj = j[None, :].astype(np.float64)
    if rule == "circular":
        kill = (ii**2 + jj**2) >= (float(kcx) ** 2 + float(kcy) ** 2)
    elif rule == "twothirds":
        kill = (ii >= kcx) | (jj >= kcy)
    else:
        raise ValueError(f"unknown dealias rule: {rule!r}")
    return np.where(kill, 0.0, 1.0).astype(np.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpectralTables:
    """Precomputed coefficient tables (the ctor of fftwfop.cpp:5-79).

    All float32 device arrays shaped for the half-spectrum (nx, ny//2+1),
    except the 1-D wavenumber axes. Registered as a pytree so it passes
    through jit/shard_map as data.
    """

    kx: jax.Array          # (nx,)   signed x wavenumbers, +Nyquist
    ky: jax.Array          # (hny,)  y wavenumbers (half axis)
    lap: jax.Array         # (nx, hny) -(kx^2+ky^2)
    inv_lap: jax.Array     # (nx, hny) same but (0,0) entry = 1.0
    mask: jax.Array        # (nx, hny) dealias mask
    rlap: jax.Array        # (nx, hny) 1/inv_lap — multiply-form Laplacian
    #                        inversion (spectra diagnostics)

    @classmethod
    def build(cls, nx: int, ny: int, lx: float, ly: float,
              rule: str = "circular") -> "SpectralTables":
        kx = wavenumbers_x(nx, lx)
        ky = wavenumbers_y(ny, ly)
        lap = -(kx[:, None].astype(np.float64) ** 2
                + ky[None, :].astype(np.float64) ** 2)
        lap = lap.astype(np.float32)
        inv = lap.copy()
        inv[0, 0] = 1.0
        # float32 reciprocal of the float32 divisor: x * rlap matches
        # x / inv_lap to <= 1 ulp of the quotient at these magnitudes
        rlap = (1.0 / inv).astype(np.float32)
        return cls(
            kx=jnp.asarray(kx),
            ky=jnp.asarray(ky),
            lap=jnp.asarray(lap),
            inv_lap=jnp.asarray(inv),
            mask=jnp.asarray(dealias_mask(nx, ny, rule)),
            rlap=jnp.asarray(rlap),
        )

    @classmethod
    def from_config(cls, cfg) -> "SpectralTables":
        return cls.build(cfg.nx, cfg.ny, cfg.lx, cfg.ly, cfg.dealias_rule)


# ---- operators: pure pointwise functions on the half-spectrum ----
# Each is one fused elementwise VPU op under jit; XLA fuses chains of these
# into neighbouring FFT prologues/epilogues.

def gradx(t: SpectralTables, a: jax.Array) -> jax.Array:
    """d/dx: multiply by i*k_x (fftwfop.cpp:87-94)."""
    return a * (1j * t.kx)[:, None]


def grady(t: SpectralTables, a: jax.Array) -> jax.Array:
    """d/dy: multiply by i*k_y (fftwfop.cpp:96-103)."""
    return a * (1j * t.ky)[None, :]


def laplacian(t: SpectralTables, a: jax.Array) -> jax.Array:
    """nabla^2: multiply by -(k^2) (fftwfop.cpp:105-110)."""
    return a * t.lap


def invert_laplacian(t: SpectralTables, a: jax.Array) -> jax.Array:
    """nabla^{-2}: divide by -(k^2); mean mode passes through unchanged
    because inv_lap[0,0] == 1.0 (fftwfop.cpp:43,112-117)."""
    return a / t.inv_lap


def dealias(t: SpectralTables, a: jax.Array) -> jax.Array:
    """Apply the dealias mask (fftwfop.cpp:119-124)."""
    return a * t.mask


def velocities(t: SpectralTables, psi_hat: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """u = -dpsi/dy, v = +dpsi/dx in spectral space (main.cpp:198-214)."""
    return -grady(t, psi_hat), gradx(t, psi_hat)
