"""Initial-condition generators.

Equivalents of the reference's makefield-* binaries
(/root/reference/src/makefield-{gaussian,const-vortex,elliptic-vortex,
Kuo2004}.cpp) and the cake-profile library (field_generator.cpp). Each
generator is a vectorized pure function (nx, ny) -> float32 grid; the
reference's per-point double loops become broadcast numpy/jnp expressions.

Coordinates follow the reference: x = i*dx along the slow axis, y = j*dy
along the contiguous axis, periodic without endpoint duplication
(makefield-gaussian.cpp:25-29, configuration.hpp:31).
"""

from __future__ import annotations

import numpy as np

from ..config import ModelConfig


def _grid_xy(cfg: ModelConfig):
    x, y = cfg.coords()
    # float64 internally for profile evaluation; cast to f32 at the end —
    # the reference computes in float via pow/exp promoted to double
    # (field_generator.cpp:10-28), so this matches its rounding closely.
    return (x.astype(np.float64)[:, None], y.astype(np.float64)[None, :])


def cake_kuo2004(cfg: ModelConfig, cx: float, cy: float,
                 zeta0: float, scale_r: float) -> np.ndarray:
    """Smooth compact 'cake' vortex profile (field_generator.cpp:10-28):

        zeta(r) = zeta0 * (1 - exp(-(30/rh) * exp(1/(rh-1))))  for rh=r/R < 1
        zeta(r) = 0 otherwise.

    The reference's loop swaps i/j roles (field_generator.cpp:14-18), which is
    only benign because its grids are square; here the profile is evaluated
    with x on axis 0 / y on axis 1 unconditionally, and a test pins the
    square-grid equivalence.
    """
    X, Y = _grid_xy(cfg)
    r = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2) / scale_r
    inside = r < 1.0
    rs = np.where(inside, r, 0.5)  # dummy value avoids div-by-zero outside
    with np.errstate(divide="ignore", over="ignore"):
        prof = zeta0 * (1.0 - np.exp(-30.0 / np.maximum(rs, 1e-300)
                                     * np.exp(1.0 / (rs - 1.0))))
    return np.where(inside, prof, 0.0).astype(np.float32)


def gaussian(cfg: ModelConfig, zeta0: float = 1e-3,
             radius: float = 60_000.0) -> np.ndarray:
    """Gaussian vortex at the domain center (makefield-gaussian.cpp:14-33):
    zeta = zeta0 * exp(-(r/60 km)^2)."""
    X, Y = _grid_xy(cfg)
    cx, cy = cfg.lx / 2.0, cfg.ly / 2.0
    r2 = (X - cx) ** 2 + (Y - cy) ** 2
    return (zeta0 * np.exp(-r2 / radius**2)).astype(np.float32)


def const_vortex(cfg: ModelConfig, zeta0: float = 2e-5,
                 r_bound: float = 6_000.0) -> np.ndarray:
    """Rankine-like constant-core vortex (makefield-const-vortex.cpp:14-37):
    zeta = zeta0 for r <= 6 km, else 0."""
    X, Y = _grid_xy(cfg)
    cx, cy = cfg.lx / 2.0, cfg.ly / 2.0
    r = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2)
    return np.where(r <= r_bound, zeta0, 0.0).astype(np.float32)


def elliptic_vortex(cfg: ModelConfig, zeta0: float = 5e-3, epsilon: float = 0.7,
                    lam: float = 2.0, r_i: float = 30_000.0,
                    r_o: float = 60_000.0) -> np.ndarray:
    """Elliptical vortex with smooth cake-taper edge
    (makefield-elliptic-vortex.cpp:14-51). Angular stretch
    alpha = sqrt((1-eps^2)/(1-(eps*c)^2)) with c = (y-cy)/r (c=0 at r=0);
    core zeta0 inside r_i*alpha, taper to r_o*alpha, zero beyond."""
    X, Y = _grid_xy(cfg)
    cx, cy = cfg.lx / 2.0, cfg.ly / 2.0
    r = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2)
    c = np.where(r == 0.0, 0.0, (Y - cy) / np.where(r == 0.0, 1.0, r))
    alpha = np.sqrt((1.0 - epsilon**2) / (1.0 - (epsilon * c) ** 2))
    ria, roa = r_i * alpha, r_o * alpha
    rp = (r - ria) / (roa - ria)
    with np.errstate(divide="ignore", over="ignore"):
        rp_safe = np.clip(rp, 1e-12, 1.0 - 1e-12)
        taper = zeta0 * (1.0 - np.exp(-lam / rp_safe * np.exp(1.0 / (rp_safe - 1.0))))
    out = np.where(r <= ria, zeta0, np.where(r <= roa, taper, 0.0))
    return out.astype(np.float32)


def kuo2004(cfg: ModelConfig) -> np.ndarray:
    """Binary-vortex merger IC (makefield-Kuo2004.cpp:34-38): intense small
    cake (zeta=1.5e-2, R=10 km) at center + weak large cake (zeta=3e-3,
    R=30 km) offset +50 km in x."""
    cx, cy = cfg.lx / 2.0, cfg.ly / 2.0
    return (cake_kuo2004(cfg, cx, cy, 1.5e-2, 10_000.0)
            + cake_kuo2004(cfg, cx + 50_000.0, cy, 3e-3, 30_000.0)).astype(np.float32)


GENERATORS = {
    "gaussian": gaussian,
    "const-vortex": const_vortex,
    "elliptic-vortex": elliptic_vortex,
    "kuo2004": kuo2004,
}


def make(name: str, cfg: ModelConfig, **kw) -> np.ndarray:
    try:
        return GENERATORS[name](cfg, **kw)
    except KeyError:
        raise ValueError(f"unknown IC {name!r}; have {sorted(GENERATORS)}")
