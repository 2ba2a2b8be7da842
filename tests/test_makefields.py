"""Initial-condition generators pinned against the reference formulas.

Each test evaluates the closed-form expression from the cited makefield
source directly in float64 numpy and compares the generator output
(C10-C13 + the cake profile C9, SURVEY.md §2).
"""

import numpy as np

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields


CFG = ModelConfig(nx=96, ny=96)


def _grid(cfg):
    x, y = cfg.coords()
    return x[:, None].astype(np.float64), y[None, :].astype(np.float64)


def test_gaussian_formula():
    """zeta = 1e-3 * exp(-(r/60km)^2) at domain center
    (makefield-gaussian.cpp:14,26-31)."""
    x, y = _grid(CFG)
    r2 = (x - CFG.lx / 2) ** 2 + (y - CFG.ly / 2) ** 2
    want = 1e-3 * np.exp(-r2 / 60_000.0 ** 2)
    got = makefields.gaussian(CFG)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_const_vortex_formula():
    """zeta = 2e-5 inside r <= 6 km else 0
    (makefield-const-vortex.cpp:14,31-36)."""
    x, y = _grid(CFG)
    r = np.sqrt((x - CFG.lx / 2) ** 2 + (y - CFG.ly / 2) ** 2)
    want = np.where(r <= 6_000.0, 2e-5, 0.0)
    got = makefields.const_vortex(CFG)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_cake_profile_formula():
    """zeta += zeta0*(1 - exp(-(30/rhat)*exp(1/(rhat-1)))) for rhat<1
    (field_generator.cpp:10-28)."""
    x, y = _grid(CFG)
    cx, cy, R = CFG.lx / 2, CFG.ly / 2, 30_000.0
    rhat = np.sqrt((x - cx) ** 2 + (y - cy) ** 2) / R
    with np.errstate(divide="ignore", over="ignore"):
        inner = np.where(
            (rhat < 1) & (rhat > 0),
            1.0 - np.exp(-(30.0 / np.where(rhat > 0, rhat, 1.0))
                         * np.exp(1.0 / np.where(rhat < 1, rhat - 1.0, -1.0))),
            np.where(rhat == 0, 1.0, 0.0))
    want = 5e-3 * inner
    got = makefields.cake_kuo2004(CFG, cx, cy, 5e-3, R)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_kuo2004_is_two_cakes():
    """Center (1.5e-2, 10 km) cake + companion (3e-3, 30 km) at +50 km in x
    (makefield-Kuo2004.cpp:34-38)."""
    a = makefields.cake_kuo2004(CFG, CFG.lx / 2, CFG.ly / 2, 1.5e-2,
                                10_000.0)
    b = makefields.cake_kuo2004(CFG, CFG.lx / 2 + 50_000.0, CFG.ly / 2,
                                3e-3, 30_000.0)
    got = makefields.kuo2004(CFG)
    np.testing.assert_allclose(got, a + b, rtol=0, atol=1e-12)


def test_elliptic_vortex_structure():
    """Elliptic vortex (makefield-elliptic-vortex.cpp): peak amplitude
    ~zeta0 inside r_i, zero well outside r_o, and elliptical anisotropy
    (epsilon=0.7 squeezes the y-extent)."""
    got = makefields.elliptic_vortex(CFG)
    ci, cj = CFG.nx // 2, CFG.ny // 2
    assert abs(got[ci, cj] - 5e-3) < 5e-4
    # far field zero
    assert abs(got[0, 0]) == 0.0
    # anisotropy (makefield-elliptic-vortex.cpp alpha): c=(y-cy)/r, so
    # alpha=1 along the y-axis and alpha=sqrt(1-eps^2)~0.71 along x —
    # the vortex extends FARTHER along y than along x
    dx_cells = int(45_000 / CFG.dx)
    profile_x = got[ci + dx_cells, cj]
    profile_y = got[ci, cj + dx_cells]
    assert profile_y > profile_x


def test_all_generators_finite_and_float32():
    for name in ("gaussian", "const-vortex", "elliptic-vortex", "kuo2004"):
        f = makefields.make(name, CFG)
        assert f.dtype == np.float32
        assert np.isfinite(f).all(), name
