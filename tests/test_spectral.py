"""Unit tests for the spectral operator library.

Strategy per SURVEY.md §4: each operator checked against closed-form
sin/cos eigenfunctions and against the structural contract of the reference
tables (positive Nyquist, circular dealias mask, mean-mode passthrough of
the Laplacian inverse — fftwfop.cpp:14-68,112-117).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ops import fft
from xlab_fftbarotropic.ops import spectral as sp


def tables(cfg):
    return sp.SpectralTables.from_config(cfg)


def wave_field(cfg, mx, my, phase=0.3):
    x, y = cfg.coords()
    X, Y = np.meshgrid(x.astype(np.float64), y.astype(np.float64),
                       indexing="ij")
    kx = 2 * np.pi * mx / cfg.lx
    ky = 2 * np.pi * my / cfg.ly
    return np.sin(kx * X + ky * Y + phase), kx, ky


class TestWavenumbers:
    def test_gradx_positive_nyquist(self):
        # fftwfop.cpp:14-19 — the x-Nyquist mode N/2 keeps +pi*N/Lx.
        k = sp.wavenumbers_x(8, 2.0)
        assert k[4] == pytest.approx(2 * np.pi * 4 / 2.0)
        assert k[5] == pytest.approx(-k[3])
        assert k[7] == pytest.approx(-k[1])
        assert k[0] == 0.0

    def test_grady_half_axis_all_positive(self):
        k = sp.wavenumbers_y(8, 2.0)
        assert k.shape == (5,)
        assert (k >= 0).all()
        assert k[4] == pytest.approx(2 * np.pi * 4 / 2.0)


class TestDealiasMask:
    def test_circular_not_tensor_product(self):
        # SURVEY.md §5.6: circular radius sqrt(kcx^2+kcy^2); e.g. for N=768
        # the mode (362, 0) survives though 362 >= kc=256.
        m = sp.dealias_mask(768, 768, "circular")
        assert m[362, 0] == 1.0
        assert m[768 - 362, 0] == 1.0      # mirrored row
        kc = int(np.ceil(768 / 3))
        r2 = 2 * kc * kc
        # just inside/outside the circle on the j axis
        j_in = int(np.floor(np.sqrt(r2 - 1)))
        assert m[0, min(j_in, 768 // 2)] == 1.0

    def test_circular_kill_region(self):
        m = sp.dealias_mask(12, 12, "circular")
        kc = int(np.ceil(12 / 3))  # 4
        thresh = kc**2 + kc**2     # 32
        for i in range(12):
            ir = min(i, 12 - i)
            for j in range(7):
                expect = 0.0 if ir * ir + j * j >= thresh else 1.0
                assert m[i, j] == expect, (i, j)

    def test_twothirds_rule(self):
        m = sp.dealias_mask(12, 12, "twothirds")
        assert m[3, 3] == 1.0
        assert m[4, 0] == 0.0    # i >= kc
        assert m[0, 4] == 0.0    # j >= kc
        assert m[12 - 3, 3] == 1.0


class TestOperators:
    def test_gradx_eigenfunction(self, small_cfg):
        t = tables(small_cfg)
        f, kx, ky = wave_field(small_cfg, 3, 0)
        fh = fft.forward(jnp.asarray(f, jnp.float32))
        df = fft.inverse(sp.gradx(t, fh), small_cfg.grid_shape)
        x, y = small_cfg.coords()
        X, Y = np.meshgrid(x.astype(np.float64), y.astype(np.float64),
                           indexing="ij")
        expect = kx * np.cos(kx * X + 0.3)
        np.testing.assert_allclose(np.asarray(df), expect, atol=1e-4 * kx)

    def test_grady_eigenfunction(self, small_cfg):
        t = tables(small_cfg)
        f, kx, ky = wave_field(small_cfg, 0, 5)
        fh = fft.forward(jnp.asarray(f, jnp.float32))
        df = fft.inverse(sp.grady(t, fh), small_cfg.grid_shape)
        x, y = small_cfg.coords()
        X, Y = np.meshgrid(x.astype(np.float64), y.astype(np.float64),
                           indexing="ij")
        expect = ky * np.cos(ky * Y + 0.3)
        np.testing.assert_allclose(np.asarray(df), expect, atol=1e-4 * ky)

    def test_laplacian_eigenfunction(self, small_cfg):
        t = tables(small_cfg)
        f, kx, ky = wave_field(small_cfg, 2, 3)
        fh = fft.forward(jnp.asarray(f, jnp.float32))
        lap = fft.inverse(sp.laplacian(t, fh), small_cfg.grid_shape)
        k2 = kx**2 + ky**2
        np.testing.assert_allclose(np.asarray(lap), -k2 * f, atol=1e-4 * k2)

    def test_invert_laplacian_roundtrip(self, small_cfg, rng):
        t = tables(small_cfg)
        f = rng.randn(*small_cfg.grid_shape).astype(np.float32)
        fh = fft.forward(jnp.asarray(f))
        rt = sp.laplacian(t, sp.invert_laplacian(t, fh))
        # mean mode passes through unchanged in inversion but laplacian
        # multiplies it by 0 — compare all non-mean modes.
        fh_np = np.array(fh)
        rt_np = np.array(rt)
        fh_np[0, 0] = 0
        rt_np[0, 0] = 0
        np.testing.assert_allclose(rt_np, fh_np, rtol=2e-5, atol=2e-4)

    def test_invert_laplacian_mean_passthrough(self, small_cfg):
        # fftwfop.cpp:43 — the (0,0) divisor is 1.0, the mean is preserved.
        t = tables(small_cfg)
        fh = jnp.zeros(small_cfg.spectral_shape, jnp.complex64)
        fh = fh.at[0, 0].set(7.0 + 0j)
        out = sp.invert_laplacian(t, fh)
        assert complex(out[0, 0]) == pytest.approx(7.0 + 0j)

    def test_velocities_sign_convention(self, small_cfg):
        # u = -psi_y, v = +psi_x (main.cpp:198-214)
        t = tables(small_cfg)
        psi, kx, ky = wave_field(small_cfg, 1, 2)
        ph = fft.forward(jnp.asarray(psi, jnp.float32))
        uh, vh = sp.velocities(t, ph)
        u = fft.inverse(uh, small_cfg.grid_shape)
        v = fft.inverse(vh, small_cfg.grid_shape)
        x, y = small_cfg.coords()
        X, Y = np.meshgrid(x.astype(np.float64), y.astype(np.float64),
                           indexing="ij")
        c = np.cos(kx * X + ky * Y + 0.3)
        np.testing.assert_allclose(np.asarray(u), -ky * c, atol=2e-4 * ky)
        np.testing.assert_allclose(np.asarray(v), kx * c, atol=2e-4 * kx)


class TestAgainstOracleTables:
    """The jnp tables must equal the numpy oracle tables bit-for-bit."""

    def test_tables_match(self, small_cfg):
        from xlab_fftbarotropic.oracle.reference_cpu import OracleTables
        t = tables(small_cfg)
        o = OracleTables(small_cfg.nx, small_cfg.ny, small_cfg.lx,
                         small_cfg.ly, small_cfg.dealias_rule)
        np.testing.assert_array_equal(np.asarray(t.kx), o.kx)
        np.testing.assert_array_equal(np.asarray(t.ky), o.ky)
        np.testing.assert_array_equal(np.asarray(t.lap), o.lap)
        np.testing.assert_array_equal(np.asarray(t.inv_lap), o.inv_lap)
        np.testing.assert_array_equal(np.asarray(t.mask), o.mask)


def test_inverse_pair_matches_irfft2(rng):
    import jax.numpy as jnp
    from xlab_fftbarotropic.ops import fft
    a = rng.randn(32, 24).astype(np.float32)
    b = rng.randn(32, 24).astype(np.float32)
    sa = jnp.fft.rfft2(a)
    sb = jnp.fft.rfft2(b)
    ga, gb = fft.inverse_pair(sa, sb, (32, 24))
    np.testing.assert_allclose(np.asarray(ga), a, rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(gb), b, rtol=0, atol=2e-5)


def test_forward_pair_matches_rfft2(rng):
    from xlab_fftbarotropic.ops import fft
    import jax.numpy as jnp
    a = rng.randn(48, 32).astype(np.float32)
    b = rng.randn(48, 32).astype(np.float32)
    sa, sb = fft.forward_pair(jnp.asarray(a), jnp.asarray(b))
    wa = np.fft.rfft2(a)
    wb = np.fft.rfft2(b)
    scale = np.abs(wa).max()
    np.testing.assert_allclose(np.asarray(sa), wa, rtol=0, atol=3e-4 * scale)
    np.testing.assert_allclose(np.asarray(sb), wb, rtol=0, atol=3e-4 * scale)
