"""DFT-as-matmul FFT (ops/mxu_fft.py) vs numpy/jnp.fft reference.

The four-step factorization must reproduce the library transforms to
float32 round-off at every grid size the framework uses; the model-level
test pins trajectory equivalence when the whole RK4 core runs on the
matmul transforms.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic import makefields
from xlab_fftbarotropic.ops import mxu_fft


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


@pytest.mark.parametrize("n", [64, 128, 256, 1024])
def test_fft2_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, n)).astype(np.float32)
    assert _rel(np.fft.fft2(x), mxu_fft.fft2(x)) < 2e-6
    assert _rel(np.fft.rfft2(x), mxu_fft.rfft2(x)) < 2e-6


@pytest.mark.parametrize("n", [64, 256])
def test_ifft2_and_irfft2_match_numpy(n):
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal((n, n)).astype(np.float32)
    c = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    assert _rel(np.fft.ifft2(c), mxu_fft.ifft2(jnp.asarray(c))) < 2e-6
    spec = np.fft.rfft2(x).astype(np.complex64)
    assert _rel(np.fft.irfft2(spec, s=(n, n)),
                mxu_fft.irfft2(jnp.asarray(spec), s=(n, n))) < 2e-6


def test_inverse_pair_matches_separate():
    n = 128
    rng = np.random.default_rng(7)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    sa = jnp.asarray(np.fft.rfft2(a).astype(np.complex64))
    sb = jnp.asarray(np.fft.rfft2(b).astype(np.complex64))
    ga, gb = mxu_fft.inverse_pair(sa, sb, (n, n))
    assert _rel(a, ga) < 2e-6
    assert _rel(b, gb) < 2e-6


def test_non_power_of_two_rejected():
    with pytest.raises(ValueError):
        mxu_fft.fft2(np.zeros((48, 48), np.float32))


def test_rk4_trajectory_equivalence():
    """20 RK4 steps on the matmul transforms vs the jnp.fft core."""
    from xlab_fftbarotropic.models import barotropic as m
    from xlab_fftbarotropic.ops import fft
    from xlab_fftbarotropic.ops.spectral import SpectralTables

    cfg = ModelConfig(nx=128, ny=128)
    t = SpectralTables.from_config(cfg)
    z0 = fft.forward(jnp.asarray(makefields.kuo2004(cfg)))
    src = jnp.zeros(cfg.grid_shape, jnp.float32)

    z_ref, z_mxu = z0, z0
    for _ in range(20):
        z_ref = m.rk4_step(t, z_ref, src, cfg.dt, cfg.nu, cfg.grid_shape)
        z_mxu = m.rk4_step(t, z_mxu, src, cfg.dt, cfg.nu, cfg.grid_shape,
                           fwd=mxu_fft.rfft2,
                           inv=lambda s, g: mxu_fft.irfft2(s, s=g))
    a = np.asarray(jnp.fft.irfft2(z_ref, s=cfg.grid_shape))
    b = np.asarray(jnp.fft.irfft2(z_mxu, s=cfg.grid_shape))
    assert np.max(np.abs(a - b)) < 1e-6 * max(1.0, np.max(np.abs(a)))
