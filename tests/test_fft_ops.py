"""ops/fft.py, the single-device transforms of the GPU hot path (jnp.fft,
lowered to cuFFT there), against numpy.fft; and the backend choice.

Shapes cover square and non-square, power-of-two and the 3*2^k class of
the reference's 768^2 default grid."""

import jax.numpy as jnp
import numpy as np
import pytest

from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.models.barotropic import resolve_fft_backend
from xlab_fftbarotropic.ops import fft
from xlab_fftbarotropic.ops import spectral as sp

SHAPES = [(64, 64), (64, 128), (128, 64), (96, 96), (48, 96), (768, 768)]


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _spectrum(shape, seed):
    """Half spectrum of a real field, as the model's state is."""
    return np.fft.rfft2(_field(shape, seed)).astype(np.complex64)


def _close(got, want, rtol=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < rtol, err


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_numpy(shape):
    f = _field(shape, 0)
    got = fft.forward(jnp.asarray(f))
    assert got.dtype == jnp.complex64
    assert got.shape == (shape[0], shape[1] // 2 + 1)
    _close(got, np.fft.rfft2(f.astype(np.float64)))


@pytest.mark.parametrize("shape", SHAPES)
def test_inverse_matches_numpy(shape):
    s = _spectrum(shape, 1)
    got = fft.inverse(jnp.asarray(s), shape)
    assert got.dtype == jnp.float32
    _close(got, np.fft.irfft2(s.astype(np.complex128), s=shape))


@pytest.mark.parametrize("shape", SHAPES)
def test_inverse_pair_matches_numpy(shape):
    a, b = _spectrum(shape, 2), _spectrum(shape, 3)
    ga, gb = fft.inverse_pair(jnp.asarray(a), jnp.asarray(b), shape)
    _close(ga, np.fft.irfft2(a.astype(np.complex128), s=shape))
    _close(gb, np.fft.irfft2(b.astype(np.complex128), s=shape))


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_pair_matches_numpy(shape):
    a, b = _field(shape, 4), _field(shape, 5)
    sa, sb = fft.forward_pair(jnp.asarray(a), jnp.asarray(b))
    _close(sa, np.fft.rfft2(a.astype(np.float64)))
    _close(sb, np.fft.rfft2(b.astype(np.float64)))


@pytest.mark.parametrize("shape", [(64, 64), (96, 96), (64, 128)])
def test_inverse_pair_projects_nyquist_and_column_zero(shape):
    """The positive-Nyquist gradients (fftwfop.cpp:15-19) put genuine
    non-Hermitian content in half-spectrum columns 0 and ny/2; irfft2
    projects it out, and inverse_pair must too (_hermitian_full's
    symmetrisation) or that content leaks between the packed fields."""
    cfg = ModelConfig(nx=shape[0], ny=shape[1])
    t = sp.SpectralTables.from_config(cfg)
    z = jnp.asarray(_spectrum(shape, 6))
    a, b = sp.gradx(t, z), sp.grady(t, z)
    for col in (0, shape[1] // 2):       # the content is really there
        c = np.asarray(a)[:, col]
        assert np.abs(c - np.conj(np.roll(c[::-1], 1))).max() > 0
    ga, gb = fft.inverse_pair(a, b, shape)
    _close(ga, np.fft.irfft2(np.asarray(a, np.complex128), s=shape))
    _close(gb, np.fft.irfft2(np.asarray(b, np.complex128), s=shape))


def test_auto_backend_is_jnp_fft():
    assert resolve_fft_backend("auto") == (fft.forward, fft.inverse,
                                           fft.inverse_pair)
    assert resolve_fft_backend("xla") == resolve_fft_backend("auto")


def test_mxu_backend_resolves_to_matmul_transforms():
    from xlab_fftbarotropic.ops import mxu_fft
    fwd, _, pair = resolve_fft_backend("mxu")
    assert fwd is mxu_fft.rfft2 and pair is mxu_fft.inverse_pair


@pytest.mark.parametrize("name", ["pallas", "cufft", ""])
def test_unknown_backend_rejected(name):
    """No fallback: a backend name that selects nothing is an error, in
    the config and in the resolver."""
    with pytest.raises(ValueError, match="fft_backend"):
        ModelConfig(fft_backend=name)
    with pytest.raises(ValueError, match="fft_backend"):
        resolve_fft_backend(name)
