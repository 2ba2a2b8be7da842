"""DFT-as-matmul four-step FFT (the 'mxu' fft_backend).

The reference delegates its transforms to serial FFTW3f plans
(main.cpp:126-135); the default path here is XLA's FFT lowering (cuFFT
on the GPU). This module is the plain-JAX alternative for matrix-unit
hardware: it re-expresses each 1-D DFT of length n = a*b as the
classic four-step (Cooley-Tukey / Bailey) factorization

    X[k1 + a*k2] = sum_j2 w_n^(j2*k1) * w_b^(j2*k2)
                     * sum_j1 w_a^(j1*k1) * x[j1*b + j2]

i.e. reshape the axis to (a, b), DFT-a as a matmul with the a x a DFT
matrix, pointwise twiddle, DFT-b as a matmul with the b x b DFT matrix,
then a digit-swap transpose. Both contractions are dense 32-128 wide
matmuls: ~(a+b) MACs per point instead of log2(n), but at matmul
throughput. Whether that pays on the GPU is measured by chip_smoke.py
(ROADMAP D4).

Real-transform structure exploited (this is what makes the backend
competitive, not the bare matmuls):

* rfft2: the y-axis stage runs on REAL input (two real-by-real matmuls,
  half the complex flops), and the x-axis stage runs AFTER slicing to the
  half-spectrum — half the columns.
* irfft2 / inverse_pair: the x-axis inverse runs on the half-spectrum
  (half the columns); the Hermitian extension to full y happens in the
  MIXED domain (x physical, y spectral), where the symmetry is per-row —
  S[i, ny-j] = conj(S[i, j]) — so it is one conj-flip concat with NO row
  permutation, and the self-conjugate columns j=0, ny/2 are fixed by
  taking their real part (the reference's positive-Nyquist gradient
  convention puts genuine non-Hermitian content there; dropping the
  projection leaks between paired fields — ops/fft.py:_hermitian_full).
* inverse_pair packs two real fields into one complex y-stage, exactly
  like ops/fft.py:inverse_pair but without ever materializing two full
  2-D spectra.

Numerics: DFT matrices/twiddles are built in float64 and cast to
complex64; matmuls run at jax.lax.Precision.HIGHEST (float32-accurate;
on the GPU this also keeps them out of TF32). Trajectory equivalence with the jnp.fft core after 20 RK4 steps is
pinned < 1e-6 in tests/test_mxu_fft.py.

Conventions match ops/fft.py (= FFTW/numpy): forward unnormalized,
inverse scaled by 1/n per axis.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Matmul precision for the DFT contractions. HIGHEST is float32-accurate;
# lower settings trade transform accuracy for matmul speed. Module-level
# and read at trace time so benchmarks can A/B it; models pick it up on
# (re)build.
PRECISION = jax.lax.Precision.HIGHEST


def _precision():
    return PRECISION


# Fold the digit-swap transpose (output index k = k1 + a*k2) into the
# second-stage einsum's output order instead of a separate swapaxes —
# lets XLA emit the permutation as the dot's output layout. A/B toggle.
FOLD_DIGIT_SWAP = False


def _split(n: int) -> Tuple[int, int]:
    """Factor n = a*b, both factors near sqrt(n) (powers of two only)."""
    if n & (n - 1) or n < 4:
        raise ValueError(f"matmul FFT requires power-of-two length >= 4, "
                         f"got {n}")
    log = n.bit_length() - 1
    a = 1 << (log - log // 2)       # ceil half
    return a, n // a


@functools.lru_cache(maxsize=None)
def _tables(n: int, forward: bool):
    """(F_a [k1,j1], twiddle [k1,j2], F_b [j2,k2]) complex64 tables.

    Cached as HOST numpy constants, not device arrays: a device array
    created during a trace would cache a tracer (leaks into later traces),
    and these are small enough (<=128x128 complex64, 128 KB) that
    embedding them as jit constants is the right call — unlike the big
    per-grid spectral tables, which must travel as jit arguments
    (models/barotropic.py note).
    """
    a, b = _split(n)
    sign = -2j if forward else 2j
    j1 = np.arange(a)
    f_a = np.exp(sign * np.pi * np.outer(j1, j1) / a)
    j2 = np.arange(b)
    tw = np.exp(sign * np.pi * np.outer(j1, j2) / n)
    f_b = np.exp(sign * np.pi * np.outer(j2, j2) / b)
    c64 = np.complex64
    return f_a.astype(c64), tw.astype(c64), f_b.astype(c64)


def _dft_last(x: jax.Array, forward: bool) -> jax.Array:
    """DFT along the LAST axis of a (..., n) array (real or complex in)."""
    n = x.shape[-1]
    a, b = _split(n)
    f_a, tw, f_b = _tables(n, forward)
    y = x.reshape(x.shape[:-1] + (a, b))                       # [., j1, j2]
    if not jnp.iscomplexobj(y):
        # real input: two real-by-real matmuls, half the complex flops
        yr = jnp.einsum("ka,...ab->...kb", jnp.real(f_a), y,
                        precision=_precision())
        yi = jnp.einsum("ka,...ab->...kb", jnp.imag(f_a), y,
                        precision=_precision())
        y = jax.lax.complex(yr, yi)
    else:
        y = jnp.einsum("ka,...ab->...kb", f_a, y, precision=_precision())
    y = y * tw                                                 # [., k1, j2]
    if FOLD_DIGIT_SWAP:
        y = jnp.einsum("...ab,bc->...ca", y, f_b, precision=_precision())
    else:
        y = jnp.einsum("...ab,bc->...ac", y, f_b, precision=_precision())
        y = jnp.swapaxes(y, -1, -2)                            # k = k1+a*k2
    return y.reshape(x.shape[:-1] + (n,))


def _dft_axis0(x: jax.Array, forward: bool) -> jax.Array:
    """DFT along the SECOND-TO-LAST axis of a (..., n, m) complex array.

    Contracts axis -2 directly via einsum — no physical transpose; the
    contiguous lane axis m stays in place through both matmul stages.
    """
    n, m = x.shape[-2], x.shape[-1]
    a, b = _split(n)
    f_a, tw, f_b = _tables(n, forward)
    y = x.reshape(x.shape[:-2] + (a, b, m))                    # [., j1, j2, m]
    y = jnp.einsum("ka,...abm->...kbm", f_a, y, precision=_precision())
    y = y * tw[:, :, None]                                     # [., k1, j2, m]
    if FOLD_DIGIT_SWAP:
        y = jnp.einsum("...abm,bc->...cam", y, f_b, precision=_precision())
    else:
        y = jnp.einsum("...abm,bc->...acm", y, f_b, precision=_precision())
        y = jnp.swapaxes(y, -3, -2)                            # k = k1+a*k2
    return y.reshape(x.shape[:-2] + (n, m))


# ---- c2c transforms (full-spectrum; used by tests and generic callers) ----

def fft2(x: jax.Array) -> jax.Array:
    """Unnormalized 2-D c2c DFT over the last two axes (= jnp.fft.fft2)."""
    return _dft_axis0(_dft_last(x, True), True)


def ifft2(x: jax.Array) -> jax.Array:
    """2-D c2c inverse DFT, scaled by 1/(n0*n1) (= jnp.fft.ifft2)."""
    n0, n1 = x.shape[-2], x.shape[-1]
    return _dft_axis0(_dft_last(x, False), False) * (1.0 / (n0 * n1))


# ---- real transforms (the model hot path) ----

def rfft2(x: jax.Array) -> jax.Array:
    """Real (..., nx, ny) -> half-spectrum (..., nx, ny//2+1), unnormalized.

    y-stage on real input (real matmuls), slice to the half axis, then the
    x-stage runs on half the columns.
    """
    ny = x.shape[-1]
    y = _dft_last(x, True)[..., : ny // 2 + 1]
    return _dft_axis0(y, True)


def _mixed_full(w: jax.Array, ny: int) -> jax.Array:
    """Hermitian-extend the y axis of a MIXED-domain array (x physical,
    y spectral): for a real field, each row's 1-D y-spectrum is Hermitian,
    S[i, ny-j] = conj(S[i, j]). Self-conjugate columns j=0, ny/2 are
    projected to their real part first (the positive-Nyquist leak guard —
    see module docstring and ops/fft.py:_hermitian_full)."""
    w = w.at[..., 0].set(jnp.real(w[..., 0]).astype(w.dtype))
    w = w.at[..., ny // 2].set(jnp.real(w[..., ny // 2]).astype(w.dtype))
    body = jnp.conj(w[..., 1:ny // 2])[..., ::-1]   # cols ny/2+1 .. ny-1
    return jnp.concatenate([w, body], axis=-1)


def irfft2(spec: jax.Array, s: Tuple[int, int]) -> jax.Array:
    """Half-spectrum -> real field, scaled by 1/(nx*ny) (= jnp.fft.irfft2)."""
    nx, ny = s[-2], s[-1]
    w = _dft_axis0(spec, False)                 # x inverse on half columns
    z = _dft_last(_mixed_full(w, ny), False)    # y inverse on full width
    return jnp.real(z) * (1.0 / (nx * ny))


def inverse_pair(spec_a: jax.Array, spec_b: jax.Array,
                 grid_shape) -> tuple:
    """Two real inverse transforms sharing ONE full-width y-stage.

    Both x-stages run on half-spectrum columns; the packed a + i*b complex
    field is only formed in the mixed domain, so no full 2-D spectrum is
    ever materialized (unlike ops/fft.py:inverse_pair).
    """
    nx, ny = grid_shape[-2], grid_shape[-1]
    wa = _dft_axis0(spec_a, False)
    wb = _dft_axis0(spec_b, False)
    c = _mixed_full(wa, ny) + 1j * _mixed_full(wb, ny)
    z = _dft_last(c, False) * (1.0 / (nx * ny))
    return jnp.real(z), jnp.imag(z)
