"""FFT backend.

Replacement for the reference's serial FFTW3f plans (main.cpp:126-135).
The 2-D real FFT lowers to XLA's FFT HLO, which XLA hands to cuFFT on the
GPU; there are no plans to manage, and transforms are traced into the
jitted step beside the elementwise work XLA fuses around them.

Normalization contract (SURVEY.md §5.2): the reference uses unnormalized
FFTW transforms and divides by GRIDS=N*N only after each inverse
(main.cpp:37-41). numpy/JAX's rfft2/irfft2 pair has exactly this convention
(forward unnormalized, inverse scaled by 1/(nx*ny)), so `forward`/`inverse`
here are allclose-bit-compatible with the reference pipeline without any
extra scaling. Unlike FFTW's c2r (which destroys its input, forcing the
reference into memcpy backup/restore dances, main.cpp:272-281), these are
pure functions.

Layout: the physical grid is x-major/y-contiguous (IDX(i,j)=ny*i+j,
configuration.hpp:31); rfft2 over the last axis halves y exactly like
fftwf_plan_dft_r2c_2d(XPTS, YPTS, ...) — spectral shape (nx, ny//2+1).

The distributed (multi-chip) transform lives in parallel/dfft.py; this module
is the single-device fast path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def forward(field: jax.Array) -> jax.Array:
    """Real (nx, ny) float32 -> half-spectrum (nx, ny//2+1) complex64.

    Unnormalized, matching fftwf_plan_dft_r2c_2d + fftwf_execute
    (main.cpp:126-127, 256).
    """
    return jnp.fft.rfft2(field)


def inverse(spec: jax.Array, grid_shape=None) -> jax.Array:
    """Half-spectrum complex64 -> real float32, scaled by 1/(nx*ny).

    Equivalent to fftwf_execute(c2r plan) followed by
    fftwf_backward_normalize (main.cpp:37-41), as one pure function.
    """
    if grid_shape is None:
        nx, hny = spec.shape[-2], spec.shape[-1]
        grid_shape = (nx, 2 * (hny - 1))
    return jnp.fft.irfft2(spec, s=grid_shape)


def _hermitian_full(s: jax.Array, ny: int) -> jax.Array:
    """(nx, ny//2+1) half-spectrum of a REAL field -> full (nx, ny)
    spectrum via the Hermitian symmetry S[-i, -j] = conj(S[i, j]).

    Columns j=0 and j=ny/2 (self-conjugate under the mirror) are
    SYMMETRIZED first: S[i, j] <- (S[i, j] + conj(S[-i, j]))/2. Half-spectra
    arising in this framework are not exactly Hermitian there — the
    reference's positive-Nyquist gradient convention (fftwfop.cpp:15-19)
    puts genuine non-Hermitian content in those columns, which irfft2
    implicitly projects out; without this projection that content leaks
    between the two fields packed into one complex transform (measured as a
    5e-3 trajectory divergence after 20 RK4 steps — vs 2e-8 with it).

    Cheap flips/concats — no transform. Requires even ny (all grids here).
    """
    def sym(col):
        mirror = jnp.conj(jnp.roll(col[::-1], 1))    # index i -> conj(S[-i])
        return 0.5 * (col + mirror)

    s = s.at[:, 0].set(sym(s[:, 0]))
    s = s.at[:, ny // 2].set(sym(s[:, ny // 2]))
    body = jnp.conj(s[:, 1:ny // 2])     # columns j' = 1 .. ny/2-1
    body = body[:, ::-1]                 # position m holds j' = ny/2-1-m
    body = jnp.concatenate([body[:1], body[1:][::-1]], axis=0)  # row -i mod nx
    return jnp.concatenate([s, body], axis=1)


def inverse_pair(spec_a: jax.Array, spec_b: jax.Array,
                 grid_shape) -> tuple:
    """TWO real-field inverse transforms for the price of ONE complex ifft2.

    For real fields a, b with half-spectra A, B, the complex field c = a+ib
    has full spectrum C = A_full + i*B_full; one c2c ifft2 then yields
    a = Re(c), b = Im(c), halving the inverse-transform count. This
    pairing was chosen on the program's earlier accelerator and is not yet
    measured against plain irfft2 calls on the GPU (ROADMAP S3a). Same
    1/(nx*ny) normalization contract as `inverse`.
    """
    nx, ny = grid_shape
    c = _hermitian_full(spec_a, ny) + 1j * _hermitian_full(spec_b, ny)
    z = jnp.fft.ifft2(c)
    return jnp.real(z), jnp.imag(z)


def forward_pair(a: jax.Array, b: jax.Array) -> tuple:
    """TWO real-field forward transforms via ONE complex fft2.

    C = fft2(a + ib); by linearity and Hermitian symmetry the half-spectra
    are A = (C(k) + conj(C(-k)))/2 and B = (C(k) - conj(C(-k)))/(2i),
    evaluated on the half axis only. Unnormalized, matching `forward`.

    The (-k mod n) index map is built as concat(x[:1], flip(x[1:])) per
    axis on the float32 real/imag planes — index 0 is its own mirror, the
    rest is a contiguous reversal, with no gather and no complex
    reverse/roll.
    """
    nx, ny = a.shape
    hny = ny // 2 + 1
    c = jnp.fft.fft2(a + 1j * b)
    cr, ci = jnp.real(c), jnp.imag(c)

    def negk(x):
        # row k -> row (nx - k) mod nx; then col j -> col ny - j for
        # j in [1, hny) with col 0 fixed, keeping only the half axis
        x = jnp.concatenate([x[:1], x[1:][::-1]], axis=0)
        return jnp.concatenate(
            [x[:, :1], x[:, ny - hny + 1:][:, ::-1]], axis=1)

    c_neg = jax.lax.complex(negk(cr), -negk(ci))
    c = c[:, :hny]
    spec_a = 0.5 * (c + c_neg)
    spec_b = -0.5j * (c - c_neg)
    return spec_a, spec_b
