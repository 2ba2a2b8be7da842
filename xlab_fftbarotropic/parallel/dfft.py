"""Distributed 2-D real FFT over a device mesh (slab decomposition).

The reference's entire "communication backend" is a set of serial FFTW3f
plans (/root/reference/src/main.cpp:126-135) — it has zero parallelism of
any kind (SURVEY.md §2). This module is the distributed replacement: the
N x N grid is sharded by rows (x, the slow axis) over a 1-D mesh axis, and
the 2-D transform becomes

    local 1-D r2c FFT along the on-device contiguous y axis
    -> all_to_all transpose (rows -> half-spectrum columns)
    -> local full-length 1-D c2c FFT along x
    -> all_to_all transpose back (columns -> rows)

so every FFT executes on full local axes and the only communication is two
all-to-alls per transform, which XLA hands to the collective library
(NCCL on GPUs). The inverse mirrors it. All functions here are
*shard_map-local*: they take the local shard and use `jax.lax.all_to_all`
with the mesh axis name; wrap them in `jax.shard_map` (see parallel/model.py).

Layout contract matches the single-device path (ops/fft.py): physical
(nx, ny) float32, half-spectrum (nx, ny//2+1) complex64, forward
unnormalized, inverse scaled by 1/(nx*ny) (SURVEY.md §5.2). Both arrays are
sharded along axis 0 (x rows), so spectral pointwise operators in
ops/spectral.py run unchanged on shards with row-sliced coefficient tables.

The half axis ny//2+1 is odd and generally not divisible by the mesh size,
so transposes pad it with zero columns to the next multiple of the shard
count; the pad is stripped after the return transpose and never observed.
Overhead: n_shards/(ny+2) extra columns — <0.2% at 4096^2 x 8 shards.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _padded_half(hny: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= hny."""
    return -(-hny // n_shards) * n_shards


def transpose_to_columns(spec_rows: jax.Array, axis_name: str,
                         n_shards: int) -> jax.Array:
    """(nx/P, hny) row-shard -> (nx, hpad/P) column-shard, zero-padded.

    Device p ends up owning half-spectrum columns [p*hpad/P, (p+1)*hpad/P)
    over the FULL x extent, in global x order (all_to_all concatenates
    shards in mesh-axis order, which is global row order).
    """
    hny = spec_rows.shape[1]
    hpad = _padded_half(hny, n_shards)
    if hpad != hny:
        spec_rows = jnp.pad(spec_rows, ((0, 0), (0, hpad - hny)))
    return jax.lax.all_to_all(spec_rows, axis_name, split_axis=1,
                              concat_axis=0, tiled=True)


def transpose_to_rows(spec_cols: jax.Array, axis_name: str,
                      n_shards: int, hny: int) -> jax.Array:
    """(nx, hpad/P) column-shard -> (nx/P, hny) row-shard, pad stripped."""
    out = jax.lax.all_to_all(spec_cols, axis_name, split_axis=0,
                             concat_axis=1, tiled=True)
    return out[:, :hny]


def rfft2_local(field: jax.Array, axis_name: str,
                n_shards: int) -> jax.Array:
    """shard_map-local distributed rfft2.

    field: local (nx/P, ny) float32 -> local (nx/P, ny//2+1) complex64,
    unnormalized — distributed equivalent of ops/fft.py:forward and of the
    reference's fftwf_plan_dft_r2c_2d (main.cpp:126).
    """
    hny = field.shape[1] // 2 + 1
    spec = jnp.fft.rfft(field, axis=1)               # local y transform
    cols = transpose_to_columns(spec, axis_name, n_shards)
    cols = jnp.fft.fft(cols, axis=0)                 # full-length x transform
    return transpose_to_rows(cols, axis_name, n_shards, hny=hny)


def irfft2_local(spec: jax.Array, grid_shape: Optional[Tuple[int, int]],
                 axis_name: str, n_shards: int) -> jax.Array:
    """shard_map-local distributed irfft2, scaled by 1/(nx*ny).

    spec: local (nx/P, hny) complex64 -> local (nx/P, ny) float32.
    `grid_shape` is the GLOBAL (nx, ny) (may be None to infer ny from hny),
    matching the ops/fft.py:inverse signature so the model core can swap
    the two implementations.
    """
    hny = spec.shape[1]
    ny = (grid_shape[1] if grid_shape is not None else 2 * (hny - 1))
    cols = transpose_to_columns(spec, axis_name, n_shards)
    cols = jnp.fft.ifft(cols, axis=0)                # normalizes by 1/nx
    rows = transpose_to_rows(cols, axis_name, n_shards, hny=hny)
    return jnp.fft.irfft(rows, n=ny, axis=1)         # normalizes by 1/ny


def make_fft_pair(axis_name: str, n_shards: int):
    """(forward, inverse) callables with the ops/fft.py signatures, bound to
    a mesh axis — plug these into models.barotropic.rk4_step inside a
    shard_map to get the fully distributed step."""
    fwd = functools.partial(rfft2_local, axis_name=axis_name,
                            n_shards=n_shards)

    def inv(spec, grid_shape=None):
        return irfft2_local(spec, grid_shape, axis_name, n_shards)

    return fwd, inv
