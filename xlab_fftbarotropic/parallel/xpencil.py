"""x-pencil spectral layout for the 1-D slab decomposition — HALF the
all_to_all traffic of the row-sharded slab path.

The slab path (parallel/dfft.py) keeps BOTH physical and spectral arrays
row-sharded, so every transform pays two all_to_all transposes: rows ->
columns for the x-stage FFT, then columns -> rows to restore the layout.
But nothing in the model needs the spectrum row-sharded — every spectral
operator is pointwise (ops/spectral.py) and runs identically on
column-sliced coefficient tables (exactly how the 2-D pencil path
already stores its state, parallel/pencil.py). Keeping the spectral
state AS x-pencils therefore deletes the return transpose:

    forward:  rows (nx/P, ny) --rfft(y)--> (nx/P, hpad)
              --all_to_all--> (nx, hpad/P) --fft(x)--> x-pencil state
    inverse:  x-pencil --ifft(x)--> --all_to_all--> (nx/P, hpad)
              --strip pad; irfft(y)--> rows (nx/P, ny)

One transpose per transform instead of two — the distributed step's
collective volume halves outright (the reference being superseded has no
parallelism at all: serial FFTW plans, main.cpp:126-135).
Physical-space fields stay row-sharded, so the advection products, the
forcing ingest, and field I/O are unchanged from the slab path.

Relation to the 2-D pencil path (parallel/pencil.py): the x-pencil
SPECTRAL layout is the same; this module runs it on a 1-D (or flattened)
mesh axis.

The half axis pads to a multiple of P and the coefficient tables pad
alongside (pencil.pad_tables), so the pad columns carry exact zeros
forever: the dealias mask is zero there, hence every tendency vanishes
on the pad.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from jax.sharding import PartitionSpec as P

from ..ops.spectral import SpectralTables
from . import dfft


def table_specs(axis) -> SpectralTables:
    """Column-sharded table specs: full kx (the state holds all nx
    rows), half-axis-sharded ky and 2-D tables."""
    return SpectralTables(kx=P(), ky=P(axis),
                          lap=P(None, axis), inv_lap=P(None, axis),
                          mask=P(None, axis), rlap=P(None, axis))


def state_spec(axis):
    """Spectral x-pencil sharding (nx, hpad/P)."""
    return P(None, axis)


def phys_spec(axis):
    """Physical row sharding (nx/P, ny) — unchanged from the slab."""
    return P(axis, None)


def rfft2_local(field: jax.Array, axis_name: str,
                n_shards: int) -> jax.Array:
    """shard_map-local x-pencil rfft2: row shard (nx/P, ny) float32 ->
    x-pencil (nx, hpad/P) complex64, unnormalized (SURVEY.md §5.2)."""
    spec = jnp.fft.rfft(field, axis=1)
    cols = dfft.transpose_to_columns(spec, axis_name, n_shards)
    return jnp.fft.fft(cols, axis=0)


def irfft2_local(spec_cols: jax.Array,
                 grid_shape: Optional[Tuple[int, int]], axis_name: str,
                 n_shards: int, hny: int) -> jax.Array:
    """shard_map-local x-pencil irfft2: (nx, hpad/P) complex64 ->
    row shard (nx/P, ny) float32, scaled 1/(nx*ny)."""
    ny = (grid_shape[1] if grid_shape is not None else 2 * (hny - 1))
    cols = jnp.fft.ifft(spec_cols, axis=0)          # normalizes 1/nx
    rows = dfft.transpose_to_rows(cols, axis_name, n_shards, hny=hny)
    return jnp.fft.irfft(rows, n=ny, axis=1)        # normalizes 1/ny


def make_fft_pair(axis_name: str, n_shards: int, hny: int):
    """(forward, inverse) shard_map-local callables with the ops/fft.py
    signatures for the x-pencil layout."""
    fwd = functools.partial(rfft2_local, axis_name=axis_name,
                            n_shards=n_shards)

    def inv(spec, grid_shape=None):
        return irfft2_local(spec, grid_shape, axis_name, n_shards,
                            hny=hny)

    return fwd, inv
