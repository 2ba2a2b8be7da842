"""True pencil (2-D) domain decomposition for the distributed 2-D FFT.

The slab path (parallel/dfft.py) shards rows over ONE flattened mesh axis
and pays two MONOLITHIC all_to_alls per transform — every one of the P
devices exchanges with every other, so on a multi-host (host x device)
mesh each transpose crosses the inter-host network. This module implements the real 2-D
decomposition the BASELINE "slab->pencil" mandate asks for (the serial
plans being superseded: /root/reference/src/main.cpp:126-135):

  physical fields : 2-D TILES   (nx/Px, ny/Py), sharded P(px, py)
  spectral state  : X-PENCILS   (nx, hpad/P),   sharded P(None, (py, px))

with hpad the half axis ny//2+1 zero-padded to a multiple of P = Px*Py
(same padding trick as dfft.py; the pad columns carry exact zeros through
the whole step — the dealias mask is zero there, so even tendencies
vanish on the pad).

Forward transform (shard_map-local; device coordinates (i, j) on mesh
axes (px, py)):

  tiles (nx/Px, ny/Py)
    --a2a(py, split rows, concat y)-->  y-pencils (nx/P, ny)   [full y]
    --rfft along y; pad hny->hpad-->    (nx/P, hpad)
    --a2a(py, split cols, concat rows)--> (nx/Px, hpad/Py)
    --a2a(px, split cols, concat rows)--> (nx, hpad/P)         [full x]
    --fft along x-->                    x-pencil spectrum

Both orderings are chosen so the concatenations restore GLOBAL ascending
x with no local permutation: after the first a2a(py) device (i, j) owns
row block r = i*Py + j (contiguous, lexicographic), the second a2a(py)
gathers j'=0..Py-1 -> rows r' = i*Py + j' (consecutive!), and the final
a2a(px) stacks host blocks i'=0..Px-1 in order. The resulting spectral
column ownership is block b = j*Px + i, i.e. PartitionSpec
(None, (py, px)) — py major. The inverse mirrors each stage exactly.

Why this beats the slab across hosts: per transform, TWO of the three
collectives run over the intra-host 'py' axis only, and the single
inter-host 'px' stage moves each device's (nx/Px, hpad/Py) block — the
all-to-all inter-host traffic of the slab's monolithic transpose is
replaced by one host-level exchange whose participants and message
counts are Px, not P.
Spectral pointwise operators are UNCHANGED: they see column-sliced
tables (pad_tables) exactly as the slab path sees row-sliced ones.

Differentially tested against jnp.fft and the slab path on a 2x4 virtual
CPU mesh (tests/test_pencil.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.spectral import SpectralTables


def padded_half(hny: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= hny (same rule as dfft.py)."""
    return -(-hny // n_shards) * n_shards


def check_grid(nx: int, ny: int, px: int, py: int) -> None:
    if nx % (px * py) != 0:
        raise ValueError(
            f"pencil decomposition needs nx divisible by Px*Py: "
            f"nx={nx}, Px*Py={px * py}")
    if ny % py != 0:
        raise ValueError(
            f"pencil decomposition needs ny divisible by Py: "
            f"ny={ny}, Py={py}")


def pad_tables(t: SpectralTables, hpad: int) -> SpectralTables:
    """Zero/one-pad the half-axis of the coefficient tables to hpad.

    Pads: mask -> 0 (tendencies vanish on pad columns, keeping the state
    pad exactly zero forever), lap -> 0, ky -> 0, inv_lap/rlap -> 1
    (a zero pad there would put 0/0 = NaN into invert_laplacian on the
    pad, and NaN trips the blow-up guards even though it never mixes
    into real columns)."""
    hny = t.lap.shape[1]
    extra = hpad - hny
    if extra == 0:
        return t

    def pad2(a, value):
        return jnp.pad(a, ((0, 0), (0, extra)), constant_values=value)

    return SpectralTables(
        kx=t.kx,
        ky=jnp.pad(t.ky, (0, extra)),
        lap=pad2(t.lap, 0.0),
        inv_lap=pad2(t.inv_lap, 1.0),
        mask=pad2(t.mask, 0.0),
        rlap=pad2(t.rlap, 1.0),
    )


def table_specs(axes: Tuple[str, str]):
    """PartitionSpec pytree for the PADDED tables: column-sharded in the
    (py, px)-major order the transposes produce."""
    from jax.sharding import PartitionSpec as P
    col = (axes[1], axes[0])
    return SpectralTables(kx=P(), ky=P(col),
                          lap=P(None, col), inv_lap=P(None, col),
                          mask=P(None, col), rlap=P(None, col))


def state_spec(axes: Tuple[str, str]):
    """Spectral x-pencil sharding P(None, (py, px))."""
    from jax.sharding import PartitionSpec as P
    return P(None, (axes[1], axes[0]))


def phys_spec(axes: Tuple[str, str]):
    """Physical tile sharding P(px, py)."""
    from jax.sharding import PartitionSpec as P
    return P(axes[0], axes[1])


def rfft2_local(field: jax.Array, axes: Tuple[str, str],
                shape: Tuple[int, int], hny: int) -> jax.Array:
    """shard_map-local pencil rfft2: tile (nx/Px, ny/Py) float32 ->
    x-pencil (nx, hpad/P) complex64, unnormalized."""
    px_ax, py_ax = axes
    p = shape[0] * shape[1]
    # tiles -> y-pencils (full y)
    rows = jax.lax.all_to_all(field, py_ax, split_axis=0, concat_axis=1,
                              tiled=True)
    spec = jnp.fft.rfft(rows, axis=1)
    hpad = padded_half(hny, p)
    if hpad != hny:
        spec = jnp.pad(spec, ((0, 0), (0, hpad - hny)))
    # y-pencils -> x-pencils, intra-host stage first (consecutive row
    # blocks r = i*Py + j' concatenate in global order)
    cols = jax.lax.all_to_all(spec, py_ax, split_axis=1, concat_axis=0,
                              tiled=True)
    cols = jax.lax.all_to_all(cols, px_ax, split_axis=1, concat_axis=0,
                              tiled=True)
    return jnp.fft.fft(cols, axis=0)


def irfft2_local(spec: jax.Array, grid_shape: Optional[Tuple[int, int]],
                 axes: Tuple[str, str], shape: Tuple[int, int],
                 hny: int) -> jax.Array:
    """shard_map-local pencil irfft2: x-pencil (nx, hpad/P) complex64 ->
    tile (nx/Px, ny/Py) float32, scaled 1/(nx*ny)."""
    px_ax, py_ax = axes
    ny = (grid_shape[1] if grid_shape is not None else 2 * (hny - 1))
    cols = jnp.fft.ifft(spec, axis=0)            # normalizes 1/nx
    cols = jax.lax.all_to_all(cols, px_ax, split_axis=0, concat_axis=1,
                              tiled=True)
    rows = jax.lax.all_to_all(cols, py_ax, split_axis=0, concat_axis=1,
                              tiled=True)
    rows = rows[:, :hny]                         # strip pad
    field = jnp.fft.irfft(rows, n=ny, axis=1)    # normalizes 1/ny
    return jax.lax.all_to_all(field, py_ax, split_axis=1, concat_axis=0,
                              tiled=True)


def make_fft_pair(axes: Tuple[str, str], shape: Tuple[int, int],
                  hny: int):
    """(forward, inverse) shard_map-local callables with the ops/fft.py
    signatures, bound to the (px, py) mesh axes."""
    fwd = functools.partial(rfft2_local, axes=axes, shape=shape, hny=hny)

    def inv(spec, grid_shape=None):
        return irfft2_local(spec, grid_shape, axes, shape, hny)

    return fwd, inv


def make_pencil_mesh(shape: Tuple[int, int],
                     devices: Optional[list] = None,
                     axes: Tuple[str, str] = ("px", "py")):
    """2-D (Px, Py) mesh; put the INTER-HOST direction on axis 0 (px) —
    two of the three transpose stages per transform run over py only."""
    from jax.sharding import Mesh
    devices = list(devices if devices is not None else jax.devices())
    if shape[0] * shape[1] != len(devices):
        raise ValueError(f"mesh shape {shape} needs {shape[0] * shape[1]} "
                         f"devices, got {len(devices)}")
    return Mesh(np.array(devices).reshape(shape), axis_names=axes)


def pad_spectral(z: np.ndarray, hpad: int) -> np.ndarray:
    """(nx, hny) -> (nx, hpad) with zero pad columns (host-side)."""
    hny = z.shape[-1]
    if hpad == hny:
        return np.asarray(z)
    pad = [(0, 0)] * (z.ndim - 1) + [(0, hpad - hny)]
    return np.pad(np.asarray(z), pad)


def strip_spectral(z: np.ndarray, hny: int) -> np.ndarray:
    """(nx, hpad) -> (nx, hny) (host-side)."""
    return np.asarray(z)[..., :hny]
