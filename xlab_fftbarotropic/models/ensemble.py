"""Ensemble integration: vmap-batched member simulations in one program.

New capability with no reference counterpart: the reference runs
exactly one simulation per process (main.cpp — one state, one time
loop), so a perturbed-IC ensemble costs N full serial runs. The small and
mid-size grids the reference targets (768^2 default,
configuration.hpp:18) leave an accelerator mostly idle — a single 256^2
RK4 step is launch-latency-bound, not FLOP- or bandwidth-bound. Here
`jax.vmap` batches M independent members over a leading axis of ONE
jitted step/segment, so every FFT becomes a batched transform and every
pointwise stage a taller elementwise op: the device amortizes its launch
overhead across the whole ensemble instead of idling per member.

Design notes:
  * The member physics is exactly the single-run model (rk4_step of
    models/barotropic.py etc. — SURVEY.md §5 contract); member 0 of an
    `amplitude=0` ensemble is bit-comparable to a solo run of the same
    backend (pinned in tests/test_ensemble.py).
  * Forcing is SHARED across members (one source field per step, matching
    the reference's one-FIFO-stream protocol, SURVEY.md §3.2).
  * IC spread comes from `perturb_vorticity`: band-limited spectral noise,
    deterministic in (seed, n_members), member 0 left unperturbed as the
    control member.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..ops import fft


def perturb_vorticity(cfg: ModelConfig, vort0, n_members: int,
                      amplitude: float = 0.05, seed: int = 0,
                      k_frac: float = 0.5):
    """Batch of perturbed initial vorticity fields, shape (M, nx, ny).

    Member 0 is the unperturbed control. Members 1..M-1 add smooth,
    zero-mean, band-limited noise: unit-variance white noise restricted to
    isotropic wavenumber indices |k_idx| <= k_frac * dealias cutoff (so the
    perturbation lives well inside resolved scales), normalized to unit RMS
    in physical space, then scaled by `amplitude * rms(vort0)`. Fully
    deterministic in (seed, n_members, grid).
    """
    vort0 = jnp.asarray(vort0, jnp.float32)
    nx, ny = cfg.grid_shape
    if n_members < 1:
        raise ValueError(f"n_members must be >= 1, got {n_members}")
    if n_members == 1 or amplitude == 0.0:
        return jnp.broadcast_to(vort0, (n_members, nx, ny))

    @jax.jit
    def _make(v0):
        key = jax.random.PRNGKey(seed)
        noise = jax.random.normal(key, (n_members - 1, nx, ny),
                                  dtype=jnp.float32)
        # band-limit: circular low-pass in the half-spectrum, mean mode off
        kc = k_frac * float(min(cfg.dealias_kx, cfg.dealias_ky))
        ix = jnp.minimum(jnp.arange(nx), nx - jnp.arange(nx))
        jy = jnp.arange(ny // 2 + 1)
        r2 = ix[:, None] ** 2 + jy[None, :] ** 2
        lowpass = jnp.where((r2 > 0) & (r2 <= kc * kc), 1.0, 0.0)
        nh = jax.vmap(fft.forward)(noise) * lowpass[None]
        smooth = jax.vmap(lambda s: fft.inverse(s, (nx, ny)))(nh)
        rms = jnp.sqrt(jnp.mean(smooth * smooth, axis=(1, 2), keepdims=True))
        smooth = smooth / jnp.maximum(rms, 1e-30)
        scale = amplitude * jnp.sqrt(jnp.mean(v0 * v0))
        members = v0[None] + scale * smooth
        return jnp.concatenate([v0[None], members], axis=0)

    return _make(vort0)


def _member_model(cfg: ModelConfig, model_kind: str, tracer_kappa: float):
    """Build the inner single-member model."""
    if model_kind in ("barotropic", "bt"):
        from .barotropic import BarotropicModel
        return BarotropicModel.build(cfg)
    if model_kind in ("shallow-water", "sw"):
        from .shallow_water import ShallowWaterModel
        return ShallowWaterModel.build(cfg)
    if model_kind == "tracer":
        from .tracer import TracerModel
        return TracerModel.build(cfg, kappa=tracer_kappa)
    raise ValueError(
        f"ensemble is not supported for model kind {model_kind!r}")


def auto_vmap_width(cfg: ModelConfig, n_members: int) -> int:
    """Default vmap chunk width: full vmap up to 256², chunks of 8 at
    512², width 1 from 768² up (width-1 chunks pipeline members as
    async dispatches of the solo program). These crossovers were
    measured on the program's earlier accelerator
    (scripts/bench_ensemble.py) and are not yet measured on the GPU
    (ROADMAP S3d). Override with XFB_ENSEMBLE_WIDTH. The width is
    snapped down to a divisor of M."""
    import os
    env = os.environ.get("XFB_ENSEMBLE_WIDTH")
    if env:
        target = max(1, int(env))
    else:
        n = max(cfg.nx, cfg.ny)
        target = n_members if n <= 256 else (8 if n <= 512 else 1)
    target = min(target, n_members)
    while n_members % target:
        target -= 1
    return target


@dataclasses.dataclass(frozen=True)
class EnsembleModel:
    """vmap-batched M-member wrapper around one of the model families.

    `step`/`segment`/`diags` have the single-model signatures with every
    state leaf carrying a leading member axis; `src` stays unbatched
    (shared forcing). `stats` returns the inner family's NamedTuple with
    each scalar batched to shape (M,). Members advance in chunks of
    `vmap_width` via lax.map-over-vmap (one jitted program either way;
    see auto_vmap_width for the measured default).
    """

    cfg: ModelConfig
    n_members: int
    model_kind: str
    inner: object
    vmap_width: int
    step: Callable
    segment: Callable
    diags: Callable
    stats: Callable

    @classmethod
    def build(cls, cfg: ModelConfig, n_members: int,
              model_kind: str = "barotropic",
              tracer_kappa: float = 0.0,
              vmap_width: Optional[int] = None) -> "EnsembleModel":
        m = int(n_members)
        width = (auto_vmap_width(cfg, m) if vmap_width is None
                 else vmap_width)
        if width < 1 or m % width:
            raise ValueError(f"vmap_width {width} must divide "
                             f"n_members {m}")
        inner = _member_model(cfg, model_kind, tracer_kappa)

        def _chunked(member_fn):
            """Apply a single-member state->state fn across the batch.

            width == M: one vmapped program. width < M: a host loop of
            ASYNC dispatches of one compiled chunk program (the inner
            jitted step/segment is compiled once and reused; dispatches
            queue on-device, so chunks pipeline back-to-back). A
            scan-over-chunks (lax.map) measured 8-10x slower on the
            program's earlier accelerator — it wraps the whole batch in
            one sequential program instead of reusing the inner
            executable. width == 1 skips vmap so each member runs the
            true unbatched program."""
            vfn = jax.vmap(member_fn)

            def run(state):
                if width == m:
                    return vfn(state)
                tm = jax.tree_util.tree_map
                outs = []
                for i in range(0, m, width):
                    if width == 1:
                        outs.append(member_fn(tm(lambda a: a[i], state)))
                    else:
                        outs.append(vfn(
                            tm(lambda a: a[i:i + width], state)))
                if width == 1:
                    return tm(lambda *xs: jnp.stack(xs, axis=0), *outs)
                return tm(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
            return run

        def step(state, src):
            return _chunked(lambda st: inner.step(st, src))(state)

        def segment(state, src, n_steps: int):
            return _chunked(
                lambda st: inner.segment(st, src, n_steps))(state)

        def diags(state):
            return jax.vmap(inner.diags)(state)

        def stats(state):
            return jax.vmap(inner.stats)(state)

        return cls(cfg=cfg, n_members=m,
                   model_kind=model_kind, inner=inner, vmap_width=width,
                   step=step, segment=segment, diags=diags, stats=stats)

    def init_from_physical(self, vort0, amplitude: float = 0.05,
                           seed: int = 0):
        """Perturbed-IC batch -> batched model state."""
        batch = perturb_vorticity(self.cfg, vort0, self.n_members,
                                  amplitude=amplitude, seed=seed)
        if self.model_kind in ("shallow-water", "sw"):
            return jax.vmap(self.inner.geostrophic_init)(batch)
        if self.model_kind == "tracer":
            from .tracer import tracer_ic
            q0 = jax.vmap(lambda v: tracer_ic(self.cfg, "vorticity", v))(
                batch)
            return jax.vmap(self.inner.init_state)(batch, q0)
        return jax.vmap(self.inner.init_state)(batch)

    def spread(self, state) -> jax.Array:
        """Ensemble spread: RMS over the grid of the member standard
        deviation of physical vorticity — the standard chaos/divergence
        scalar for perturbed-IC ensembles."""
        vort = self.diags(state).vort            # (M, nx, ny)
        sd = jnp.std(vort, axis=0)
        return jnp.sqrt(jnp.mean(sd * sd))
