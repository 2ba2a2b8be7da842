"""Passive-tracer barotropic family: co-advect a scalar q with the flow.

New capability (no reference counterpart): the reference README advertises
an effective-eddy-diffusivity diagnostic (/root/reference/README.md:6,
unimplemented there — SURVEY.md §5.10-7) whose Nakamura formalism is
defined for a TRACER field; the existing diagnostics module
(diagnostics/eddy_diffusivity.py) applies it to vorticity, the natural
tracer of barotropic flow. This family closes the loop with a real
prognostic tracer:

    d zeta/dt = -u.grad(zeta) + S + nu    * lap(zeta)   (main.cpp:225-243)
    d q   /dt = -u.grad(q)        + kappa * lap(q)      (passive: no feedback)

Both tendencies follow the reference numerics contract (SURVEY.md §5):
spectral gradients with positive-Nyquist tables, advection products in
physical space, forward transform, spectral diffusion from the current
stage state, circular dealiasing of the TENDENCY, classic RK4 with
forcing held fixed across stages. The tracer uses its own diffusivity
kappa (default 0: purely advective, the Nakamura limit where kappa_eff /
kappa measures contour stretching alone).

Transform cost per RK stage: 6 inverses (zeta_x, zeta_y, u, v, q_x, q_y
— Hermitian-paired into 3 complex ifft2) + 2 forwards. A sharded
multi-device variant exists too (parallel.ShardedTracerModel; exercised
by __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from ..ops import fft
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables
from .barotropic import resolve_fft_backend


class TracerState(NamedTuple):
    zeta_hat: jax.Array     # (nx, hny) complex64 — unnormalized (FFTW fwd)
    q_hat: jax.Array        # (nx, hny) complex64


class TracerDiagFields(NamedTuple):
    vort: jax.Array
    psi: jax.Array
    u: jax.Array
    v: jax.Array
    q: jax.Array


class TracerStats(NamedTuple):
    max_abs_vort: jax.Array
    energy: jax.Array
    enstrophy: jax.Array
    cfl: jax.Array
    q_mean: jax.Array       # conserved by advection + diffusion
    q_var: jax.Array        # decays under kappa > 0; advection-neutral


def tendency(t: SpectralTables, state: TracerState, src: jax.Array,
             nu: float, kappa: float, grid_shape: Tuple[int, int],
             fwd: Callable = fft.forward,
             inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = None,
             r_drag: float = 0.0, beta: float = 0.0,
             nu4: float = 0.0) -> TracerState:
    """Un-dealiased joint tendency (zeta per main.cpp:146-244; q passive).

    r_drag != 0 adds the Ekman spin-down -r*zeta to the FLOW only — a
    passive tracer feels the boundary layer through the decaying
    velocities, not through its own concentration."""
    zeta_hat, q_hat = state
    # static trace-time branches: the ETDRK4 N zeroes every linear
    # coefficient (they live in the phi tables instead)
    lvort_hat = (sp.laplacian(t, zeta_hat)
                 if nu != 0.0 or nu4 != 0.0 else None)
    lq_hat = sp.laplacian(t, q_hat) if kappa != 0.0 else None
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    if inv_pair is None:
        inv_pair = (fft.inverse_pair if inv is fft.inverse else
                    (lambda a, b, g: (inv(a, g), inv(b, g))))
    dvdx, dvdy = inv_pair(sp.gradx(t, zeta_hat), sp.grady(t, zeta_hat),
                          grid_shape)
    u, v = inv_pair(-sp.grady(t, psi_hat), sp.gradx(t, psi_hat),
                    grid_shape)
    dqdx, dqdy = inv_pair(sp.gradx(t, q_hat), sp.grady(t, q_hat),
                          grid_shape)
    if beta != 0.0:
        # beta-plane -beta*v on the FLOW, folded into the advection
        # product (models/barotropic.py:tendency); the passive tracer is
        # advected by the beta-plane flow but has no planetary term
        dvdy = dvdy + beta
    dzeta = fwd(-u * dvdx - v * dvdy + src)
    if nu != 0.0:
        dzeta = dzeta + lvort_hat * nu
    if r_drag != 0.0:
        dzeta = dzeta - zeta_hat * r_drag
    if nu4 != 0.0:
        # hyperviscosity on the FLOW only (config.py nu4 note); the
        # tracer keeps its plain kappa diffusion
        dzeta = dzeta - sp.laplacian(t, lvort_hat) * nu4
    dq = fwd(-u * dqdx - v * dqdy)
    if kappa != 0.0:
        dq = dq + lq_hat * kappa
    return TracerState(dzeta, dq)


def rk4_step(t: SpectralTables, state: TracerState, src: jax.Array,
             dt: float, nu: float, kappa: float,
             grid_shape: Tuple[int, int],
             fwd: Callable = fft.forward,
             inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = None,
             r_drag: float = 0.0, beta: float = 0.0,
             nu4: float = 0.0) -> TracerState:
    """Joint RK4 (main.cpp:286-317 structure); both stage tendencies are
    dealiased, the states never are; src fixed across stages."""
    d = functools.partial(tendency, t, src=src, nu=nu, kappa=kappa,
                          grid_shape=grid_shape, fwd=fwd, inv=inv,
                          inv_pair=inv_pair, r_drag=r_drag, beta=beta,
                          nu4=nu4)

    def dl(s):
        r = d(s)
        return TracerState(sp.dealias(t, r.zeta_hat), sp.dealias(t, r.q_hat))

    def axpy(a, r, c):
        return TracerState(a.zeta_hat + r.zeta_hat * c,
                           a.q_hat + r.q_hat * c)

    r1 = dl(state)
    r2 = dl(axpy(state, r1, dt * 0.5))
    r3 = dl(axpy(state, r2, dt * 0.5))
    r4 = dl(axpy(state, r3, dt))
    c = dt / 6.0
    return TracerState(
        state.zeta_hat + (r1.zeta_hat + 2 * r2.zeta_hat
                          + 2 * r3.zeta_hat + r4.zeta_hat) * c,
        state.q_hat + (r1.q_hat + 2 * r2.q_hat
                       + 2 * r3.q_hat + r4.q_hat) * c)


def tracer_ic(cfg: ModelConfig, kind: str,
              vort0: Optional[np.ndarray] = None) -> np.ndarray:
    """Built-in tracer initial conditions (all smooth/periodic — a
    non-periodic coordinate ramp would ring in the spectral basis):

    vorticity   q0 = the initial vorticity itself (Hendricks & Schubert
                2009 use vorticity as the mixing tracer)
    zonal       q0 = sin(2 pi x / Lx): marks meridional transport
    meridional  q0 = sin(2 pi y / Ly): marks zonal shear/filamentation
    gaussian    q0 = exp(-(r/60km)^2): a blob at domain center
                (makefield-gaussian.cpp:14,31 shape with unit amplitude)
    """
    x, y = cfg.coords()
    X = np.asarray(x)[:, None]
    Y = np.asarray(y)[None, :]
    if kind == "vorticity":
        if vort0 is None:
            raise ValueError("tracer_ic('vorticity') needs vort0")
        return np.asarray(vort0, np.float32)
    if kind == "zonal":
        q = np.sin(2 * np.pi * X / cfg.lx) * np.ones_like(Y)
    elif kind == "meridional":
        q = np.sin(2 * np.pi * Y / cfg.ly) * np.ones_like(X)
    elif kind == "gaussian":
        r2 = (X - cfg.lx / 2) ** 2 + (Y - cfg.ly / 2) ** 2
        q = np.exp(-r2 / 60e3 ** 2)
    else:
        raise ValueError(f"unknown tracer IC {kind!r}")
    return q.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class TracerModel:
    """Compiled joint stepper bundle (mirrors BarotropicModel's facade)."""

    cfg: ModelConfig
    tables: SpectralTables
    kappa: float
    step: Callable
    segment: Callable
    diags: Callable
    stats: Callable

    @classmethod
    def build(cls, cfg: ModelConfig, kappa: float = 0.0,
              tables: Optional[SpectralTables] = None) -> "TracerModel":
        if cfg.time_scheme not in ("rk4", "etdrk4"):
            raise ValueError(f"unknown time_scheme {cfg.time_scheme!r}")
        etd = cfg.time_scheme == "etdrk4"
        t = tables if tables is not None else SpectralTables.from_config(cfg)
        g = cfg.grid_shape
        dt, nu, kp = float(cfg.dt), float(cfg.nu), float(kappa)
        fwd, inv, inv_pair = resolve_fft_backend(cfg.fft_backend)

        r_drag = float(cfg.r_drag)
        beta = float(cfg.beta)
        nu4 = float(cfg.nu4)

        if etd:
            # ETDRK4 with stacked per-mode scalar tables (2, nx, hny):
            # slot 0 the flow operator nu*lap - r - nu4*lap^2
            # (+ i*beta*kx*rlap), slot 1 the tracer diffusion
            # kappa*lap — both integrated exactly; N is the joint
            # advection-only tendency (models/etdrk4.py scalar-family
            # section). Diffusion stiffness no longer caps dt.
            from . import etdrk4 as etd_mod
            etabs = etd_mod.build_scalar_tables(cfg, dt, kind="tracer",
                                                kappa=kp)

            def _eN(t_, state, src):
                d = tendency(t_, state, src, nu=0.0, kappa=0.0,
                             grid_shape=g, fwd=fwd, inv=inv,
                             inv_pair=inv_pair)
                return TracerState(sp.dealias(t_, d.zeta_hat),
                                   sp.dealias(t_, d.q_hat))

            def _emul(T, s):
                return TracerState(T[0] * s.zeta_hat,
                                   T[1] * s.q_hat)

            @jax.jit
            def estep_(et, t_, state, src):
                return etd_mod.etd_scheme(
                    functools.partial(_eN, t_, src=src), _emul,
                    et, state)

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def esegment_(et, t_, state, src, n_steps: int):
                def body(s, _):
                    return etd_mod.etd_scheme(
                        functools.partial(_eN, t_, src=src),
                        _emul, et, s), None
                out, _ = jax.lax.scan(body, state, None, length=n_steps)
                return out

            step_ = functools.partial(estep_, etabs)
            segment_ = functools.partial(esegment_, etabs)
        else:
            @jax.jit
            def step_(t_, state, src):
                return rk4_step(t_, state, src, dt, nu, kp, g,
                                fwd=fwd, inv=inv, inv_pair=inv_pair,
                                r_drag=r_drag, beta=beta, nu4=nu4)

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def segment_(t_, state, src, n_steps: int):
                def body(s, _):
                    return rk4_step(t_, s, src, dt, nu, kp, g, fwd=fwd,
                                    inv=inv, inv_pair=inv_pair,
                                    r_drag=r_drag, beta=beta,
                                    nu4=nu4), None
                out, _ = jax.lax.scan(body, state, None, length=n_steps)
                return out

        @jax.jit
        def diags_(t_, state):
            psi_hat = sp.invert_laplacian(t_, state.zeta_hat)
            u_hat, v_hat = sp.velocities(t_, psi_hat)
            return TracerDiagFields(
                vort=inv(state.zeta_hat, g), psi=inv(psi_hat, g),
                u=inv(u_hat, g), v=inv(v_hat, g),
                q=inv(state.q_hat, g))

        @jax.jit
        def stats_(t_, state):
            psi_hat = sp.invert_laplacian(t_, state.zeta_hat)
            u_hat, v_hat = sp.velocities(t_, psi_hat)
            u, v = inv(u_hat, g), inv(v_hat, g)
            vort = inv(state.zeta_hat, g)
            q = inv(state.q_hat, g)
            return TracerStats(
                max_abs_vort=jnp.max(jnp.abs(vort)),
                energy=0.5 * jnp.mean(u * u + v * v),
                enstrophy=0.5 * jnp.mean(vort * vort),
                cfl=jnp.max(jnp.abs(u) / cfg.dx
                            + jnp.abs(v) / cfg.dy) * dt,
                q_mean=jnp.mean(q),
                q_var=jnp.var(q))

        return cls(
            cfg=cfg, tables=t, kappa=kp,
            step=functools.partial(step_, t),
            segment=functools.partial(segment_, t),
            diags=functools.partial(diags_, t),
            stats=functools.partial(stats_, t))

    def init_state(self, vort0, q0) -> TracerState:
        return TracerState(fft.forward(jnp.asarray(vort0, jnp.float32)),
                           fft.forward(jnp.asarray(q0, jnp.float32)))

    def zero_source(self) -> jax.Array:
        return jnp.zeros(self.cfg.grid_shape, jnp.float32)
