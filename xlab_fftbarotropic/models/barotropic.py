"""Barotropic vorticity model — the flagship dynamical core.

JAX re-design of the reference drivers main.cpp (unforced) and
main-shallow-water.cpp (forced; despite its name it integrates the same 2-D
barotropic vorticity equation — see /root/reference/TODO.md:5 and
SURVEY.md C6). Where the reference hand-schedules 19 fftwf buffers, 8 FFTW
plans and memcpy backup/restore around destructive c2r transforms
(main.cpp:103-135, 272-281), here the entire RK4 step is one pure function
of the spectral state, traced once by XLA and scanned over time — XLA owns
buffer allocation, fusion of pointwise stages, and
transparent sharding when the inputs carry a NamedSharding.

Equation (main.cpp:225-243):
    d zeta / dt = -u * zeta_x - v * zeta_y + S + nu * lap(zeta)
with u = -psi_y, v = +psi_x, lap(psi) = zeta, advanced by classic RK4 on the
half-spectrum state zeta_hat (complex64, shape (nx, ny//2+1)); each stage
tendency is dealiased (main.cpp:296-306), the state itself never is.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..ops import fft
from ..ops import spectral as sp
from ..ops.spectral import SpectralTables


def resolve_fft_backend(name: str):
    """(forward, inverse, inverse_pair) for a ModelConfig.fft_backend name.

    'auto' and 'xla' are jnp.fft (ops/fft.py), which XLA lowers to cuFFT
    on the GPU; 'mxu' is the einsum matmul four-step FFT
    (ops/mxu_fft.py), kept as an opt-in for comparison. Both honor the
    FFTW normalization contract (SURVEY.md §5.2) and agree to float32
    round-off.
    """
    if name in ("auto", "xla"):
        return fft.forward, fft.inverse, fft.inverse_pair
    if name == "mxu":
        from ..ops import mxu_fft
        return (mxu_fft.rfft2,
                lambda s, g: mxu_fft.irfft2(s, s=g),
                mxu_fft.inverse_pair)
    raise ValueError(f"unknown fft_backend: {name!r}")


class DiagFields(NamedTuple):
    """Physical-space fields recorded every record_step (SURVEY.md §5.9)."""
    vort: jax.Array
    psi: jax.Array
    u: jax.Array
    v: jax.Array


def tendency(t: SpectralTables, zeta_hat: jax.Array, src: jax.Array,
             nu: float, grid_shape: Tuple[int, int],
             fwd: Callable = fft.forward,
             inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = None,
             r_drag: float = 0.0, beta: float = 0.0,
             nu4: float = 0.0) -> jax.Array:
    """getDvortdt (main.cpp:146-244): un-dealiased spectral tendency.

    4 inverse + 1 forward FFT per call; the pointwise advection stage
    (-u*zeta_x - v*zeta_y + S, main.cpp:225-227) is a single elementwise
    expression that XLA fuses.

    `fwd`/`inv` are the FFT pair — the single-device jnp.fft wrappers by
    default, or the shard_map-local distributed transforms from
    parallel/dfft.py when called inside a sharded step. On the default
    (single-device) path the four inverse transforms are PAIRED into two
    complex ifft2 calls via Hermitian packing (ops/fft.py:inverse_pair).
    That choice was tuned on the program's earlier accelerator and is not
    yet measured on the GPU (ROADMAP S3a).
    """
    # nu == 0 is a static trace-time branch (the ETDRK4 N carries all
    # linear terms in its tables); nu != 0 traces the exact reference
    # expression
    lvort_hat = sp.laplacian(t, zeta_hat) if nu != 0.0 or nu4 != 0.0 \
        else None                                    # main.cpp:148
    psi_hat = sp.invert_laplacian(t, zeta_hat)       # main.cpp:179
    if inv_pair is None and inv is fft.inverse:
        inv_pair = fft.inverse_pair
    if inv_pair is not None:
        # zeta_x, zeta_y (main.cpp:151-168) | u=-psi_y, v=psi_x
        # (:198-214)
        dvdx, dvdy = inv_pair(sp.gradx(t, zeta_hat),
                              sp.grady(t, zeta_hat), grid_shape)
        u, v = inv_pair(-sp.grady(t, psi_hat),
                        sp.gradx(t, psi_hat), grid_shape)
    else:
        dvdx = inv(sp.gradx(t, zeta_hat), grid_shape)
        dvdy = inv(sp.grady(t, zeta_hat), grid_shape)
        u = -inv(sp.grady(t, psi_hat), grid_shape)
        v = inv(sp.gradx(t, psi_hat), grid_shape)
    if beta != 0.0:
        # beta-plane planetary-vorticity advection -beta*v folded into
        # the advection product: -u*zx - v*zy - beta*v =
        # -u*zx - v*(zy + beta). Static branch: beta=0 traces the exact
        # f-plane expression (bit-identical reference contract).
        dvdy = dvdy + beta
    dvortdt = -u * dvdx - v * dvdy + src             # main.cpp:225-227
    dvortdt_hat = fwd(dvortdt)                       # main.cpp:237
    out = (dvortdt_hat + lvort_hat * nu if nu != 0.0
           else dvortdt_hat)                         # main.cpp:240-243
    if r_drag != 0.0:
        # boundary-layer feedback (reference TODO.md:11, never
        # implemented there): Ekman/Rayleigh spin-down -r*zeta, applied
        # to the stage state like the viscous term. Static branch: the
        # default r_drag=0 traces the exact pre-drag computation.
        out = out - zeta_hat * r_drag
    if nu4 != 0.0:
        # biharmonic hyperviscosity -nu4*lap^2(zeta) (config.py nu4
        # note): an exact spectral diagonal, lap applied to the already
        # computed lap*zeta. Static branch when 0.
        out = out - sp.laplacian(t, lvort_hat) * nu4
    return out


def rk4_step(t: SpectralTables, zeta_hat: jax.Array, src: jax.Array,
             dt: float, nu: float, grid_shape: Tuple[int, int],
             fwd: Callable = fft.forward,
             inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = None,
             r_drag: float = 0.0, beta: float = 0.0,
             nu4: float = 0.0) -> jax.Array:
    """One RK4 step on zeta_hat (main.cpp:286-317).

    Each stage tendency is dealiased before use (main.cpp:296-306); the
    forcing src is held fixed across the 4 stages, refreshed at most once per
    step by the caller (main-shallow-water.cpp:304).
    """
    d = functools.partial(tendency, t, src=src, nu=nu, grid_shape=grid_shape,
                          fwd=fwd, inv=inv, inv_pair=inv_pair,
                          r_drag=r_drag, beta=beta, nu4=nu4)
    rk1 = sp.dealias(t, d(zeta_hat))
    rk2 = sp.dealias(t, d(zeta_hat + rk1 * (dt * 0.5)))
    rk3 = sp.dealias(t, d(zeta_hat + rk2 * (dt * 0.5)))
    rk4 = sp.dealias(t, d(zeta_hat + rk3 * dt))
    return zeta_hat + (rk1 + 2.0 * rk2 + 2.0 * rk3 + rk4) * (dt / 6.0)


def diag_fields(t: SpectralTables, zeta_hat: jax.Array,
                grid_shape: Tuple[int, int],
                inv: Callable = fft.inverse) -> DiagFields:
    """Step-start physical fields: the record block (main.cpp:266-282) plus
    the first RK stage's psi/u/v dumps (main.cpp:181-222)."""
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    u_hat, v_hat = sp.velocities(t, psi_hat)
    return DiagFields(
        vort=inv(zeta_hat, grid_shape),
        psi=inv(psi_hat, grid_shape),
        u=inv(u_hat, grid_shape),
        v=inv(v_hat, grid_shape),
    )


class DebugFields(NamedTuple):
    """The reference's debug-output-as-test dumps (SURVEY.md §4): the
    OUTPUT_GRAD_VORT / OUTPUT_DVORTDT #ifdef blocks of main.cpp:156-162,
    170-176 and 216-222 write, at each record step from the FIRST RK
    stage's RHS evaluation, the physical zeta gradients and the advective
    tendency -u*zeta_x - v*zeta_y + S as it stands BEFORE the forward
    transform and the spectral viscosity add."""
    dvortdx: jax.Array
    dvortdy: jax.Array
    dvortdt: jax.Array


def debug_fields(t: SpectralTables, zeta_hat: jax.Array, src: jax.Array,
                 grid_shape: Tuple[int, int],
                 inv: Callable = fft.inverse,
                 beta: float = 0.0) -> DebugFields:
    """Step-start debug intermediates (main.cpp:156-176, 216-222)."""
    dvdx = inv(sp.gradx(t, zeta_hat), grid_shape)
    dvdy = inv(sp.grady(t, zeta_hat), grid_shape)
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    u = -inv(sp.grady(t, psi_hat), grid_shape)
    v = inv(sp.gradx(t, psi_hat), grid_shape)
    adv_y = dvdy + beta if beta != 0.0 else dvdy
    return DebugFields(dvortdx=dvdx, dvortdy=dvdy,
                       dvortdt=-u * dvdx - v * adv_y + src)


class StepStats(NamedTuple):
    """Cheap per-step scalars (new capability; SURVEY.md §6 observability)."""
    max_abs_vort: jax.Array
    energy: jax.Array      # 0.5 * mean(u^2 + v^2)
    enstrophy: jax.Array   # 0.5 * mean(zeta^2)
    cfl: jax.Array         # max(|u|/dx + |v|/dy) * dt


def step_stats(t: SpectralTables, zeta_hat: jax.Array, cfg: ModelConfig) -> StepStats:
    g = cfg.grid_shape
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    u_hat, v_hat = sp.velocities(t, psi_hat)
    u = fft.inverse(u_hat, g)
    v = fft.inverse(v_hat, g)
    vort = fft.inverse(zeta_hat, g)
    return StepStats(
        max_abs_vort=jnp.max(jnp.abs(vort)),
        energy=0.5 * jnp.mean(u * u + v * v),
        enstrophy=0.5 * jnp.mean(vort * vort),
        cfl=jnp.max(jnp.abs(u) / cfg.dx + jnp.abs(v) / cfg.dy) * cfg.dt,
    )


@dataclasses.dataclass(frozen=True)
class BarotropicModel:
    """Compiled stepper bundle for a given configuration.

    `step`:    zeta_hat, src -> zeta_hat after ONE RK4 step.
    `segment`: zeta_hat, src -> zeta_hat after `record_step` RK4 steps, as a
               single jitted lax.scan — the hot path between record points
               (no host round-trips, constant forcing within the segment).
    `diags`:   zeta_hat -> DiagFields (physical vort/psi/u/v).
    `stats`:   zeta_hat -> StepStats scalars.
    """

    cfg: ModelConfig
    tables: SpectralTables
    step: Callable
    segment: Callable
    diags: Callable
    stats: Callable
    debug: Optional[Callable] = None   # zeta_hat, src -> DebugFields

    @classmethod
    def build(cls, cfg: ModelConfig,
              tables: Optional[SpectralTables] = None) -> "BarotropicModel":
        if cfg.time_scheme not in ("rk4", "etdrk4"):
            raise ValueError(f"unknown time_scheme {cfg.time_scheme!r}")
        etd = cfg.time_scheme == "etdrk4"
        t = tables if tables is not None else SpectralTables.from_config(cfg)
        g = cfg.grid_shape
        dt, nu = float(cfg.dt), float(cfg.nu)
        r_drag = float(cfg.r_drag)
        beta = float(cfg.beta)
        nu4 = float(cfg.nu4)
        fwd, inv, inv_pair = resolve_fft_backend(cfg.fft_backend)

        # The coefficient tables are passed as jit ARGUMENTS (bound via
        # partial), not closed over: closure arrays get embedded in the
        # executable as constants, which copies them to the host at
        # lowering time and bloats the executable.
        if etd:
            # ETDRK4 with per-mode SCALAR phi tables (models/etdrk4.py
            # scalar-family section): the linear operator
            # nu*lap - r - nu4*lap^2 (+ i*beta*kx*rlap) is integrated
            # exactly — only the advective CFL remains, lifting the
            # nu4-stiffness dt cap. N is the advection-only tendency
            # (every linear coefficient zero), dealiased per stage;
            # drag/beta/nu4 live in the tables.
            from . import etdrk4 as etd_mod
            etabs = etd_mod.build_scalar_tables(cfg, dt,
                                                kind="barotropic")

            def _eN(t, zeta_hat, src):
                return sp.dealias(t, tendency(
                    t, zeta_hat, src, nu=0.0, grid_shape=g,
                    fwd=fwd, inv=inv, inv_pair=inv_pair))

            @jax.jit
            def estep_(et, t, zeta_hat, src):
                return etd_mod.etd_scheme(
                    functools.partial(_eN, t, src=src),
                    lambda T, z: T * z, et, zeta_hat)

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def esegment_(et, t, zeta_hat, src, n_steps: int):
                def body(z, _):
                    return etd_mod.etd_scheme(
                        functools.partial(_eN, t, src=src),
                        lambda T, x: T * x, et, z), None
                z, _ = jax.lax.scan(body, zeta_hat, None, length=n_steps)
                return z

            # the phi tables ride as leading jit ARGUMENTS too
            step_ = functools.partial(estep_, etabs)
            segment_ = functools.partial(esegment_, etabs)
        else:
            @jax.jit
            def step_(t, zeta_hat, src):
                return rk4_step(t, zeta_hat, src, dt, nu, g,
                                fwd=fwd, inv=inv, inv_pair=inv_pair,
                                r_drag=r_drag, beta=beta, nu4=nu4)

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def segment_(t, zeta_hat, src, n_steps: int):
                def body(z, _):
                    return rk4_step(t, z, src, dt, nu, g,
                                    fwd=fwd, inv=inv, inv_pair=inv_pair,
                                    r_drag=r_drag, beta=beta,
                                    nu4=nu4), None
                z, _ = jax.lax.scan(body, zeta_hat, None, length=n_steps)
                return z

        @jax.jit
        def diags_(t, zeta_hat):
            return diag_fields(t, zeta_hat, g)

        @jax.jit
        def stats_(t, zeta_hat):
            return step_stats(t, zeta_hat, cfg)

        @jax.jit
        def debug_(t, zeta_hat, src):
            return debug_fields(t, zeta_hat, src, g, beta=beta)

        def segment(zeta_hat, src, n_steps: int):
            return segment_(t, zeta_hat, src, n_steps)

        return cls(cfg=cfg, tables=t,
                   step=functools.partial(step_, t),
                   segment=segment,
                   diags=functools.partial(diags_, t),
                   stats=functools.partial(stats_, t),
                   debug=functools.partial(debug_, t))

    def init_state(self, vort0) -> jax.Array:
        """Physical initial vorticity -> spectral state (main.cpp:256)."""
        return fft.forward(jnp.asarray(vort0, dtype=jnp.float32))

    def zero_source(self) -> jax.Array:
        """The reference never initializes vort_src (fresh zero pages,
        SURVEY.md §5.10-1); we zero it explicitly."""
        return jnp.zeros(self.cfg.grid_shape, dtype=jnp.float32)
