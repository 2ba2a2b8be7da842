"""Rotating shallow-water model (vorticity-divergence-height spectral form).

Capability the reference only promised: main-shallow-water.cpp is a misnomer
that still integrates the 2-D barotropic vorticity equation
(/root/reference/TODO.md:5 "Implement real shallow water system"; SURVEY.md
C6). This is the real thing: prognostic half-spectrum
state (zeta_hat, div_hat, eta_hat), the whole time step (RK4, or the
exact-linear ETDRK4 of models/etdrk4.py via --time-scheme) a pure jittable
function reusing the barotropic package's spectral tables, FFT backends
(single-device or distributed), and dealiasing contract.

Continuous equations on the doubly-periodic f-plane, vector-invariant form
with q = zeta + f the absolute vorticity, h = H + eta the fluid depth
(H = cfg.mean_depth; the PERTURBATION eta is prognostic — carrying the full
depth in float32 would bury metre-scale dynamics in the round-off of the
kilometre-scale mean, a conditioning bug this layout designs away), and
Phi = g*eta + (u^2+v^2)/2 the Bernoulli function (the constant g*H drops
out of the gradient):

    d zeta / dt = -div(q * u_vec)               + nu * lap(zeta) + S
    d delta/ dt =  curl_z(q * u_vec) - lap(Phi) + nu * lap(delta)
    d eta  / dt = -H * delta - div(eta * u_vec)

where curl_z(q u_vec) = d(q v)/dx - d(q u)/dy. Velocities recovered by the
Helmholtz decomposition u = -psi_y + chi_x, v = psi_x + chi_y with
lap(psi) = zeta, lap(chi) = delta (same invertLaplacian semantics as the
barotropic core: spectral mean mode passes through, fftwfop.cpp:43).

Per RK4 stage: 5 inverse FFTs (u, v, zeta, delta, h) + 3 forward FFTs
(the three flux/Bernoulli groups), all pointwise work fused by XLA. Each
stage tendency is dealiased with the reference's circular mask, matching
the barotropic contract (main.cpp:296-306).

The optional source S feeds the vorticity equation only, mirroring the
forced barotropic driver's vort_src (main-shallow-water.cpp:304).
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


class SWState(NamedTuple):
    """Half-spectrum prognostic state, all complex64 (nx, ny//2+1)."""
    zeta_hat: jax.Array   # relative vorticity
    div_hat: jax.Array    # horizontal divergence
    eta_hat: jax.Array    # depth PERTURBATION about cfg.mean_depth


class SWDiagFields(NamedTuple):
    """Physical-space fields for record output."""
    vort: jax.Array
    div: jax.Array
    h: jax.Array
    u: jax.Array
    v: jax.Array
    psi: jax.Array


def sw_velocities(t: SpectralTables, zeta_hat: jax.Array,
                  div_hat: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Helmholtz: u_hat = -i ky psi_hat + i kx chi_hat, v_hat mirrored."""
    psi_hat = sp.invert_laplacian(t, zeta_hat)
    chi_hat = sp.invert_laplacian(t, div_hat)
    u_hat = -sp.grady(t, psi_hat) + sp.gradx(t, chi_hat)
    v_hat = sp.gradx(t, psi_hat) + sp.grady(t, chi_hat)
    return u_hat, v_hat


def tendency(t: SpectralTables, s: SWState, src: jax.Array,
             f: float, g: float, nu: float, mean_depth: float,
             grid_shape: Tuple[int, int],
             fwd: Callable = fft.forward,
             inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = None,
             fwd_pair: Optional[Callable] = None,
             split: bool = False,
             r_drag: float = 0.0, nu4: float = 0.0) -> SWState:
    """Un-dealiased spectral tendencies of (zeta, delta, eta).

    r_drag != 0 adds the boundary-layer feedback (reference TODO.md:11):
    linear surface drag -r*u_vec on the momentum, i.e. -r*zeta on the
    vorticity and -r*delta on the divergence equation; the mass (eta)
    equation is untouched. Static branch — the default traces the exact
    pre-drag computation.

    On the default single-device FFT path the 4 inverse transforms are
    Hermitian-PAIRED into 2 complex c2c transforms (ops/fft.py:inverse_pair).
    When fwd_pair is given (ShallowWaterModel.build passes
    forward_pair_for's choice), the two flux pairs
    (qu, qv) and (eta*u, eta*v) are likewise packed into one complex
    fft2 each — 5 forward transforms per stage become 3.

    split=True is the split-linear formulation: the exactly-linear
    f0/gravity terms — curl_z(f0 u) = f0*Z, div(f0 u) = f0*D (both zero
    at the mean mode), lap(g eta) = g*lap*E — are applied as spectral
    multiplies on the state instead of riding the transforms. The ETDRK4
    nonlinear tendency (models/etdrk4.py:etdrk4_step) uses it with every
    linear coefficient zeroed.
    """
    u_hat, v_hat = sw_velocities(t, s.zeta_hat, s.div_hat)
    if inv_pair is None and inv is fft.inverse:
        inv_pair = fft.inverse_pair
    if inv_pair is not None:
        u, v = inv_pair(u_hat, v_hat, grid_shape)
        zeta, eta = inv_pair(s.zeta_hat, s.eta_hat, grid_shape)
    else:
        u = inv(u_hat, grid_shape)
        v = inv(v_hat, grid_shape)
        zeta = inv(s.zeta_hat, grid_shape)
        eta = inv(s.eta_hat, grid_shape)

    q = zeta if split else zeta + f    # absolute vorticity (f-plane)
    if fwd_pair is not None:
        qu_hat, qv_hat = fwd_pair(q * u, q * v)
        eu_hat, ev_hat = fwd_pair(eta * u, eta * v)
    else:
        qu_hat = fwd(q * u)
        qv_hat = fwd(q * v)
        eu_hat = fwd(eta * u)
        ev_hat = fwd(eta * v)
    # Bernoulli: g*eta + kinetic energy (pointwise, fused); split mode
    # transforms only the KE part (g*eta is exact in spectral space)
    ke = 0.5 * (u * u + v * v)
    phi_hat = fwd(ke if split else g * eta + ke)

    dzeta = -(sp.gradx(t, qu_hat) + sp.grady(t, qv_hat)) \
        + nu * sp.laplacian(t, s.zeta_hat)
    if src is not None:
        dzeta = dzeta + fwd(src)
    ddiv = (sp.gradx(t, qv_hat) - sp.grady(t, qu_hat)) \
        - sp.laplacian(t, phi_hat) + nu * sp.laplacian(t, s.div_hat)
    deta = -(sp.gradx(t, eu_hat) + sp.grady(t, ev_hat)) \
        - mean_depth * s.div_hat
    if split:
        # exact linear terms; the nonzero-k factor is where curl_z/div of
        # f*u_vec vanish (mean mode — u derives from gradients of psi/chi)
        fz = f * jnp.where(t.lap != 0.0, 1.0, 0.0)
        dzeta = dzeta - fz * s.div_hat
        ddiv = ddiv + fz * s.zeta_hat - g * sp.laplacian(t, s.eta_hat)
    if r_drag != 0.0:
        dzeta = dzeta - r_drag * s.zeta_hat
        ddiv = ddiv - r_drag * s.div_hat
    if nu4 != 0.0:
        # biharmonic hyperviscosity on the momentum (zeta AND div, like
        # nu; the mass equation untouched — config.py nu4 note)
        l2 = t.lap * t.lap
        dzeta = dzeta - nu4 * l2 * s.zeta_hat
        ddiv = ddiv - nu4 * l2 * s.div_hat
    return SWState(zeta_hat=dzeta, div_hat=ddiv, eta_hat=deta)


def _dealias_state(t: SpectralTables, s: SWState) -> SWState:
    return SWState(*(sp.dealias(t, a) for a in s))


def _axpy(s0: SWState, k: SWState, a: float) -> SWState:
    return SWState(*(x + y * a for x, y in zip(s0, k)))


def rk4_step(t: SpectralTables, s: SWState, src: jax.Array,
             dt: float, f: float, g: float, nu: float, mean_depth: float,
             grid_shape: Tuple[int, int],
             fwd: Callable = fft.forward,
             inv: Callable = fft.inverse,
             inv_pair: Optional[Callable] = None,
             fwd_pair: Optional[Callable] = None,
             r_drag: float = 0.0, nu4: float = 0.0) -> SWState:
    """Classic RK4 with per-stage dealiased tendencies — the same stepping
    contract as the barotropic core (main.cpp:286-317)."""
    d = functools.partial(tendency, t, src=src, f=f, g=g, nu=nu,
                          mean_depth=mean_depth,
                          grid_shape=grid_shape, fwd=fwd, inv=inv,
                          inv_pair=inv_pair, fwd_pair=fwd_pair,
                          r_drag=r_drag, nu4=nu4)
    k1 = _dealias_state(t, d(s))
    k2 = _dealias_state(t, d(_axpy(s, k1, dt * 0.5)))
    k3 = _dealias_state(t, d(_axpy(s, k2, dt * 0.5)))
    k4 = _dealias_state(t, d(_axpy(s, k3, dt)))
    comb = SWState(*(a + 2.0 * b + 2.0 * c + e
                     for a, b, c, e in zip(k1, k2, k3, k4)))
    return _axpy(s, comb, dt / 6.0)


def forward_pair_for(grid_shape, backend: str = "auto"):
    """ops/fft.py:forward_pair where it is used, else None.

    Pairing packs the two flux pairs (qu, qv) and (eta*u, eta*v) into one
    complex fft2 each, so 5 forward transforms per stage become 3 (the
    numerics match rfft2 to float32 round-off,
    tests/test_spectral.py:test_forward_pair_matches_rfft2). It runs on
    the jnp.fft backend up to XFB_FORWARD_PAIR_MAX (default 1024; 0
    disables). That cap was measured on the program's earlier
    accelerator, where pairing won at 1024^2 and lost at 2048^2; it is
    not yet measured on the GPU (ROADMAP S3a).
    """
    import os
    fp_max = int(os.environ.get("XFB_FORWARD_PAIR_MAX", 1024))
    if backend in ("auto", "xla") and max(grid_shape) <= fp_max:
        return fft.forward_pair
    return None


def max_stable_dt(cfg) -> float:
    """RK4 gravity-wave stability bound: the fastest linear mode is the
    corner gravity wave omega_max = sqrt(g*H) * k_max with
    k_max = pi*hypot(nx/lx, ny/ly) (positive-Nyquist convention,
    SURVEY.md §5.3); RK4's imaginary-axis limit is |omega*dt| <= 2*sqrt(2).
    Returns that bound with a 0.9 safety factor. The reference never hit
    this (its SW driver integrates barotropic dynamics, SURVEY.md C6);
    the real SW system here does: dt=3 s is stable at 768^2 but NaNs at
    4096^2 (measured) — this is the resolution-dependent physics bound,
    not an implementation artifact."""
    import math

    c = math.sqrt(float(cfg.gravity) * float(cfg.mean_depth))
    k_max = math.pi * math.hypot(cfg.nx / float(cfg.lx),
                                 cfg.ny / float(cfg.ly))
    return 0.9 * 2.0 * math.sqrt(2.0) / (c * k_max)


class SWStats(NamedTuple):
    """Conserved / monitoring scalars.

    mass is exactly conserved by the flux-form mass equation (the mean mode
    of -div(hu) is zero); total energy 0.5*h*(u^2+v^2) + 0.5*g*h^2 and
    potential enstrophy 0.5*h*q_pot^2 (q_pot=(zeta+f)/h) are conserved by
    the continuous equations — drift measures the discretization.
    """
    mass: jax.Array
    energy: jax.Array
    pot_enstrophy: jax.Array
    max_abs_div: jax.Array
    cfl: jax.Array


@dataclasses.dataclass(frozen=True)
class ShallowWaterModel:
    """Compiled stepper bundle, mirroring BarotropicModel's API."""

    cfg: ModelConfig
    tables: SpectralTables
    step: Callable
    segment: Callable
    diags: Callable
    stats: Callable
    debug: Optional[Callable] = None   # state, src -> DebugFields

    @classmethod
    def build(cls, cfg: ModelConfig,
              tables: Optional[SpectralTables] = None) -> "ShallowWaterModel":
        """Compiled SW stepper bundle; warns when dt violates the
        gravity-wave CFL bound (see max_stable_dt)."""
        t = tables if tables is not None else SpectralTables.from_config(cfg)
        g_shape = cfg.grid_shape
        dt, nu = float(cfg.dt), float(cfg.nu)
        f, grav = float(cfg.f), float(cfg.gravity)
        if float(cfg.beta) != 0.0:
            raise NotImplementedError(
                "beta-plane is barotropic/tracer-only: the SW equations "
                "need the spatially varying f inside curl(f u)/div(f u) "
                "(config.py beta note)")

        H = float(cfg.mean_depth)

        etd = cfg.time_scheme == "etdrk4"
        dt_max = max_stable_dt(cfg)
        if dt > dt_max and not etd:
            import warnings
            warnings.warn(
                f"SW gravity-wave CFL violated: dt={dt:g} s exceeds the "
                f"RK4 stability bound {dt_max:.3g} s for c=sqrt(gH)="
                f"{(grav * H) ** 0.5:.1f} m/s at {cfg.nx}x{cfg.ny} — the "
                "run will blow up; reduce dt (verified NaN at 4096^2 "
                "with dt=3), or use --time-scheme etdrk4 (exact linear "
                "waves; only the advective CFL remains)", stacklevel=2)

        from .barotropic import resolve_fft_backend
        fwd, inv, inv_pair = resolve_fft_backend(cfg.fft_backend)
        fwd_pair = forward_pair_for(g_shape, cfg.fft_backend)
        r_drag = float(cfg.r_drag)
        nu4 = float(cfg.nu4)

        # Tables are jit ARGUMENTS bound via partial, not closure constants
        # (see the models/barotropic.py build note).
        if etd:
            # ETDRK4 (models/etdrk4.py): exact linear propagation via
            # per-mode 3x3 phi-tables; N is the split-linear nonlinear
            # tendency. Tables ride as jit ARGUMENTS.
            from . import etdrk4 as etd_mod
            # disk-cached: rebuilding the 4096^2 tables costs minutes
            # per process; a warm start mmap-loads instead
            etabs = etd_mod.build_tables_cached(cfg, dt)

            @jax.jit
            def estep_(et, t, s: SWState, src):
                return etd_mod.etdrk4_step(
                    t, et, s, src, g_shape, fwd=fwd, inv=inv,
                    inv_pair=inv_pair, fwd_pair=fwd_pair)

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def esegment_(et, t, s: SWState, src, n_steps: int):
                def body(state, _):
                    return etd_mod.etdrk4_step(
                        t, et, state, src, g_shape, fwd=fwd,
                        inv=inv, inv_pair=inv_pair,
                        fwd_pair=fwd_pair), None
                out, _ = jax.lax.scan(body, s, None, length=n_steps)
                return out

            step_ = functools.partial(estep_, etabs)
            segment_ = functools.partial(esegment_, etabs)
        else:
            @jax.jit
            def step_(t, s: SWState, src):
                return rk4_step(t, s, src, dt, f, grav, nu, H, g_shape,
                                fwd=fwd, inv=inv, inv_pair=inv_pair,
                                fwd_pair=fwd_pair,
                                r_drag=r_drag, nu4=nu4)

            @functools.partial(jax.jit, static_argnames=("n_steps",))
            def segment_(t, s: SWState, src, n_steps: int):
                def body(state, _):
                    return rk4_step(t, state, src, dt, f, grav, nu, H,
                                    g_shape, fwd=fwd, inv=inv,
                                    inv_pair=inv_pair,
                                    fwd_pair=fwd_pair,
                                    r_drag=r_drag, nu4=nu4), None
                out, _ = jax.lax.scan(body, s, None, length=n_steps)
                return out

        @jax.jit
        def diags_(t, s: SWState) -> SWDiagFields:
            u_hat, v_hat = sw_velocities(t, s.zeta_hat, s.div_hat)
            psi_hat = sp.invert_laplacian(t, s.zeta_hat)
            return SWDiagFields(
                vort=fft.inverse(s.zeta_hat, g_shape),
                div=fft.inverse(s.div_hat, g_shape),
                h=cfg.mean_depth + fft.inverse(s.eta_hat, g_shape),
                u=fft.inverse(u_hat, g_shape),
                v=fft.inverse(v_hat, g_shape),
                psi=fft.inverse(psi_hat, g_shape),
            )

        @jax.jit
        def stats_(t, s: SWState) -> SWStats:
            d = diags_(t, s)
            q_pot = (d.vort + f) / d.h
            ke = 0.5 * d.h * (d.u * d.u + d.v * d.v)
            pe = 0.5 * grav * d.h * d.h
            return SWStats(
                mass=jnp.mean(d.h),
                energy=jnp.mean(ke + pe),
                pot_enstrophy=jnp.mean(0.5 * d.h * q_pot * q_pot),
                max_abs_div=jnp.max(jnp.abs(d.div)),
                cfl=jnp.max(jnp.abs(d.u) / cfg.dx + jnp.abs(d.v) / cfg.dy)
                * dt,
            )

        @jax.jit
        def debug_(t, s: SWState, src):
            # reference debug-dump analogue (main.cpp:156-176, 216-222):
            # physical zeta gradients at step start; dvortdt is this
            # model's FULL vorticity tendency (flux form + viscosity +
            # source) inverse-transformed — the SW equations have no
            # bare-advection stage to dump, so the tendency itself is the
            # honest counterpart (documented deviation).
            from .barotropic import DebugFields
            dvdx = fft.inverse(sp.gradx(t, s.zeta_hat), g_shape)
            dvdy = fft.inverse(sp.grady(t, s.zeta_hat), g_shape)
            dz = tendency(t, s, src, f, grav, nu, H, g_shape,
                          r_drag=r_drag).zeta_hat
            return DebugFields(dvortdx=dvdx, dvortdy=dvdy,
                               dvortdt=fft.inverse(dz, g_shape))

        def segment(s, src, n_steps: int):
            return segment_(t, s, src, n_steps)

        return cls(cfg=cfg, tables=t,
                   step=functools.partial(step_, t),
                   segment=segment,
                   diags=functools.partial(diags_, t),
                   stats=functools.partial(stats_, t),
                   debug=functools.partial(debug_, t))

    # ----- state construction -----
    def init_state(self, vort0, div0=None, h0=None) -> SWState:
        """Physical fields -> spectral state. Defaults: no divergence,
        flat depth cfg.mean_depth. h0 (if given) is the FULL depth; the
        prognostic variable is the perturbation h0 - mean_depth."""
        cfg = self.cfg
        z = jnp.asarray(vort0, jnp.float32)
        d = (jnp.zeros(cfg.grid_shape, jnp.float32) if div0 is None
             else jnp.asarray(div0, jnp.float32))
        eta = (jnp.zeros(cfg.grid_shape, jnp.float32) if h0 is None
               else jnp.asarray(h0, jnp.float32) - cfg.mean_depth)
        return SWState(zeta_hat=fft.forward(z), div_hat=fft.forward(d),
                       eta_hat=fft.forward(eta))

    def geostrophic_init(self, vort0) -> SWState:
        """Balanced IC: given zeta, set delta=0 and the height in gradient-
        wind-free geostrophic balance g*grad(eta) = -f ẑ×u, i.e.
        eta_hat = (f/g) * psi_hat, which eliminates the fast gravity-wave
        transient for small Rossby number."""
        cfg = self.cfg
        # whole init under jit, mean mode zeroed by a mask multiply;
        # tables passed as arguments, not closure constants.
        import numpy as np
        mean_mask = np.ones(cfg.spectral_shape, np.float32)
        mean_mask[0, 0] = 0.0
        fg = float(cfg.f) / float(cfg.gravity)

        @jax.jit
        def init(t, v, mask):
            zeta_hat = fft.forward(v)
            psi_hat = sp.invert_laplacian(t, zeta_hat)
            return SWState(zeta_hat=zeta_hat,
                           div_hat=jnp.zeros_like(zeta_hat),
                           eta_hat=fg * psi_hat * mask)

        return init(self.tables, jnp.asarray(vort0, jnp.float32),
                    jnp.asarray(mean_mask))

    def zero_source(self) -> jax.Array:
        return jnp.zeros(self.cfg.grid_shape, jnp.float32)
