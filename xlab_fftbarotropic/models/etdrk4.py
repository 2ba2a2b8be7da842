"""ETDRK4 exponential time integrator for the shallow-water family.

Capability with no reference counterpart (the reference integrates
everything with explicit RK4, main.cpp:286-317, and only ever promised a
shallow-water solver, TODO.md:5): the rotating-SW linear operator —
Coriolis, gravity-wave coupling, mass divergence, viscosity/drag — is a
REAL 3x3 matrix per spectral mode acting on (zeta, div, eta):

    L(k) = [[ a , -f',   0    ],        a  = nu*lap - r_drag - nu4*lap^2
            [ f',  a , -g*lap ],        f' = f  (0 at the mean mode)
            [ 0 , -H ,   0    ]]        lap = -(kx^2 + ky^2)

so its matrix exponential and the ETDRK4 phi-functions precompute to
per-mode 3x3 coefficient tables, and the integrator treats the ENTIRE
linear dynamics exactly at any dt. Stability is then limited only by the
advective CFL of the nonlinear terms — not the gravity-wave bound
sqrt(gH)*k_max that caps classic RK4 at 0.847 s on the 4096^2 default
domain (models/shallow_water.py:max_stable_dt) while the advective limit
sits an order of magnitude higher for met-scale winds.

This is the Cox & Mathews (2002) ETDRK4 scheme in the Kassam &
Trefethen (2005) coefficient form, generalized from their scalar
diagonal L to the per-mode 3x3 block diagonal:

    an    = E2 u + Q N(u)
    bn    = E2 u + Q N(an)
    cn    = E2 an + Q (2 N(bn) - N(u))
    u_new = E u + F1 N(u) + F2 (N(an)+N(bn)) + F3 N(cn)

with E = exp(L dt), E2 = exp(L dt/2), Q = dt phi1(L dt/2) and
F1 = dt (phi1 - 3 phi2 + 4 phi3), F2 = dt (2 phi2 - 4 phi3),
F3 = dt (4 phi3 - phi2), all evaluated at L dt. In the L -> 0 limit the
weights reduce to classic RK4 (1/6, 1/3, 1/3, 1/6), and the nonlinear
tendency N is the existing split-linear SW tendency with every linear
coefficient zeroed (models/shallow_water.py:tendency with
f=g=nu=H=r=nu4=0, split=True) — the split-linear refactoring already
isolates exactly the part ETDRK4 needs, transforms included.

Table construction is vectorized host-side numpy in float64: a scaled
Taylor series for (exp, phi1, phi2, phi3) at L dt / 2^s with
||L dt||/2^s <= 1/4, then s applications of the exact doubling
identities

    exp(2A)  = E^2
    phi1(2A) = (E + I) phi1 / 2
    phi2(2A) = (phi1^2 + 2 phi2) / 4
    phi3(2A) = (phi2 (phi1 + I) + 2 phi3) / 8

(all products commute — polynomials in the same A). This is robust at
the defective/critically-damped modes where an eigendecomposition
degenerates, and handles the nilpotent mean-mode block (eta' = -H div)
exactly.

Dealiasing contract: RK4 dealiases the TENDENCY, never the state
(SURVEY.md section 5.6), so above-cutoff state modes stay exactly
frozen. To keep that contract, E and E2 are blended to the identity
outside the dealias mask and the phi-coefficient tables (Q, F1..F3) are
zeroed there; N is dealiased per stage like every other path.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from ..ops.spectral import SpectralTables
from . import shallow_water as swm


class SWEtdTables(NamedTuple):
    """Per-mode 3x3 coefficient tables, each (3, 3, nx, hny) float32.

    Q and F1..F3 carry the dt factor already. Passed to the jitted step
    as ARGUMENTS, not closure constants (models/barotropic.py build
    note)."""
    E: jax.Array
    E2: jax.Array
    Q: jax.Array
    F1: jax.Array
    F2: jax.Array
    F3: jax.Array


def _host_lap_mask(cfg: ModelConfig, hpad: int = 0):
    """(lap, mask) as float64 HOST arrays, recomputed from the config
    rather than copied back from the device tables. hpad > hny pads
    columns like
    parallel/pencil.py:pad_tables (lap -> 0, mask -> 0: pad modes get
    identity propagators and zero tendency weights, so sharded padded
    states stay exactly zero there)."""
    from ..ops import spectral as sp
    kx = sp.wavenumbers_x(cfg.nx, cfg.lx)
    ky = sp.wavenumbers_y(cfg.ny, cfg.ly)
    lap = -(np.asarray(kx, np.float64)[:, None] ** 2
            + np.asarray(ky, np.float64)[None, :] ** 2)
    mask = np.asarray(
        sp.dealias_mask(cfg.nx, cfg.ny, cfg.dealias_rule), np.float64)
    hny = lap.shape[1]
    if hpad and hpad > hny:
        pad = ((0, 0), (0, hpad - hny))
        lap = np.pad(lap, pad)
        mask = np.pad(mask, pad)
    return lap, mask


def sw_linear_matrix(cfg: ModelConfig, hpad: int = 0) -> np.ndarray:
    """The per-mode linear operator L as an (nx, hny[, +pad], 3, 3)
    float64 array, matching the split-linear terms of
    models/shallow_water.py:tendency exactly (f masked at the mean
    mode the way the fz factor is)."""
    lap, _ = _host_lap_mask(cfg, hpad)
    f = float(cfg.f)
    fz = np.where(lap != 0.0, f, 0.0)
    a = (float(cfg.nu) * lap - float(cfg.r_drag)
         - float(cfg.nu4) * lap * lap)
    g = float(cfg.gravity)
    H = float(cfg.mean_depth)
    nx, hny = lap.shape
    L = np.zeros((nx, hny, 3, 3), np.float64)
    L[..., 0, 0] = a
    L[..., 0, 1] = -fz
    L[..., 1, 0] = fz
    L[..., 1, 1] = a
    L[..., 1, 2] = -g * lap
    L[..., 2, 1] = -H
    return L


def _phi_series(T: np.ndarray, terms: int = 24):
    """(E, phi1, phi2, phi3) of small-norm batched matrices T by Taylor
    series: phi_j = sum_{k>=0} T^k / (k+j)!."""
    eye = np.broadcast_to(np.eye(3), T.shape).copy()
    acc = [eye.copy(), eye.copy() / 1.0, eye.copy() / 2.0,
           eye.copy() / 6.0]
    # phi_j leading coefficients: 1/j! ; term k adds T^k/(k+j)!
    P = eye.copy()
    fact = [1.0, 1.0, 2.0, 6.0]
    kfact = 1.0
    for k in range(1, terms + 1):
        P = P @ T
        kfact *= k
        # (k+j)! = kfact * prod_{i=1..j} (k+i)
        d0 = kfact
        d1 = d0 * (k + 1)
        d2 = d1 * (k + 2)
        d3 = d2 * (k + 3)
        acc[0] += P / d0
        acc[1] += P / d1
        acc[2] += P / d2
        acc[3] += P / d3
    del fact
    return acc


def _phi_functions(A: np.ndarray):
    """(exp(A), phi1(A), phi2(A), phi3(A)) for batched (..., 3, 3)
    float64 A by scaling (series at A/2^s) + the doubling identities."""
    # max row-sum norm over the batch decides the scaling
    norm = float(np.max(np.sum(np.abs(A), axis=-1))) if A.size else 0.0
    s = max(0, int(np.ceil(np.log2(max(norm, 1e-300) / 0.25))))
    E, p1, p2, p3 = _phi_series(A / (2.0 ** s))
    eye = np.broadcast_to(np.eye(3), A.shape)
    for _ in range(s):
        p3 = (p2 @ (p1 + eye) + 2.0 * p3) / 8.0
        p2 = (p1 @ p1 + 2.0 * p2) / 4.0
        p1 = (E + eye) @ p1 / 2.0
        E = E @ E
    return E, p1, p2, p3


_TABLE_NAMES = ("E", "E2", "Q", "F1", "F2", "F3")


def _build_tables_host(cfg: ModelConfig, dt: float, row_chunk: int = 256,
                       hpad: int = 0) -> np.ndarray:
    """The six ETDRK4 coefficient tables as ONE host float32 stack
    (6, 3, 3, nx, hny[pad]) in (E, E2, Q, F1, F2, F3) order — host
    numpy float64 math, chunked over spectral rows to bound memory at
    4096^2; everything derives from the config on host (see
    _host_lap_mask). Split from build_tables so the disk cache
    (build_tables_cached) can persist the stack before the device
    upload, with no copy back from the device."""
    L = sw_linear_matrix(cfg, hpad)
    mask = _host_lap_mask(cfg, hpad)[1][..., None, None]
    nx = L.shape[0]
    eye = np.eye(3)
    outs = {k: np.empty(L.shape, np.float32) for k in _TABLE_NAMES}
    for i0 in range(0, nx, row_chunk):
        sl = slice(i0, min(i0 + row_chunk, nx))
        A = L[sl] * dt
        m = mask[sl]
        E, p1, p2, p3 = _phi_functions(A)
        E2, q1, _, _ = _phi_functions(A * 0.5)
        # dealias contract: identity outside the mask for the state
        # propagators, zero for the tendency-weight tables
        outs["E"][sl] = (m * E + (1.0 - m) * eye).astype(np.float32)
        outs["E2"][sl] = (m * E2 + (1.0 - m) * eye).astype(np.float32)
        outs["Q"][sl] = (m * dt * 0.5 * q1).astype(np.float32)
        outs["F1"][sl] = (m * dt * (p1 - 3.0 * p2 + 4.0 * p3)
                          ).astype(np.float32)
        outs["F2"][sl] = (m * dt * (2.0 * p2 - 4.0 * p3)
                          ).astype(np.float32)
        outs["F3"][sl] = (m * dt * (4.0 * p3 - p2)).astype(np.float32)
    # (nx, hny, 3, 3) -> (3, 3, nx, hny): the matvec reads 9 plane
    # slices; leading matrix axes keep each plane contiguous
    return np.stack([np.moveaxis(outs[k], (-2, -1), (0, 1))
                     for k in _TABLE_NAMES])


def build_tables(cfg: ModelConfig, dt: float, row_chunk: int = 256,
                 hpad: int = 0) -> SWEtdTables:
    """Precompute the six ETDRK4 coefficient tables (module docstring)
    and upload them. Prefer build_tables_cached for model builds — at
    4096^2 the host build costs minutes per process and the tables are
    a pure function of (config numerics, dt, hpad)."""
    return SWEtdTables(*(jnp.asarray(a)
                         for a in _build_tables_host(cfg, dt, row_chunk,
                                                     hpad)))


# ---------------------------------------------------------------------------
# Disk cache for the phi tables. The tables are a pure deterministic
# function of (linear-operator config fields, dt, hpad) — at 4096^2
# rebuilding them costs minutes of host float64 math per process,
# which every restart,
# A/B process and bench run would otherwise pay. Keyed by an explicit
# field hash (NOT cfg.config_hash(): that also covers total_steps /
# time_scheme etc. whose change must not invalidate the tables); saved
# as one raw .npy stack next to the checkpoints (atomic tmp+rename)
# and mmap-loaded, so a warm start uploads without re-deriving.
# XFB_ETD_CACHE: unset -> <output_dir>/etd_cache; a path -> that dir;
# '0'/'' -> disabled.
# ---------------------------------------------------------------------------

# fields of ModelConfig that enter each family's linear operator
_SW_L_FIELDS = ("nx", "ny", "lx", "ly", "f", "nu", "r_drag", "nu4",
                "gravity", "mean_depth", "dealias_rule")
_BT_L_FIELDS = ("nx", "ny", "lx", "ly", "nu", "r_drag", "nu4", "beta",
                "dealias_rule")


def tables_cache_key(cfg: ModelConfig, dt: float, hpad: int = 0,
                     kind: str = "sw", kappa: float = 0.0) -> str:
    import hashlib
    import json
    fields = _SW_L_FIELDS if kind == "sw" else _BT_L_FIELDS
    d = {k: getattr(cfg, k) for k in fields}
    d.update(dt=float(dt), hpad=int(hpad), kind=kind, version=1)
    if kind == "tracer":
        d["kappa"] = float(kappa)
    return hashlib.sha256(
        json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]


def _cache_dir(cfg: ModelConfig):
    import os
    from pathlib import Path
    env = os.environ.get("XFB_ETD_CACHE")
    if env is not None:
        return None if env in ("", "0") else Path(env)
    return Path(cfg.output_dir) / "etd_cache"


def _cached_stack(cfg: ModelConfig, path_stem: str, builder):
    """Load the table stack from the cache file, or build + save it.
    Returns a numpy (or memmap) array; save failures degrade to a
    warning (the tables themselves are already in hand)."""
    d = _cache_dir(cfg)
    if d is None:
        return builder()
    path = d / f"{path_stem}.npy"
    if path.exists():
        return np.load(path, mmap_mode="r")
    stack = builder()
    try:
        import os
        import tempfile
        d.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npy")
        os.close(fd)
        np.save(tmp, stack)   # .npy suffix -> saved in place
        os.replace(tmp, path)
    except OSError as e:           # disk full / read-only cache dir
        import warnings
        warnings.warn(f"ETD table cache save failed ({e}); continuing "
                      "with the freshly built tables", stacklevel=2)
    return stack


def build_tables_cached(cfg: ModelConfig, dt: float,
                        row_chunk: int = 256,
                        hpad: int = 0) -> SWEtdTables:
    """build_tables through the disk cache: a second process with the
    same (config numerics, dt, hpad) loads the 1.8 GB 4096^2 stack in
    seconds instead of re-deriving it for minutes."""
    key = tables_cache_key(cfg, dt, hpad, kind="sw")
    stack = _cached_stack(
        cfg, f"sw_etd_{key}",
        lambda: _build_tables_host(cfg, dt, row_chunk, hpad))
    return SWEtdTables(*(jnp.asarray(stack[i]) for i in range(6)))


def _matvec(T: jax.Array, s: "swm.SWState") -> "swm.SWState":
    """Apply the per-mode real 3x3 table to the complex state vector."""
    z, d, e = s.zeta_hat, s.div_hat, s.eta_hat
    return swm.SWState(
        zeta_hat=T[0, 0] * z + T[0, 1] * d + T[0, 2] * e,
        div_hat=T[1, 0] * z + T[1, 1] * d + T[1, 2] * e,
        eta_hat=T[2, 0] * z + T[2, 1] * d + T[2, 2] * e)


def _add(a: "swm.SWState", b: "swm.SWState") -> "swm.SWState":
    return swm.SWState(*(x + y for x, y in zip(a, b)))


def etdrk4_step(t: SpectralTables, tabs: SWEtdTables, s: "swm.SWState",
                src, grid_shape: Tuple[int, int],
                fwd=None, inv=None, inv_pair=None,
                fwd_pair=None) -> "swm.SWState":
    """One ETDRK4 step (module docstring). N = the nonlinear-only SW
    tendency: shallow_water.tendency with every linear coefficient
    zeroed and split=True (the split-linear refactoring isolates
    exactly the nonlinear fluxes), dealiased per stage like RK4."""
    kw = {}
    if fwd is not None:
        kw["fwd"] = fwd
    if inv is not None:
        kw["inv"] = inv

    def N(state):
        d = swm.tendency(t, state, src, f=0.0, g=0.0, nu=0.0,
                         mean_depth=0.0, grid_shape=grid_shape,
                         inv_pair=inv_pair, fwd_pair=fwd_pair,
                         split=True, **kw)
        return swm._dealias_state(t, d)

    n1 = N(s)
    e2u = _matvec(tabs.E2, s)
    an = _add(e2u, _matvec(tabs.Q, n1))
    n2 = N(an)
    bn = _add(e2u, _matvec(tabs.Q, n2))
    n3 = N(bn)
    cn = _add(_matvec(tabs.E2, an),
              _matvec(tabs.Q, swm.SWState(*(2.0 * x - y for x, y
                                            in zip(n3, n1)))))
    n4 = N(cn)
    out = _add(_matvec(tabs.E, s), _matvec(tabs.F1, n1))
    out = _add(out, _matvec(tabs.F2, _add(n2, n3)))
    return _add(out, _matvec(tabs.F3, n4))


# ---------------------------------------------------------------------------
# Scalar families (barotropic, tracer): the linear operator of the
# barotropic vorticity equation — and of the tracer's diffusion — is a
# per-mode SCALAR,
#
#     L(k) = nu*lap - r_drag - nu4*lap^2  [+ i*beta*kx/ lap]   (flow)
#     L(k) = kappa*lap                                          (tracer q)
#
# (lap = -(kx^2+ky^2); the beta-Rossby term is the linearization of
# -beta*v with v_hat = i*kx*rlap*zeta_hat, so exponential integration
# makes Rossby dispersion EXACT), i.e. the 3x3 machinery above
# collapses to 1x1: phi tables are plane-shaped elementwise
# multipliers, real float32 on the f-plane and complex64 under beta.
# This removes the nu/nu4 stiffness bound on dt (RK4's real-axis limit
# |L|dt <= 2.785 binds hard for hyperviscous high-resolution runs) and
# leaves only the advective CFL, exactly like the SW case. N is the
# existing advection-only tendency (models/barotropic.py:tendency with
# nu=r=nu4=beta=0), dealiased per stage; the dealias contract carries
# over via the same identity-outside-mask blending as the SW tables.
# No reference counterpart (the reference is RK4-only,
# /root/reference/src/main.cpp:288-317).
# ---------------------------------------------------------------------------


class ScalarEtdTables(NamedTuple):
    """Per-mode scalar ETDRK4 tables: each (nx, hny[pad]) for the
    barotropic family or (2, nx, hny[pad]) stacked (flow, tracer) for
    the tracer family; float32, or complex64 when beta != 0. Q/F1..F3
    carry the dt factor. Passed to jitted steps as ARGUMENTS."""
    E: jax.Array
    E2: jax.Array
    Q: jax.Array
    F1: jax.Array
    F2: jax.Array
    F3: jax.Array


def scalar_linear_operator(cfg: ModelConfig, kind: str = "barotropic",
                           kappa: float = 0.0,
                           hpad: int = 0) -> np.ndarray:
    """Host float64/complex128 per-mode linear operator: (nx, hny) for
    'barotropic', (2, nx, hny) stacked (flow, q) for 'tracer' —
    matching the linear terms of models/barotropic.py:tendency /
    models/tracer.py:tendency exactly (positive-Nyquist gradients,
    multiply-form inverse Laplacian with mean-mode passthrough)."""
    lap, _ = _host_lap_mask(cfg, hpad)
    a = (float(cfg.nu) * lap - float(cfg.r_drag)
         - float(cfg.nu4) * lap * lap)
    beta = float(cfg.beta)
    if beta != 0.0:
        from ..ops import spectral as sp
        kx = np.asarray(sp.wavenumbers_x(cfg.nx, cfg.lx), np.float64)
        # multiply-form inversion: psi = rlap * Z, rlap(0,0) = 1
        # (irrelevant to the beta term — kx = 0 there)
        rlap = np.where(lap != 0.0, 1.0 / np.where(lap != 0.0, lap, 1.0),
                        1.0)
        # -beta*v folds to -i*beta*kx*rlap in spectral space
        a = a.astype(np.complex128) - 1j * beta * kx[:, None] * rlap
    if kind == "barotropic":
        return a
    if kind == "tracer":
        lq = float(kappa) * lap
        return np.stack([a, lq.astype(a.dtype)])
    raise ValueError(f"unknown scalar ETD kind {kind!r}")


def _phi_series_scalar(T: np.ndarray, terms: int = 24):
    """Scalar twin of _phi_series: elementwise Taylor accumulation."""
    one = np.ones_like(T)
    acc = [one.copy(), one.copy(), one / 2.0, one / 6.0]
    P = one.copy()
    kfact = 1.0
    for k in range(1, terms + 1):
        P = P * T
        kfact *= k
        d0 = kfact
        d1 = d0 * (k + 1)
        d2 = d1 * (k + 2)
        d3 = d2 * (k + 3)
        acc[0] += P / d0
        acc[1] += P / d1
        acc[2] += P / d2
        acc[3] += P / d3
    return acc


def _phi_functions_scalar(A: np.ndarray):
    """(exp, phi1, phi2, phi3) of a float64/complex128 array by the
    same scaling + doubling scheme as the 3x3 path (robust at z = 0
    where the closed forms (e^z-1)/z ... cancel catastrophically)."""
    norm = float(np.max(np.abs(A))) if A.size else 0.0
    s = max(0, int(np.ceil(np.log2(max(norm, 1e-300) / 0.25))))
    E, p1, p2, p3 = _phi_series_scalar(A / (2.0 ** s))
    for _ in range(s):
        p3 = (p2 * (p1 + 1.0) + 2.0 * p3) / 8.0
        p2 = (p1 * p1 + 2.0 * p2) / 4.0
        p1 = (E + 1.0) * p1 / 2.0
        E = E * E
    return E, p1, p2, p3


def _build_scalar_tables_host(cfg: ModelConfig, dt: float,
                              kind: str = "barotropic",
                              kappa: float = 0.0, row_chunk: int = 1024,
                              hpad: int = 0) -> np.ndarray:
    """One host stack (6, [F,] nx, hny[pad]) in _TABLE_NAMES order;
    float32, or complex64 when the operator is complex (beta != 0)."""
    L = scalar_linear_operator(cfg, kind, kappa, hpad)
    mask = _host_lap_mask(cfg, hpad)[1]
    out_dtype = np.complex64 if np.iscomplexobj(L) else np.float32
    outs = np.empty((6,) + L.shape, out_dtype)
    nx = L.shape[-2]
    for i0 in range(0, nx, row_chunk):
        rows = slice(i0, min(i0 + row_chunk, nx))
        A = L[..., rows, :] * dt
        m = mask[rows]
        E, p1, p2, p3 = _phi_functions_scalar(A)
        E2, q1, _, _ = _phi_functions_scalar(A * 0.5)
        outs[0][..., rows, :] = (m * E + (1.0 - m)).astype(out_dtype)
        outs[1][..., rows, :] = (m * E2 + (1.0 - m)).astype(out_dtype)
        outs[2][..., rows, :] = (m * dt * 0.5 * q1).astype(out_dtype)
        outs[3][..., rows, :] = (m * dt * (p1 - 3.0 * p2 + 4.0 * p3)
                                 ).astype(out_dtype)
        outs[4][..., rows, :] = (m * dt * (2.0 * p2 - 4.0 * p3)
                                 ).astype(out_dtype)
        outs[5][..., rows, :] = (m * dt * (4.0 * p3 - p2)
                                 ).astype(out_dtype)
    return outs


def build_scalar_tables(cfg: ModelConfig, dt: float,
                        kind: str = "barotropic", kappa: float = 0.0,
                        hpad: int = 0,
                        cached: bool = True) -> ScalarEtdTables:
    """Scalar-family ETDRK4 tables, through the same disk cache as the
    SW 3x3 tables (cached=False forces a fresh host build)."""
    if cached:
        key = tables_cache_key(cfg, dt, hpad, kind=kind, kappa=kappa)
        stack = _cached_stack(
            cfg, f"{kind}_etd_{key}",
            lambda: _build_scalar_tables_host(cfg, dt, kind, kappa,
                                              hpad=hpad))
    else:
        stack = _build_scalar_tables_host(cfg, dt, kind, kappa,
                                          hpad=hpad)
    return ScalarEtdTables(*(jnp.asarray(stack[i]) for i in range(6)))


def etd_scheme(N, mul, tabs, u):
    """The ETDRK4 update (module docstring) generically over pytree
    states: N maps state -> dealiased nonlinear tendency, mul applies
    one coefficient table to a state pytree. Shared by the scalar
    families (and equivalent to etdrk4_step's inlined SW algebra)."""
    tm = jax.tree_util.tree_map
    add = lambda a, b: tm(lambda x, y: x + y, a, b)           # noqa: E731
    two_minus = lambda a, b: tm(lambda x, y: 2.0 * x - y, a, b)  # noqa: E731
    n1 = N(u)
    e2u = mul(tabs.E2, u)
    an = add(e2u, mul(tabs.Q, n1))
    n2 = N(an)
    bn = add(e2u, mul(tabs.Q, n2))
    n3 = N(bn)
    cn = add(mul(tabs.E2, an), mul(tabs.Q, two_minus(n3, n1)))
    n4 = N(cn)
    out = add(mul(tabs.E, u), mul(tabs.F1, n1))
    out = add(out, mul(tabs.F2, add(n2, n3)))
    return add(out, mul(tabs.F3, n4))


def max_advective_dt(cfg: ModelConfig, u_max: float) -> float:
    """Advective stability estimate for ETDRK4 (the linear waves are
    exact, so this is the only CFL left): |u|_max * k_max * dt <= 2.8
    (the RK4 imaginary-axis bound, same constant class as the
    gravity-wave bound it replaces)."""
    import math
    kx_max = math.pi * cfg.nx / cfg.lx
    ky_max = math.pi * cfg.ny / cfg.ly
    k_max = math.hypot(kx_max, ky_max)
    return 2.8 / max(u_max * k_max, 1e-30)
