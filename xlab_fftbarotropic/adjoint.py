"""Differentiable simulation: adjoint gradients through the RK4 rollout.

New capability with no reference counterpart (the C++/FFTW binaries are
forward-only): because every stepper in this framework is a pure jittable
function of its inputs, the whole time integration is differentiable with
`jax.grad`. That turns the model into an inverse-problem engine — 4DVar-
style initial-condition estimation, forcing (source) inversion, and
sensitivity analysis — at the cost of one extra rollout per gradient.

Memory is the classic adjoint constraint: naive backprop through an
N-step `lax.scan` stores every carried state. `make_rollout` therefore
two-level-checkpoints the scan (outer scan over segments, each inner
segment wrapped in `jax.checkpoint`): the backward pass stores only the
~sqrt(N) outer carries and rematerializes each segment's inner states on
the fly — the standard recursive-checkpointing trade (Griewank's revolve,
one level deep) expressed as two nested scans XLA compiles into one
program.

Differentiation runs on the XLA FFT path (`jnp.fft` has registered
JVP/VJP rules). Gradients are taken with respect to
PHYSICAL-space inputs (real float32 fields): the spectral transform
sits inside the differentiated function, which keeps the cotangents
real and sidesteps complex-holomorphy bookkeeping.

All three single-device model families are supported:

- ``barotropic``: rollout(vort0, src) -> final physical vorticity.
- ``sw``: rollout(vort0, src) -> final physical (zeta, div, eta), from a
  geostrophically balanced IC (models/shallow_water.py:geostrophic_init).
- ``tracer``: rollout((vort0, q0), src) -> final physical (zeta, q).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .config import ModelConfig
from .ops import fft
from .ops import spectral as sp
from .models import barotropic as bt
from .models import shallow_water as sw
from .models import tracer as tr


def _segment_lengths(n_steps: int, segment: Optional[int]) -> Tuple[int, int, int]:
    """Split n_steps into n_outer segments of `segment` steps + remainder.

    Default segment ~ sqrt(n_steps): peak live states during backprop is
    n_outer + segment, minimized at the square root.
    """
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if segment is None:
        segment = max(1, int(round(math.sqrt(n_steps))))
    segment = max(1, min(int(segment), n_steps))
    return segment, n_steps // segment, n_steps % segment


def _checkpointed_scan(step: Callable, state, n_steps: int,
                       segment: Optional[int]):
    """Run `step` n_steps times as outer-scan-over-remat'd-inner-scans."""
    seg, n_outer, rem = _segment_lengths(n_steps, segment)

    def inner(s, length):
        return jax.lax.scan(lambda c, _: (step(c), None), s, None,
                            length=length)[0]

    if n_outer > 0:
        seg_fn = jax.checkpoint(functools.partial(inner, length=seg))
        state = jax.lax.scan(lambda c, _: (seg_fn(c), None), state, None,
                             length=n_outer)[0]
    if rem:
        state = jax.checkpoint(functools.partial(inner, length=rem))(state)
    return state


def make_rollout(cfg: ModelConfig, n_steps: int,
                 model_kind: str = "barotropic",
                 segment: Optional[int] = None,
                 tracer_kappa: float = 0.0) -> Callable:
    """Build a jitted, differentiable n_steps rollout for one model family.

    Returns ``rollout(ic_phys, src)`` mapping physical-space inputs to the
    final physical-space prognostic fields (see module docstring for the
    per-family signatures). `src` is the constant-in-time vorticity source
    in physical space (the forced-run contract: one source held across a
    segment, main.cpp:225-227); pass zeros for a free run. Both arguments
    are differentiable.
    """
    t = sp.SpectralTables.from_config(cfg)
    g = cfg.grid_shape
    dt, nu = float(cfg.dt), float(cfg.nu)
    r_drag = float(cfg.r_drag)
    beta = float(cfg.beta)
    nu4 = float(cfg.nu4)
    if beta != 0.0 and model_kind == "sw":
        raise NotImplementedError("beta-plane is barotropic/tracer-only "
                                  "(config.py beta note)")

    fwd, inv, inv_pair = fft.forward, fft.inverse, fft.inverse_pair

    if model_kind == "barotropic":
        def raw(tables, vort0, src):
            z = fwd(jnp.asarray(vort0, jnp.float32))
            step = lambda zh: bt.rk4_step(tables, zh, src, dt, nu, g,
                                          fwd=fwd, inv=inv,
                                          inv_pair=inv_pair,
                                          r_drag=r_drag, beta=beta,
                                          nu4=nu4)
            z = _checkpointed_scan(step, z, n_steps, segment)
            return inv(z, g)
    elif model_kind == "sw":
        f, grav, H = float(cfg.f), float(cfg.gravity), float(cfg.mean_depth)
        fg = f / grav

        def raw(tables, vort0, src):
            zh = fwd(jnp.asarray(vort0, jnp.float32))
            psi = sp.invert_laplacian(tables, zh)
            eta = fg * psi
            eta = eta.at[0, 0].set(0.0)     # mean mode carries no tilt
            s = sw.SWState(zeta_hat=zh, div_hat=jnp.zeros_like(zh),
                           eta_hat=eta)
            step = lambda st: sw.rk4_step(tables, st, src, dt, f, grav,
                                          nu, H, g, fwd=fwd, inv=inv,
                                          inv_pair=inv_pair,
                                          r_drag=r_drag, nu4=nu4)
            s = _checkpointed_scan(step, s, n_steps, segment)
            return (inv(s.zeta_hat, g), inv(s.div_hat, g),
                    inv(s.eta_hat, g))
    elif model_kind == "tracer":
        kappa = float(tracer_kappa)

        def raw(tables, ic, src):
            vort0, q0 = ic
            s = tr.TracerState(fwd(jnp.asarray(vort0, jnp.float32)),
                               fwd(jnp.asarray(q0, jnp.float32)))
            step = lambda st: tr.rk4_step(tables, st, src, dt, nu, kappa,
                                          g, fwd=fwd, inv=inv,
                                          inv_pair=inv_pair,
                                          r_drag=r_drag, beta=beta,
                                          nu4=nu4)
            s = _checkpointed_scan(step, s, n_steps, segment)
            return inv(s.zeta_hat, g), inv(s.q_hat, g)
    else:
        raise ValueError(f"unknown model_kind {model_kind!r}")

    # tables as a bound jit ARGUMENT (closure constants would be embedded
    # in the executable; models/barotropic.py build note)
    jitted = jax.jit(raw)
    return functools.partial(jitted, t)


def make_sharded_rollout(cfg: ModelConfig, n_steps: int, mesh,
                         axis=None, decomp: str = "slab",
                         segment: Optional[int] = None) -> Callable:
    """Multi-chip differentiable rollout (barotropic family).

    Same contract as make_rollout — ``rollout(vort0, src) -> final
    physical vorticity``, differentiable wrt both physical-space
    arguments — but the whole chain (distributed forward FFT, the
    checkpointed RK4 scan, distributed inverse FFT) runs inside ONE
    shard_map over `mesh` with the chosen decomposition
    (slab/xpencil/pencil, parallel/model.py:_decomp_setup). Backprop
    works because shard_map registers transpose rules for the XLA
    collectives the distributed FFTs are built from (an all_to_all
    transposes to the opposite all_to_all).

    Inputs may be host arrays (jit shards them per the decomposition's
    specs) or pre-sharded global arrays; the output is sharded like the
    physical input.
    """
    from jax.sharding import NamedSharding
    from .parallel import model as pmodel
    try:  # jax >= 0.4.35 exposes shard_map at top level
        shard_map = jax.shard_map
    except AttributeError:
        from jax.experimental.shard_map import shard_map

    if axis is None:
        axis = pmodel.AXIS
    (t, fwd, inv, tspec, sspec, pspec, hpad,
     axis) = pmodel._decomp_setup(cfg, mesh, axis, decomp)
    g = cfg.grid_shape
    dt, nu = float(cfg.dt), float(cfg.nu)
    r_drag = float(cfg.r_drag)
    beta = float(cfg.beta)
    nu4 = float(cfg.nu4)

    def local(tl, vort0, src):
        z = fwd(jnp.asarray(vort0, jnp.float32))
        step = lambda zh: bt.rk4_step(tl, zh, src, dt, nu, g,
                                      fwd=fwd, inv=inv, r_drag=r_drag,
                                      beta=beta, nu4=nu4)
        z = _checkpointed_scan(step, z, n_steps, segment)
        return inv(z, g)

    # check_vma=False: the varying-mesh-axis tracker mistypes the FFT
    # cotangents under transpose (cotangent carries {V:axis}, the primal
    # output doesn't), rejecting an otherwise-correct backward pass; the
    # sharded/single-device gradient differential in tests/test_adjoint.py
    # is the actual correctness gate.
    sm = shard_map(local, mesh=mesh, in_specs=(tspec, pspec, pspec),
                   out_specs=pspec, check_vma=False)
    jitted = jax.jit(sm)

    phys = NamedSharding(mesh, pspec)

    def rollout(vort0, src):
        vort0 = jax.device_put(jnp.asarray(vort0, jnp.float32), phys)
        src = jax.device_put(jnp.asarray(src, jnp.float32), phys)
        return jitted(t, vort0, src)

    return rollout


def final_state_misfit(cfg: ModelConfig, target, n_steps: int,
                       model_kind: str = "barotropic",
                       segment: Optional[int] = None,
                       tracer_kappa: float = 0.0) -> Callable:
    """Build ``loss(ic_phys, src) -> scalar``: ½·mean-square misfit of the
    rollout's final physical field(s) against `target` (same structure as
    the rollout's return). The canonical strong-constraint 4DVar cost with
    a single observation time and identity observation operator.
    """
    roll = make_rollout(cfg, n_steps, model_kind=model_kind,
                        segment=segment, tracer_kappa=tracer_kappa)
    tgt = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), target)

    def loss(ic, src):
        out = roll(ic, src)
        sq = jax.tree_util.tree_map(
            lambda a, b: jnp.mean(jnp.square(a - b)), out, tgt)
        return 0.5 * jnp.sum(
            jnp.stack(jax.tree_util.tree_leaves(sq)))

    return loss


def loss_and_grad(loss: Callable, wrt: str = "ic") -> Callable:
    """``(ic, src) -> (loss, grad)`` for a loss from final_state_misfit.

    `wrt` selects the control variable: "ic", "src", or "both"
    (returning a (grad_ic, grad_src) tuple).
    """
    argnums = {"ic": 0, "src": 1, "both": (0, 1)}[wrt]
    return jax.jit(jax.value_and_grad(loss, argnums=argnums))


def fit_initial_condition(cfg: ModelConfig, target, n_steps: int,
                          ic0, src=None,
                          model_kind: str = "barotropic",
                          iters: int = 100, learning_rate: float = 0.2,
                          segment: Optional[int] = None,
                          tracer_kappa: float = 0.0,
                          normalize_cost: bool = True):
    """4DVar-style IC estimation: adam on the final-state misfit.

    Starting from first guess `ic0`, minimize final_state_misfit wrt the
    physical initial condition with optax.adam. Returns
    ``(ic_opt, losses)`` where losses is the per-iteration cost history
    (numpy array, length iters+1 including the initial cost), always in
    PHYSICAL (unnormalized) cost units.

    normalize_cost (default on) descends the cost divided by its value
    at the first guess. The mean-square misfit scales per-element
    gradients by 1/N, so at large grids with small-amplitude fields
    (the reference's 1e-3 gaussian at 4096² gives ~1e-10 gradients)
    raw adam is swamped by its eps=1e-8 and the fit silently stalls.
    Normalization makes the optimizer scale-free: the adam
    update magnitude is ~learning_rate in IC units regardless of grid
    size or field amplitude.
    """
    import numpy as np
    import optax

    if src is None:
        src = jnp.zeros(cfg.grid_shape, jnp.float32)
    loss = final_state_misfit(cfg, target, n_steps, model_kind=model_kind,
                              segment=segment, tracer_kappa=tracer_kappa)
    unscale = 1.0
    if normalize_cost:
        ic0f = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32), ic0)
        l0 = float(loss(ic0f, src))
        # Guard: a first guess already at the optimum has l0 at float32
        # round-off (~1e-15 of the target's own mean square); blowing
        # THAT up to O(1) gradients would walk adam away from a
        # converged start. Only normalize a genuinely informative
        # misfit (>= 1e-9 of the target scale).
        tsq = [float(jnp.mean(jnp.square(jnp.asarray(a, jnp.float32))))
               for a in jax.tree_util.tree_leaves(target)]
        tscale = 0.5 * sum(tsq)
        if l0 > max(1e-9 * tscale, 0.0) and l0 > 0.0:
            unscale = l0
            raw = loss

            def loss(ic, src, _raw=raw, _s=np.float32(1.0 / l0)):
                return _raw(ic, src) * _s
    vg = loss_and_grad(loss, wrt="ic")
    opt = optax.adam(learning_rate)

    ic = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), ic0)
    state = opt.init(ic)

    @jax.jit
    def step(ic, state):
        val, grad = vg(ic, src)
        updates, state = opt.update(grad, state, ic)
        return optax.apply_updates(ic, updates), state, val

    losses = []
    for _ in range(iters):
        ic, state, val = step(ic, state)
        losses.append(float(val) * unscale)
    losses.append(float(vg(ic, src)[0]) * unscale)
    return ic, np.asarray(losses)
