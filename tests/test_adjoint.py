"""Differentiable-simulation (adjoint) tests.

Strategy: (1) the AD gradient must match a central finite difference of
the same rollout along a random direction (float32 => loose but honest
tolerances); (2) the two-level checkpointed scan must be exactly the same
forward map (and the same gradient) as an unsegmented rollout; (3) the
end-to-end capability: 4DVar-style adam descent from a corrupted IC must
cut the final-state misfit by orders of magnitude and move the IC toward
the truth. No reference counterpart (the C++ binaries are forward-only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xlab_fftbarotropic import adjoint
from xlab_fftbarotropic.config import ModelConfig
from xlab_fftbarotropic.ic.makefields import gaussian


def _cfg(nx=32, dt=3.0, nu=6.5):
    return ModelConfig(nx=nx, ny=nx, lx=600_000.0, ly=600_000.0,
                       dt=dt, nu=nu)


def _smooth_ic(cfg, amp=1e-4):
    """Band-limited random IC: smooth enough that a float32 FD probe of
    the rollout is meaningful."""
    rng = np.random.default_rng(0)
    nx, ny = cfg.grid_shape
    z = np.zeros((nx, ny), np.float32)
    x = np.arange(nx)[:, None] / nx
    y = np.arange(ny)[None, :] / ny
    for kx in range(1, 4):
        for ky in range(1, 4):
            ph = rng.uniform(0, 2 * np.pi, size=2)
            z += np.float32(rng.standard_normal() * amp) * np.float32(
                np.sin(2 * np.pi * (kx * x + ky * y) + ph[0])
                * np.cos(2 * np.pi * (ky * x - kx * y) + ph[1]))
    return jnp.asarray(z)


def _directional_fd_check(loss, ic, src, wrt, rtol):
    """AD directional derivative vs central finite difference."""
    vg = adjoint.loss_and_grad(loss, wrt=wrt)
    _, grad = vg(ic, src)
    rng = np.random.default_rng(1)
    direction = jnp.asarray(
        rng.standard_normal(np.shape(grad)).astype(np.float32))
    direction = direction / jnp.linalg.norm(direction)
    ad_dir = float(jnp.vdot(grad, direction))

    # scale eps to the argument's magnitude; float32 central difference.
    # The floor matters for the all-zero src argument: eps below ~1e-8
    # probes rollout round-off, not the derivative (measured 11% FD error
    # at eps=1e-9 vs 0.1% at 1e-6 on this problem).
    base = ic if wrt == "ic" else src
    eps = 1e-3 * max(float(jnp.max(jnp.abs(base))), 1e-3)
    if wrt == "ic":
        lp = float(loss(ic + eps * direction, src))
        lm = float(loss(ic - eps * direction, src))
    else:
        lp = float(loss(ic, src + eps * direction))
        lm = float(loss(ic, src - eps * direction))
    fd_dir = (lp - lm) / (2 * eps)
    assert fd_dir != 0.0
    assert abs(ad_dir - fd_dir) <= rtol * max(abs(fd_dir), abs(ad_dir)), \
        (ad_dir, fd_dir)


def test_barotropic_grad_matches_fd():
    cfg = _cfg()
    ic = _smooth_ic(cfg)
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    target = adjoint.make_rollout(cfg, 3)(0.9 * ic, src)
    loss = adjoint.final_state_misfit(cfg, target, 3)
    _directional_fd_check(loss, ic, src, "ic", rtol=5e-2)


def test_forcing_grad_matches_fd():
    cfg = _cfg()
    ic = _smooth_ic(cfg)
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    target = adjoint.make_rollout(cfg, 3)(ic, src)
    # perturbed problem so the gradient wrt src is non-trivial
    loss = adjoint.final_state_misfit(cfg, 0.5 * target, 3)
    _directional_fd_check(loss, ic, src, "src", rtol=5e-2)


def test_sw_and_tracer_grads_finite():
    cfg = _cfg()
    ic = _smooth_ic(cfg)
    src = jnp.zeros(cfg.grid_shape, jnp.float32)

    sw_target = adjoint.make_rollout(cfg, 2, model_kind="sw")(0.9 * ic, src)
    sw_loss = adjoint.final_state_misfit(cfg, sw_target, 2, model_kind="sw")
    _, g = adjoint.loss_and_grad(sw_loss)(ic, src)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.max(jnp.abs(g))) > 0

    tr_ic = (ic, jnp.abs(ic))
    tr_target = adjoint.make_rollout(cfg, 2, model_kind="tracer")(
        (0.9 * ic, 0.8 * jnp.abs(ic)), src)
    tr_loss = adjoint.final_state_misfit(cfg, tr_target, 2,
                                         model_kind="tracer")
    _, g = adjoint.loss_and_grad(tr_loss)(tr_ic, src)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
    # the q0 cotangent must flow (tracer misfit pulls on the tracer IC)
    assert float(jnp.max(jnp.abs(g[1]))) > 0


def test_segmented_rollout_matches_unsegmented():
    cfg = _cfg()
    ic = _smooth_ic(cfg)
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    out_a = adjoint.make_rollout(cfg, 7, segment=1)(ic, src)
    out_b = adjoint.make_rollout(cfg, 7, segment=3)(ic, src)   # 2*3 + 1
    out_c = adjoint.make_rollout(cfg, 7, segment=7)(ic, src)
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(out_b),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(out_c),
                               rtol=0, atol=1e-7)

    target = 0.9 * out_a
    g = [np.asarray(adjoint.loss_and_grad(
            adjoint.final_state_misfit(cfg, target, 7, segment=s))(
                ic, src)[1]) for s in (1, 3, 7)]
    np.testing.assert_allclose(g[0], g[1], rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(g[0], g[2], rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("decomp,mesh_shape", [
    ("slab", None), ("xpencil", None), ("pencil", (2, 4))])
def test_sharded_gradient_matches_single_device(decomp, mesh_shape):
    """Backprop through shard_map + distributed FFTs == single-device
    adjoint, for every decomposition (the collective transpose rules)."""
    from xlab_fftbarotropic.parallel.model import make_mesh
    from xlab_fftbarotropic.parallel import pencil

    cfg = _cfg()
    ic = _smooth_ic(cfg)
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    n = 3
    target = adjoint.make_rollout(cfg, n)(0.9 * ic, src)

    def misfit(roll):
        return lambda v, s: 0.5 * jnp.mean(
            jnp.square(roll(v, s) - target))

    g_single = jax.grad(misfit(adjoint.make_rollout(cfg, n)))(ic, src)

    mesh = (make_mesh() if mesh_shape is None
            else pencil.make_pencil_mesh(mesh_shape))
    roll = adjoint.make_sharded_rollout(cfg, n, mesh, decomp=decomp)
    g_sharded = jax.grad(misfit(roll))(ic, src)

    scale = float(jnp.max(jnp.abs(g_single)))
    np.testing.assert_allclose(np.asarray(g_sharded),
                               np.asarray(g_single),
                               rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("decomp", ["slab", "xpencil", "pencil"])
def test_p4_sharded_rollout_forward_matches_single(p4_mesh, decomp):
    """The sharded rollout's forward pass on the four-device layout
    equals the single-device rollout (fast tier; the gradient check
    above is slow)."""
    cfg = _cfg()
    ic = _smooth_ic(cfg)
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    want = np.asarray(adjoint.make_rollout(cfg, 2)(ic, src))
    roll = adjoint.make_sharded_rollout(cfg, 2, p4_mesh(decomp),
                                        decomp=decomp)
    got = np.asarray(roll(ic, src))
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_assimilate_cli_end_to_end(tmp_path):
    """xfb-assimilate: target + corrupted guess -> recovered IC file."""
    from xlab_fftbarotropic.cli import assimilate
    from xlab_fftbarotropic.io.fieldio import read_field, write_field

    cfg = _cfg()
    truth = np.asarray(0.1 * gaussian(cfg))
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    n = 5
    target = np.asarray(adjoint.make_rollout(cfg, n)(jnp.asarray(truth),
                                                     src))
    write_field(str(tmp_path / "target.bin"), target)
    write_field(str(tmp_path / "guess.bin"), 0.5 * truth)

    assimilate.main([
        "--nx", "32", "--ny", "32", "--lx", "600000", "--ly", "600000",
        "--dt", "3.0", "--nu", "6.5",
        "--target", str(tmp_path / "target.bin"),
        "--guess", str(tmp_path / "guess.bin"),
        "--out", str(tmp_path / "recovered.bin"),
        "--steps", str(n), "--iters", "60", "--lr", "1e-5"])

    rec = read_field(str(tmp_path / "recovered.bin"), cfg.grid_shape)
    losses = np.loadtxt(tmp_path / "recovered.bin.loss.txt")
    assert losses[-1] < 1e-2 * losses[0]
    e0 = np.linalg.norm(0.5 * truth - truth)
    e1 = np.linalg.norm(np.asarray(rec) - truth)
    assert e1 < 0.2 * e0


def test_fit_initial_condition_recovers_truth():
    cfg = _cfg()
    truth = jnp.asarray(0.1 * gaussian(cfg))   # peak zeta 1e-4
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    n = 6
    target = adjoint.make_rollout(cfg, n)(truth, src)

    first_guess = 0.5 * truth   # wrong amplitude everywhere
    ic_opt, losses = adjoint.fit_initial_condition(
        cfg, target, n, first_guess, iters=80, learning_rate=1e-5)
    assert losses[-1] < 1e-2 * losses[0], losses[[0, -1]]
    err0 = float(jnp.linalg.norm(first_guess - truth))
    err1 = float(jnp.linalg.norm(ic_opt - truth))
    assert err1 < 0.2 * err0, (err0, err1)
