#!/usr/bin/env python
"""4DVar-style initial-condition estimation demo (adjoint capability).

Twin experiment: integrate a "truth" gaussian vortex N steps to produce
the observation (the final vorticity field), corrupt the truth into a
first guess (wrong amplitude + a displaced spurious vortex), then recover
the IC by adam descent on the final-state misfit with gradients from
backprop through the checkpointed RK4 rollout (xlab_fftbarotropic/
adjoint.py). No reference counterpart — the C++ binaries are
forward-only.

Writes output/: loss_history.txt, truth/guess/recovered .bin fields
(reference raw-float32 layout) and a 4-panel PNG.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from xlab_fftbarotropic.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

enable_compile_cache()

import numpy as np  # noqa: E402


def main():
    import jax.numpy as jnp
    from xlab_fftbarotropic import adjoint
    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic.makefields import gaussian
    from xlab_fftbarotropic.io.fieldio import write_field

    nx = int(os.environ.get("NX", "64"))
    n_steps = int(os.environ.get("STEPS", "20"))
    iters = int(os.environ.get("ITERS", "150"))
    cfg = ModelConfig(nx=nx, ny=nx, lx=600_000.0, ly=600_000.0,
                      dt=3.0, nu=6.5)

    truth = jnp.asarray(0.1 * gaussian(cfg))          # peak zeta 1e-4
    src = jnp.zeros(cfg.grid_shape, jnp.float32)
    target = adjoint.make_rollout(cfg, n_steps)(truth, src)

    # corrupted first guess: damped truth + a spurious displaced vortex
    guess = 0.5 * np.asarray(truth)
    guess += np.roll(np.asarray(0.3 * truth), (nx // 4, nx // 4), (0, 1))
    guess = jnp.asarray(guess)

    ic_opt, losses = adjoint.fit_initial_condition(
        cfg, target, n_steps, guess, iters=iters,
        learning_rate=2e-6)

    os.makedirs("output", exist_ok=True)
    np.savetxt("output/loss_history.txt", losses)
    for name, f in [("truth", truth), ("guess", guess),
                    ("recovered", ic_opt)]:
        write_field(f"output/vort_{name}.bin", np.asarray(f))

    e0 = float(jnp.linalg.norm(guess - truth))
    e1 = float(jnp.linalg.norm(ic_opt - truth))
    print(f"misfit J: {losses[0]:.3e} -> {losses[-1]:.3e} "
          f"({losses[0] / max(losses[-1], 1e-300):.0f}x down)")
    print(f"IC error |dzeta|_2: {e0:.3e} -> {e1:.3e} "
          f"({e0 / max(e1, 1e-300):.1f}x down)")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:   # matplotlib optional, like viz/
        print(f"(skipping figure: {e})")
        return

    fig, axes = plt.subplots(2, 2, figsize=(9, 8))
    fields = [("truth IC", np.asarray(truth)),
              ("first guess", np.asarray(guess)),
              ("recovered IC", np.asarray(ic_opt))]
    vmax = float(np.max(np.abs(truth)))
    for ax, (title, f) in zip(axes.flat, fields):
        im = ax.imshow(f.T, origin="lower", cmap="RdBu_r",
                       vmin=-vmax, vmax=vmax)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.8)
    ax = axes.flat[3]
    ax.semilogy(losses)
    ax.set_title("misfit J (adam)")
    ax.set_xlabel("iteration")
    fig.tight_layout()
    fig.savefig("output/adjoint_4dvar.png", dpi=100)
    print("figure -> output/adjoint_4dvar.png")


if __name__ == "__main__":
    main()
