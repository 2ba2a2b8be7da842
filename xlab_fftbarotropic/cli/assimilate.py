"""CLI: 4DVar-style initial-condition estimation (adjoint.py surface).

No reference counterpart (the C++ binaries are forward-only). Given an
observed final vorticity field and a first-guess IC, recover the IC that
reproduces the observation after --steps RK4 steps by adam descent on
the final-state misfit, with gradients backpropagated through the
checkpointed rollout:

    xfb-assimilate --nx 768 --ny 768 --steps 100 \
        --target output/vort_step_100.bin \
        --guess  input/initial_vorticity.bin \
        --out    input/recovered_vorticity.bin \
        --iters 150 --lr 2e-6

Writes the recovered IC (reference raw-float32 layout) plus
`<out>.loss.txt` with the per-iteration cost history. `--forcing F.bin`
supplies the constant vorticity source of a forced run (default zero).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    ap = argparse.ArgumentParser(prog="xfb-assimilate")
    from ..config import add_config_args, config_from_args
    add_config_args(ap)
    ap.add_argument("--target", required=True,
                    help="observed final vorticity field (.bin)")
    ap.add_argument("--guess", required=True,
                    help="first-guess initial vorticity (.bin)")
    ap.add_argument("--out", required=True,
                    help="recovered initial vorticity output path")
    ap.add_argument("--steps", type=int, required=True,
                    help="rollout length between IC and observation")
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--lr", type=float, default=2e-6,
                    help="adam learning rate, in vorticity units "
                         "(~1-10%% of the IC amplitude)")
    ap.add_argument("--forcing", default=None,
                    help="constant vorticity source field (.bin)")
    ap.add_argument("--segment", type=int, default=None,
                    help="checkpoint segment length (default ~sqrt(steps))")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)

    import numpy as np
    import jax.numpy as jnp

    from .. import adjoint
    from ..io.fieldio import read_field, write_field

    target = read_field(args.target, cfg.grid_shape)
    guess = read_field(args.guess, cfg.grid_shape)
    src = (read_field(args.forcing, cfg.grid_shape)
           if args.forcing else jnp.zeros(cfg.grid_shape, jnp.float32))

    ic, losses = adjoint.fit_initial_condition(
        cfg, target, args.steps, guess, src=jnp.asarray(src),
        iters=args.iters, learning_rate=args.lr, segment=args.segment)

    write_field(args.out, np.asarray(ic))
    np.savetxt(f"{args.out}.loss.txt", losses)
    print(f"misfit J: {losses[0]:.6e} -> {losses[-1]:.6e} "
          f"over {args.iters} iterations", file=sys.stderr)
    print(f"recovered IC -> {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
