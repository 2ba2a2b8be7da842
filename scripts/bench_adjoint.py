"""Adjoint (gradient) cost on the device, one process for all sizes.

Measures, per grid size, the wall time of (a) the forward n-step
checkpointed rollout and (b) jit(value_and_grad) of the final-state
misfit through the same rollout — the quantity that prices 4DVar /
sensitivity work. Theoretical floor is ~3x forward (one primal + one
rematerialized primal + one adjoint sweep, each adjoint RK4 stage
costing about a forward stage); the measured ratio shows what XLA's
scan-transpose actually achieves.

Compile is excluded from timing and reported separately; only scalars
are fetched (loss value and a grad-checksum). Prints one JSON line per
size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="512,1024,2048")
    ap.add_argument("--steps", type=int, default=10,
                    help="rollout length n (RK4 steps per timing unit)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from xlab_fftbarotropic.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from xlab_fftbarotropic import adjoint
    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields

    n = args.steps
    for nx in [int(s) for s in args.sizes.split(",")]:
        cfg = ModelConfig(nx=nx, ny=nx, dt=3.0, nu=6.5)
        ic = jnp.asarray(0.1 * makefields.gaussian(cfg))
        src = jnp.zeros(cfg.grid_shape, jnp.float32)

        roll = adjoint.make_rollout(cfg, n)
        tgt = roll(0.9 * ic, src)
        float(jnp.max(jnp.abs(tgt)))                 # force fwd compile

        loss = adjoint.final_state_misfit(cfg, tgt, n)
        vg = adjoint.loss_and_grad(loss)

        def time_fwd():
            best = float("inf")
            for _ in range(args.reps):
                t0 = time.perf_counter()
                out = roll(ic, src)
                float(jnp.max(jnp.abs(out)))         # completion fence
                best = min(best, time.perf_counter() - t0)
            return best

        def time_grad():
            best = float("inf")
            val = chk = None
            for _ in range(args.reps):
                t0 = time.perf_counter()
                val, g = vg(ic, src)
                chk = float(jnp.max(jnp.abs(g)))     # completion fence
                val = float(val)
                best = min(best, time.perf_counter() - t0)
            return best, val, chk

        t0 = time.perf_counter()
        _, v_c, c_c = time_grad()                    # includes compile
        compile_s = time.perf_counter() - t0
        fwd_s = time_fwd()
        grad_s, val, chk = time_grad()
        print(json.dumps({
            "nx": nx, "n_steps": n,
            "device": jax.devices()[0].device_kind,
            "fwd_ms_per_step": 1e3 * fwd_s / n,
            "grad_ms_per_step": 1e3 * grad_s / n,
            "grad_over_fwd": grad_s / fwd_s,
            "loss": val, "grad_checksum": chk,
            "grad_compile_s": compile_s,
        }), flush=True)


if __name__ == "__main__":
    main()
