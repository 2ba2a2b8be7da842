"""ETDRK4 production-stability soak at the north-star grid.

Build the SW model with --time-scheme etdrk4 at --nx (default 4096²)
and --dt (default 7.5 s = 8.9x the RK4 gravity-wave bound there), run
--steps in --segment-steps chunks, and print per-segment wall-clock plus
the conservation scalars (mass exactly, energy/potential-enstrophy drift
measure the discretization). Only scalars are fetched.

Usage: python scripts/etd_soak.py [--nx 4096] [--dt 7.5] [--steps 1000]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=4096)
    ap.add_argument("--dt", type=float, default=7.5)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--segment-steps", type=int, default=100)
    args = ap.parse_args()

    from xlab_fftbarotropic.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax.numpy as jnp

    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.models.shallow_water import (
        ShallowWaterModel, max_stable_dt)

    def progress(*a):
        print(time.strftime("%H:%M:%S"), *a, file=sys.stderr)
        sys.stderr.flush()

    cfg = ModelConfig(nx=args.nx, ny=args.nx, dt=args.dt,
                      time_scheme="etdrk4")
    progress(f"dt = {args.dt} s = "
             f"{args.dt / max_stable_dt(cfg):.1f}x the RK4 bound")
    t0 = time.perf_counter()
    m = ShallowWaterModel.build(cfg)
    s = m.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
    progress(f"build (incl phi tables + upload) "
             f"{time.perf_counter() - t0:.1f}s")

    done = 0
    t_compile = time.perf_counter()
    while done < args.steps:
        n = min(args.segment_steps, args.steps - done)
        t0 = time.perf_counter()
        s = m.segment(s, None, n)
        st = m.stats(s)
        # the float() conversions ARE the completion barrier — they must
        # sit INSIDE the timed window (dispatch is async; measuring
        # before the fetch times the dispatch, not the compute)
        scalars = {
            "mass": float(st.mass), "energy": float(st.energy),
            "pot_enstrophy": float(st.pot_enstrophy),
            "max_abs_div": float(st.max_abs_div),
            "max_zeta_hat": float(jnp.max(jnp.abs(s.zeta_hat))),
        }
        wall = time.perf_counter() - t0
        done += n
        print(json.dumps({
            "step": done, "sim_s": round(done * args.dt, 1),
            "ms_per_step": round(wall / n * 1e3, 2), **scalars,
        }), flush=True)
        if done == args.segment_steps:
            progress(f"first segment (compile) "
                     f"{time.perf_counter() - t_compile:.1f}s")


if __name__ == "__main__":
    main()
