"""Long-run soak: BASELINE config #4 (Kuo2004 merger, wall-clock/1000 steps).

Runs the barotropic core for --total-steps (default 10k) at --nx (default
2048) in segments of 1000, printing one JSON line per segment with
wall-clock and stability scalars (fetched as scalars).
Usage: python scripts/soak.py [--nx 2048] [--total-steps 10000]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--total-steps", type=int, default=10_000)
    ap.add_argument("--segment", type=int, default=1000)
    ap.add_argument("--ic", default="kuo2004",
                    choices=["kuo2004", "gaussian"],
                    help="kuo2004 (config #4) violates CFL at 4096^2 "
                         "with the default dt; use gaussian there")
    args = ap.parse_args()

    from xlab_fftbarotropic.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.models.barotropic import BarotropicModel

    cfg = ModelConfig(nx=args.nx, ny=args.nx)
    model = BarotropicModel.build(cfg)
    ic = getattr(makefields, args.ic)
    z = model.init_state(ic(cfg))
    src = jnp.zeros(cfg.grid_shape, jnp.float32)

    # warm-up/compile segment (excluded from timing)
    zw = model.segment(z, src, args.segment)
    _ = float(jnp.max(jnp.abs(zw)))

    done = 0
    while done < args.total_steps:
        n = min(args.segment, args.total_steps - done)
        t0 = time.perf_counter()
        z = model.segment(z, src, n)
        max_abs = float(jnp.max(jnp.abs(z)))      # forces completion
        dt = time.perf_counter() - t0
        done += n
        print(json.dumps({
            "steps_done": done,
            "seconds_per_1000": round(dt / n * 1000, 3),
            "grid_points_per_s": round(args.nx * args.nx * n / dt, 1),
            "max_abs_zeta_hat": max_abs,
        }))
        sys.stdout.flush()
        if not (max_abs == max_abs and max_abs < 1e30):   # NaN/blow-up
            print("BLOWUP", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
