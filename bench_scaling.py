"""Scaling benchmark: throughput vs device count on a mesh.

On several accelerators this measures weak/strong scaling of the
distributed RK4 step (the BASELINE.json >70% weak-scaling target). On a
single-device or CPU environment it still runs — with virtual devices
(--force-host N) it validates the distributed path end-to-end and measures
the COMMUNICATION OVERHEAD of the slab transposes relative to the
single-device step (virtual devices share one socket, so "scaling" numbers
here are a ceiling check, not hardware scaling).

Prints one JSON line per mesh size:
  {"devices": n, "nx": N, "ms_per_step": x, "grid_points_per_s": y,
   "weak_efficiency": z}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=1024,
                    help="grid size PER DEVICE ROW-BLOCK for weak scaling "
                         "(total nx = nx-per-dev * devices) or total for "
                         "strong scaling")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--mode", choices=["weak", "strong"], default="weak")
    ap.add_argument("--force-host", type=int, default=0,
                    help="use N virtual CPU devices (validation mode)")
    ap.add_argument("--decomp", default="slab",
                    choices=["slab", "xpencil", "pencil"],
                    help="domain decomposition: slab (1-D row mesh), "
                         "xpencil (1-D mesh, column-sharded spectral "
                         "state — half the all_to_all traffic), or true "
                         "2-D pencil (parallel/pencil.py; each n is "
                         "factored into the squarest PxQ mesh)")
    args = ap.parse_args()

    if args.force_host:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{args.force_host}").strip()

    from xlab_fftbarotropic.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.models.barotropic import BarotropicModel
    from xlab_fftbarotropic.parallel import (
        ShardedBarotropicModel, make_mesh)

    def pencil_shape(n):
        """Squarest P x Q with P*Q == n (P <= Q), e.g. 8 -> (2, 4)."""
        p = max(d for d in range(1, int(n ** 0.5) + 1) if n % d == 0)
        return (p, n // p)

    devices = jax.devices()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    base_gps = None
    for n in sizes:
        nx = args.nx * n if args.mode == "weak" else args.nx
        if nx % n:
            continue
        cfg = ModelConfig(nx=nx, ny=nx)
        vort0 = makefields.gaussian(cfg)
        if n == 1:
            model = BarotropicModel.build(cfg)
            z = model.init_state(vort0)
            src = jnp.zeros(cfg.grid_shape, jnp.float32)
        elif args.decomp == "pencil":
            from xlab_fftbarotropic.parallel import pencil
            shape = pencil_shape(n)
            if nx % shape[1]:
                continue
            model = ShardedBarotropicModel.build(
                cfg, pencil.make_pencil_mesh(shape, devices[:n]),
                decomp="pencil")
            z = model.init_state(vort0)
            src = model.zero_source()
        else:
            model = ShardedBarotropicModel.build(cfg, make_mesh(devices[:n]),
                                                 decomp=args.decomp)
            z = model.init_state(vort0)
            src = model.zero_source()
        out = model.segment(z, src, args.steps)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = model.segment(z, src, args.steps)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        gps = nx * nx * args.steps / dt
        per_dev = gps / n
        if base_gps is None:
            base_gps = per_dev
        print(json.dumps({
            "devices": n, "nx": nx,
            "decomp": args.decomp if n > 1 else "single",
            "ms_per_step": round(dt / args.steps * 1000, 3),
            "grid_points_per_s": round(gps, 1),
            "weak_efficiency": round(per_dev / base_gps, 3),
        }))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
