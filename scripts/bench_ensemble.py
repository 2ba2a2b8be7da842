"""Ensemble throughput sweep: aggregate grid-points/s vs member count.

The capability claim to verify on the device: at the reference-scale
grids (256^2..1024^2) a single run leaves the accelerator idle
(launch-bound), and vmap-batching M members into one jitted scan
multiplies AGGREGATE throughput well past M=1 at near-constant wall per
step. One process for all combos; timing contract as in bench.py:
scan-inside-jit segments, block_until_ready, second call timed.

Usage: python scripts/bench_ensemble.py [--steps 100]
       [--combos 256x1 256x8 256x64 512x1 512x8 512x32 1024x1 1024x8]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--combos", nargs="+",
                    default=["256x1", "256x8", "256x64",
                             "512x1", "512x8", "512x32",
                             "1024x1", "1024x8"])
    args = ap.parse_args()

    from xlab_fftbarotropic.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.models.barotropic import BarotropicModel
    from xlab_fftbarotropic.models.ensemble import EnsembleModel

    def progress(*a):
        print(time.strftime("%H:%M:%S"), *a, file=sys.stderr)
        sys.stderr.flush()

    progress("device:", jax.devices()[0].device_kind)

    base = {}
    for combo in args.combos:
        # NXxM[xW][:backend] — W chunks the vmap; backend defaults to
        # xla (':mxu' selects the DFT-as-matmul transform).
        spec = combo.lower()
        backend = "xla"
        if ":" in spec:
            spec, backend = spec.split(":", 1)
        parts = [int(v) for v in spec.split("x")]
        nx, m = parts[0], parts[1]
        width = parts[2] if len(parts) > 2 else m  # NXxMxW = chunked
        cfg = ModelConfig(nx=nx, ny=nx, fft_backend=backend)
        vort0 = makefields.gaussian(cfg)
        src = jnp.zeros(cfg.grid_shape, jnp.float32)
        if m == 1:
            model = BarotropicModel.build(cfg)
            state = model.init_state(vort0)
        else:
            model = EnsembleModel.build(cfg, m, vmap_width=width)
            state = model.init_from_physical(vort0, amplitude=0.05, seed=0)

        def checksum(s):
            return float(jnp.max(jnp.real(s)))

        progress(combo, "compiling")
        cw = checksum(jax.block_until_ready(
            model.segment(state, src, args.steps)))
        progress(combo, "warm, checksum", cw)
        t0 = time.perf_counter()
        out = jax.block_until_ready(model.segment(state, src, args.steps))
        dt = time.perf_counter() - t0
        if checksum(out) != cw:
            raise RuntimeError("nondeterministic segment")
        agg = nx * nx * m * args.steps / dt
        rec = {"nx": nx, "members": m, "width": width,
               "backend": backend, "steps": args.steps,
               "ms_per_step": round(dt / args.steps * 1e3, 3),
               "agg_gp_per_s": round(agg, 0)}
        if (nx, backend) in base:
            rec["agg_speedup_vs_m1"] = round(agg / base[(nx, backend)], 2)
        if m == 1:
            base[(nx, backend)] = agg
        print(json.dumps(rec))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
