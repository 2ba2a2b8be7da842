"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline metric: grid-points/s per device for a full RK4 step (20 FFTs +
spectral pointwise work) at 4096^2. The reference publishes no numbers
(SURVEY.md §7), so `vs_baseline` is measured against this repo's own CPU
oracle (oracle/reference_cpu.py) — a line-for-line float32 numpy
re-implementation of the serial reference pipeline — standing in for the
single-threaded FFTW3f reference binary, which cannot be built here (no
FFTW; SURVEY.md Phase 0 note). The oracle is timed at a small grid
(running it at 4096^2 would take minutes per step) and its grid-points/s
is extrapolated to the bench grid with the serial N^2 log N FFT cost
model: per-point cost scales with log(nx), so gp/s(bench_nx) =
gp/s(oracle_nx) * log(oracle_nx)/log(bench_nx). The JSON records the
method in `baseline_method` and the device it ran on in `device`.

The default invocation measures every family (barotropic, shallow-water,
tracer, SW-ETDRK4) in this one process and reports them in the
`families` field; the barotropic number remains the headline
`metric`/`value`. The benchmark's redesign is ROADMAP S1.

Usage: python bench.py [--nx N] [--steps S] [--quick]
       [--model all|barotropic|sw|tracer|sw-etdrk4]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def measure_device(nx: int, steps: int, model_kind: str = "barotropic"):
    """Wall-clock a `steps`-long jitted scan segment; returns
    (grid-points/s on one device, ms/step, dt_used, extra). Compile
    excluded; device-synchronized timing."""
    import jax
    import jax.numpy as jnp

    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields

    cfg = ModelConfig(nx=nx, ny=nx)
    extra = {}
    if model_kind == "sw-etdrk4":
        # exponential integration at a dt far above the gravity-wave
        # CFL bound: 7.5 s at 4096^2 (8.85x the RK4 bound) and 8.85x
        # the bound elsewhere. phi tables come through the disk cache
        # (models/etdrk4.py:build_tables_cached) — the JSON discloses
        # whether this process built or loaded them.
        from xlab_fftbarotropic.models import etdrk4 as etd_mod
        from xlab_fftbarotropic.models.shallow_water import (
            ShallowWaterModel, max_stable_dt)
        bound = max_stable_dt(cfg)
        dt_big = 7.5 if nx == 4096 else round(8.85 * bound, 3)
        cfg = cfg.replace(dt=dt_big, time_scheme="etdrk4")
        key = etd_mod.tables_cache_key(cfg, dt_big, kind="sw")
        cdir = etd_mod._cache_dir(cfg)
        cached = bool(cdir and (cdir / f"sw_etd_{key}.npy").exists())
        t_b = time.perf_counter()
        model = ShallowWaterModel.build(cfg)
        extra = {"dt_multiple_of_rk4_bound": round(dt_big / bound, 2),
                 "etd_tables": "cache" if cached else "built",
                 "build_s": round(time.perf_counter() - t_b, 1)}
        z = model.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
        src = None
    elif model_kind in ("shallow-water", "sw"):
        from xlab_fftbarotropic.models.shallow_water import (
            ShallowWaterModel, max_stable_dt)
        # the default dt=3 s violates the RK4 gravity-wave CFL bound at
        # >= 2048^2 (0.847 s at 4096^2) and the segment would NaN
        cfg = cfg.replace(dt=min(float(cfg.dt), max_stable_dt(cfg)))
        model = ShallowWaterModel.build(cfg)
        z = model.geostrophic_init(makefields.gaussian(cfg, zeta0=1e-5))
        src = None
    elif model_kind == "tracer":
        from xlab_fftbarotropic.models.tracer import (TracerModel,
                                                          tracer_ic)
        model = TracerModel.build(cfg, kappa=50.0)
        z = model.init_state(makefields.gaussian(cfg),
                             tracer_ic(cfg, "gaussian"))
        src = model.zero_source()
    else:
        from xlab_fftbarotropic.models.barotropic import BarotropicModel
        model = BarotropicModel.build(cfg)
        z = model.init_state(makefields.gaussian(cfg))
        src = jnp.zeros(cfg.grid_shape, jnp.float32)

    def checksum(state):
        leaf = state[0] if isinstance(state, tuple) else state
        return float(jnp.max(jnp.abs(leaf)))

    z_w = jax.block_until_ready(model.segment(z, src, steps))  # compile
    t0 = time.perf_counter()
    z_t = jax.block_until_ready(model.segment(z, src, steps))
    dt = time.perf_counter() - t0
    if checksum(z_t) != checksum(z_w):
        raise RuntimeError("nondeterministic segment result")
    ms = dt / steps * 1e3
    if extra:
        extra["sim_s_per_wall_s"] = round(float(cfg.dt) / ms * 1e3, 1)
    return nx * nx * steps / dt, ms, float(cfg.dt), extra


def measure_oracle(nx: int, steps: int) -> float:
    """CPU-oracle (stand-in for the serial C++/FFTW reference) gp/s."""
    import numpy as np

    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.oracle import reference_cpu as oracle

    cfg = ModelConfig(nx=nx, ny=nx)
    vort0 = makefields.gaussian(cfg)
    model = oracle.OracleBarotropic(cfg)
    t0 = time.perf_counter()
    model.run(vort0, steps)
    dt = time.perf_counter() - t0
    return nx * nx * steps / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--oracle-nx", type=int, default=256)
    ap.add_argument("--oracle-steps", type=int, default=10)
    ap.add_argument("--model", default="all",
                    choices=["all", "barotropic", "sw", "shallow-water",
                             "tracer", "sw-etdrk4"],
                    help="'all' (default) measures every family in this "
                         "one process and reports them in a 'families' "
                         "field (the barotropic headline stays the "
                         "metric/value); a family name restricts to it")
    ap.add_argument("--quick", action="store_true",
                    help="small grid for smoke runs")
    args = ap.parse_args()
    if args.quick:
        args.nx, args.steps = 512, 10

    from xlab_fftbarotropic.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax
    dev = jax.devices()[0]

    kinds = (["barotropic", "sw", "tracer", "sw-etdrk4"]
             if args.model == "all" else [args.model])
    families = {}
    for kind in kinds:
        gps_k, ms_k, dt_k, extra = measure_device(args.nx, args.steps,
                                                  kind)
        key = ("sw" if kind == "shallow-water"
               else "etdrk4" if kind == "sw-etdrk4" else kind)
        families[key] = {"gp_per_s": round(gps_k, 1),
                         "ms_per_step": round(ms_k, 2), "dt": dt_k,
                         **extra}
        print(f"# {key}: {ms_k:.2f} ms/step ({gps_k / 1e6:.1f} M gp/s)",
              file=sys.stderr, flush=True)
    head = kinds[0]     # barotropic headline when measuring all
    head_key = ("sw" if head == "shallow-water"
                else "etdrk4" if head == "sw-etdrk4" else head)
    gps = families[head_key]["gp_per_s"]
    base = measure_oracle(args.oracle_nx, args.oracle_steps)

    tag = ("" if head == "barotropic"
           else "_tracer" if head == "tracer"
           else "_etdrk4" if head == "sw-etdrk4" else "_sw")
    out = {
        "metric": (f"rk4{tag}_grid_points_per_s_per_device_"
                   f"{args.nx}x{args.nx}"),
        "value": gps,
        "unit": "grid-points/s/device",
        "families": families,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    import math
    # serial per-grid-point cost ~ log(nx) (N^2 log N FFTs), so the
    # oracle's gp/s measured at oracle_nx shrinks by
    # log(oracle_nx)/log(nx) at the bench grid.
    base_at_bench = base * math.log(args.oracle_nx) / math.log(args.nx)
    out["vs_baseline"] = round(gps / base_at_bench, 2)
    out["baseline_method"] = (
        f"serial CPU oracle measured at {args.oracle_nx}^2 "
        f"({base / 1e6:.2f}M gp/s), extrapolated to {args.nx}^2 by "
        "N^2logN scaling (gp/s * log(oracle_nx)/log(nx))")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
