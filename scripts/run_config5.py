"""BASELINE config #5 — the north-star configuration — end to end on
the device: rotating shallow water at 4096² + nonlinear-balance pressure
inversion + minima track, i.e. the reference's test/02 pipeline shape
(test/02-test_invert_pressure/example.sh:3-16) at the metric grid.

One process:
  1. gaussian IC → geostrophically balanced SW start → --steps RK4 steps
     with (vort, psi) records every --record-step;
  2. invert_pres on every recorded psi (one jitted program, reused) →
     pres_step_N.bin;
  3. find_min (top-30 device scan) on every pres → pres_timeseries.txt
     in the reference's '%zu %zu %.5e' stdout contract.

Prints one JSON summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--record-step", type=int, default=200)
    ap.add_argument("--workdir", default="output/config5")
    args = ap.parse_args()

    from xlab_fftbarotropic.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax
    import numpy as np

    from xlab_fftbarotropic.config import ModelConfig
    from xlab_fftbarotropic.diagnostics.find_min import (find_min_n,
                                                             format_minima)
    from xlab_fftbarotropic.diagnostics.invert_pres import (
        PressureInverter)
    from xlab_fftbarotropic.ic import makefields
    from xlab_fftbarotropic.io.fieldio import read_field, write_field
    from xlab_fftbarotropic.models.shallow_water import max_stable_dt
    from xlab_fftbarotropic.parallel.multihost import gather_to_host
    from xlab_fftbarotropic.runner import run

    wd = args.workdir
    os.makedirs(f"{wd}/output", exist_ok=True)
    cfg = ModelConfig(nx=args.nx, ny=args.nx,
                      total_steps=args.steps, record_step=args.record_step,
                      output_dir=f"{wd}/output")
    cfg = cfg.replace(dt=min(float(cfg.dt), max_stable_dt(cfg)))
    vort0 = makefields.gaussian(cfg)

    t_run0 = time.perf_counter()
    res = run(cfg, vort0, model_kind="shallow-water",
              manifest_path=f"{wd}/log", record_only=["vort", "psi"],
              progress=True)
    t_run = time.perf_counter() - t_run0

    # 3+4. pressure inversion + minima track over the recorded psi files
    inv = PressureInverter(cfg)
    rec_steps = list(range(0, args.steps, args.record_step))
    t_inv = t_fetch = 0.0
    lines = []
    track_records = []
    for step in rec_steps:
        psi = read_field(f"{wd}/output/psi_step_{step}.bin", cfg.grid_shape)
        t0 = time.perf_counter()
        pres = inv(psi)
        x, y, vals = find_min_n(pres)      # device top-k; tiny fetch
        t_inv += time.perf_counter() - t0
        t0 = time.perf_counter()
        pres_np = gather_to_host(pres)     # 67 MB fetch at 4096^2
        t_fetch += time.perf_counter() - t0
        write_field(f"{wd}/output/pres_step_{step}.bin", pres_np)
        lines.append(format_minima(x, y, vals))
        track_records.append((step, np.asarray(x), np.asarray(y),
                              np.asarray(vals)))
    with open(f"{wd}/output/pres_timeseries.txt", "w") as f:
        f.write("\n".join(lines) + "\n")

    # vortex-core tracks across the record steps (the identity layer the
    # reference's pres_timeseries.txt lacks; diagnostics/tracks.py)
    from xlab_fftbarotropic.diagnostics.tracks import (build_tracks,
                                                           format_tracks)
    tracks = build_tracks(track_records, cfg.nx, cfg.ny)
    with open(f"{wd}/output/tracks.txt", "w") as f:
        f.write(format_tracks(tracks) + "\n")

    deepest = min(float(t.split()[2])
                  for ln in lines for t in ln.splitlines())
    print(json.dumps({
        "config": "BASELINE #5 (SW + invert_pres at north-star grid)",
        "nx": args.nx, "steps": res.steps_run, "dt": cfg.dt,
        "device": jax.devices()[0].device_kind,
        "run_wall_s": round(t_run, 1),
        "ms_per_step_incl_records": round(t_run / res.steps_run * 1e3, 2),
        "n_records": len(rec_steps),
        "invert_pres_s_per_field": round(t_inv / len(rec_steps), 2),
        "pres_fetch_s_per_field": round(t_fetch / len(rec_steps), 2),
        "deepest_pres_anomaly": deepest,
        "n_tracks": len(tracks),
        "longest_track_steps": max((len(t.steps) for t in tracks),
                                   default=0),
        "stats_last": res.stats_history[-1] if res.stats_history else None,
    }), flush=True)


if __name__ == "__main__":
    main()
