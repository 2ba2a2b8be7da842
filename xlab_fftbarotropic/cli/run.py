"""`xfb-run` — the model driver binary.

Merges the reference's main.out (main.cpp:65-80, flags -I/-O/-i) and
main-shallow-water.out (main-shallow-water.cpp:75-95, adds -s script /
-f fifo forcing), plus the grid/physics flags the reference bakes in at
compile time and new checkpoint/restart plumbing.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from ..config import add_config_args, config_from_args

    p = argparse.ArgumentParser(
        prog="xfb-run",
        description="Barotropic vorticity model run")
    add_config_args(p)
    p.add_argument("-m", "--model", default="barotropic",
                   choices=["barotropic", "bt", "shallow-water", "sw",
                            "fd", "jacobian", "tracer"],
                   help="model family: barotropic vorticity (reference "
                        "parity), rotating shallow water (new), fd "
                        "cross-check core, or tracer (barotropic + "
                        "co-advected passive scalar q, recorded as "
                        "q_step_N.bin — feeds the Nakamura "
                        "effective-diffusivity diagnostic)")
    p.add_argument("--tracer-ic", default="vorticity",
                   choices=["vorticity", "zonal", "meridional", "gaussian"],
                   help="tracer initial condition for -m tracer "
                        "(models/tracer.py:tracer_ic)")
    p.add_argument("--tracer-kappa", type=float, default=0.0,
                   help="tracer diffusivity kappa [m^2/s] for -m tracer "
                        "(0 = purely advective)")
    p.add_argument("-s", "--script", default=None, metavar="RECIPE",
                   help="vorticity-source script file "
                        "(lines: '<time> <field.bin>')")
    p.add_argument("-f", "--fifo", default=None, metavar="FIFO",
                   help="vorticity-source FIFO (per-step flag-byte protocol)")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint .npz to resume from")
    p.add_argument("--no-record", action="store_true",
                   help="skip field records (benchmarking)")
    p.add_argument("--record-fields", default=None, metavar="NAMES",
                   help="comma list of fields to record (subset of the "
                        "model's record set, e.g. 'vort,psi'; include "
                        "'vort_src' for the forcing dump). Default: all. "
                        "Cuts record I/O volume — at 4096^2 one field is "
                        "67 MB per record step")
    p.add_argument("--debug-fields", action="store_true",
                   help="also dump dvortdx/dvortdy/dvortdt at record steps "
                        "(the reference's OUTPUT_GRAD_VORT/OUTPUT_DVORTDT "
                        "#ifdef dumps, main.cpp:156-176,216-235)")
    p.add_argument("--manifest", default="log",
                   help="manifest path (the reference's `log` file)")
    p.add_argument("--step-banners", action="store_true",
                   help="print the reference's per-step '# Step N' stderr "
                        "banner for EVERY step (main.cpp:262-264), not "
                        "just record boundaries; intermediate steps run "
                        "inside a jitted scan, so their banners are "
                        "emitted in a burst when each segment completes")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the whole run "
                        "into DIR (view with TensorBoard's profile "
                        "plugin)")
    p.add_argument("--shard", action="store_true",
                   help="shard the run over ALL local devices "
                        "(slab decomposition; barotropic and sw only)")
    p.add_argument("--decomp", default="slab",
                   choices=["slab", "xpencil", "pencil"],
                   help="domain decomposition for --shard runs: slab "
                        "(rows over a 1-D mesh, default), xpencil (row-"
                        "sharded physical + column-sharded x-pencil "
                        "spectral state — HALF the all_to_all traffic "
                        "of slab), or true 2-D "
                        "pencil (tiles over a PxQ mesh — one inter-host "
                        "collective per transform; see --mesh-shape)")
    p.add_argument("--ensemble", type=int, default=0, metavar="M",
                   help="run an M-member perturbed-IC ensemble in ONE "
                        "vmap-batched program (barotropic/sw/tracer): "
                        "member 0 is the unperturbed control; each member "
                        "records into output/mNN/ with the reference file "
                        "layout. New capability — the reference needs M "
                        "serial runs for this.")
    p.add_argument("--ensemble-amp", type=float, default=0.05,
                   help="IC perturbation amplitude relative to rms(vort0) "
                        "(band-limited spectral noise; 0 = identical "
                        "members)")
    p.add_argument("--ensemble-seed", type=int, default=0,
                   help="PRNG seed for the ensemble IC perturbations "
                        "(deterministic member set)")
    p.add_argument("--ensemble-width", type=int, default=None,
                   help="members advanced per vmap chunk (lax.map over "
                        "chunks). Default: full batch <=256^2, 8 at "
                        "512^2, sequential >=768^2 "
                        "(models/ensemble.py:auto_vmap_width); must "
                        "divide M")
    p.add_argument("--mesh-shape", default=None, metavar="PxQ",
                   help="2-D mesh shape for --decomp pencil, e.g. 2x4 "
                        "(default: n_processes x local_devices, or 1xN "
                        "single-process)")
    args = p.parse_args(argv)

    record_only = None
    if args.record_fields is not None:
        record_only = [s.strip() for s in args.record_fields.split(",")
                       if s.strip()]
        if not record_only:
            # an empty list would silently record NOTHING (including
            # vort_src) — the typo class _gather_fields guards against
            p.error("--record-fields got an empty list; name at least "
                    "one field (e.g. vort,psi) or omit the flag to "
                    "record everything")

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    if args.shard:
        # no-op unless XFB_COORDINATOR/XFB_MULTIHOST env is configured
        from ..parallel import initialize_multihost
        initialize_multihost()

    cfg = config_from_args(args)
    recipe, src_path = "empty", None
    if args.script and args.fifo:
        p.error("give at most one of -s / -f")
    if args.script:
        recipe, src_path = "script", args.script
    if args.fifo:
        recipe, src_path = "fifo", args.fifo

    print("##### Model setting #####", file=sys.stderr)
    print(f"Initial file          : {cfg.init_file}", file=sys.stderr)
    print(f"Input folder          : {cfg.input_dir}", file=sys.stderr)
    print(f"Output folder         : {cfg.output_dir}", file=sys.stderr)
    print(f"Grid                  : {cfg.nx} x {cfg.ny}", file=sys.stderr)
    print(f"Length X              : {cfg.lx:.3f} [m]", file=sys.stderr)
    print(f"Length Y              : {cfg.ly:.3f} [m]", file=sys.stderr)
    print(f"Time Resolution dt    : {cfg.dt:.3f} [s]", file=sys.stderr)
    print(f"Steps                 : {cfg.total_steps}", file=sys.stderr)
    import jax
    devs = jax.devices()
    print(f"Device                : {devs[0].platform} "
          f"{devs[0].device_kind} x {len(devs)}", file=sys.stderr)
    print("#########################", file=sys.stderr)

    mesh_shape = None
    if args.mesh_shape:
        try:
            mesh_shape = tuple(int(v) for v in
                               args.mesh_shape.lower().split("x"))
            assert len(mesh_shape) == 2
        except (ValueError, AssertionError):
            p.error(f"--mesh-shape must look like 2x4, got "
                    f"{args.mesh_shape!r}")

    from ..runner import run

    import contextlib
    scope = contextlib.nullcontext()
    if args.profile_dir:
        from ..utils.profiling import trace
        scope = trace(args.profile_dir)
    with scope:
        result = run(cfg, recipe=recipe, src_path=src_path,
                     record=not args.no_record,
                     manifest_path=args.manifest,
                     progress=True, resume_from=args.resume_from,
                     model_kind=args.model, shard=args.shard,
                     decomp=args.decomp,
                     mesh_shape=mesh_shape,
                     debug_fields=args.debug_fields,
                     tracer_kappa=args.tracer_kappa,
                     tracer_ic=args.tracer_ic,
                     ensemble=args.ensemble,
                     ensemble_amp=args.ensemble_amp,
                     ensemble_seed=args.ensemble_seed,
                     ensemble_width=args.ensemble_width,
                     step_banners=args.step_banners,
                     record_only=record_only)
    sps = result.steps_run / max(result.wall_time, 1e-9)
    gpps = sps * cfg.grids
    print(f"Ran {result.steps_run} steps in {result.wall_time:.2f}s "
          f"({sps:.1f} steps/s, {gpps:.3e} grid-points/s)", file=sys.stderr)
    print("Program ends. Congrats!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
