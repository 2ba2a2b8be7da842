"""`xfb-find-min` — field minima CLI.

Drop-in for find_min.out (/root/reference/src/find_min.cpp:67-99): reads
field filenames from stdin (one per line; the `ls output | grep pres_step`
pipeline, test/01-runtest/invert.sh:2), prints the 30 smallest values as
"x y value" lines.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from ..config import add_config_args, config_from_args
    from ..diagnostics.find_min import find_min_n, format_minima
    from ..io.fieldio import read_field

    p = argparse.ArgumentParser(prog="xfb-find-min")
    p.add_argument("-n", "--num", type=int, default=30,
                   help="number of minima (reference default 30)")
    p.add_argument("--tracks", default=None, metavar="FILE",
                   help="also associate each file's minima into vortex "
                        "tracks (periodic nearest-neighbor across files, "
                        "diagnostics/tracks.py) and write 'track_id step "
                        "x y value' lines to FILE; the step index is "
                        "parsed from '*_step_N.bin' filenames")
    p.add_argument("--cluster-radius", type=float, default=8.0,
                   help="grid-cell radius treated as one vortex well "
                        "when clustering a file's minima (--tracks)")
    p.add_argument("--max-jump", type=float, default=64.0,
                   help="largest per-file core displacement (grid "
                        "cells, periodic) still the same track "
                        "(--tracks)")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    add_config_args(p)
    args = p.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    cfg = config_from_args(args)

    import re

    records = []
    print("Entering find_min program.", file=sys.stderr)
    for raw in sys.stdin:
        fname = raw.strip()
        if not fname:
            continue
        data = read_field(fname, cfg.grid_shape)
        print(f"File {fname} read.", file=sys.stderr)
        x, y, vals = find_min_n(data, args.num)
        print(format_minima(x, y, vals))
        if args.tracks is not None:
            m = re.search(r"_step_(\d+)\b", fname)
            step = int(m.group(1)) if m else None
            records.append((step, x, y, vals))
    if args.tracks is not None:
        from ..diagnostics.tracks import build_tracks, format_tracks
        # Step indices come from the '_step_N' filename convention
        # (SURVEY §5.9 output contract). Mixing parsed steps with
        # positional fallbacks silently corrupts track ordering (the
        # synthetic indices can interleave real ones — round-3 ADVICE),
        # so the fallback applies only when NO filename parses.
        n_parsed = sum(1 for r in records if r[0] is not None)
        if 0 < n_parsed < len(records):
            bad = [i for i, r in enumerate(records) if r[0] is None]
            print(f"find_min: --tracks needs a '_step_N' step index in "
                  f"every filename or in none; {len(bad)} of "
                  f"{len(records)} record(s) did not parse.",
                  file=sys.stderr)
            return 2
        if n_parsed == 0:       # stdin order defines the time axis
            records = [(i,) + r[1:] for i, r in enumerate(records)]
        records.sort(key=lambda r: r[0])
        tracks = build_tracks(records, cfg.nx, cfg.ny,
                              cluster_radius=args.cluster_radius,
                              max_jump=args.max_jump)
        with open(args.tracks, "w") as f:
            f.write(format_tracks(tracks) + "\n")
        print(f"Wrote {len(tracks)} track(s) to {args.tracks}.",
              file=sys.stderr)
    print("find_min program ends. Congrats!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
