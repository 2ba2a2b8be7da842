"""`xfb-invert-pres` — batch pressure inversion CLI.

Drop-in for invert_pres.out (/root/reference/src/invert_pres.cpp:114-188):
reads "psi_in=>pres_out" lines from stdin (the perl-rewritten manifest
pipeline, test/01-runtest/invert.sh:1), inverts the nonlinear balance
equation for each, writes raw float32 pressure fields. Flags -x/-y select
the anchor grid point (invert_pres.cpp:71-80).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from ..config import add_config_args, config_from_args
    from ..diagnostics.invert_pres import PressureInverter
    from ..io.fieldio import read_field, write_field
    import numpy as np

    p = argparse.ArgumentParser(prog="xfb-invert-pres")
    p.add_argument("-x", dest="ref_x", type=int, default=0)
    p.add_argument("-y", dest="ref_y", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    add_config_args(p)
    args = p.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    cfg = config_from_args(args)

    inverter = PressureInverter(cfg, ref_x=args.ref_x, ref_y=args.ref_y)
    for raw in sys.stdin:
        line = raw.strip()
        if not line:
            continue
        if "=>" not in line:
            # reference prints and continues (invert_pres.cpp:127-129)
            print(f"Error reading input: {line}. Continue next line...",
                  file=sys.stderr)
            continue
        from_file, to_file = (s.strip() for s in line.split("=>", 1))
        psi = read_field(from_file, cfg.grid_shape)
        pres = np.asarray(inverter(psi))
        write_field(to_file, pres)
    print("Program ends. Congrats!", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
