"""CLI: batch diagnostics over recorded vorticity fields.

The three README-advertised diagnostics the reference never implemented
(README.md:4-7; verified absent, SURVEY.md §5.10-7) — filamentation time,
deformation factor, effective eddy diffusivity — plus Okubo-Weiss, computed
from vort_step_*.bin files. Batch-driven like the reference post-processors
(invert_pres.cpp:114-130): filenames on stdin, one output per input.

    ls -v output | grep vort_step | awk '{print "output/" $1}' | \
        python -m xlab_fftbarotropic.cli.diagnose --nx 768 --ny 768 \
            -d filamentation -O output

writes output/filamentation_step_N.bin (+ a scalar summary line to stdout).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from ..config import add_config_args, config_from_args
    from ..diagnostics import eddy_diffusivity as ed
    from ..diagnostics import kinematics as kin
    from ..io.fieldio import read_field, write_field
    from ..ops import fft
    from ..ops.spectral import SpectralTables

    ap = argparse.ArgumentParser(prog="xfb-diagnose")
    add_config_args(ap)
    ap.add_argument("-d", "--diagnostic", action="append", required=True,
                    choices=["filamentation", "okubo-weiss", "deformation",
                             "eddy-diffusivity", "spectrum"],
                    help="may be given multiple times; 'spectrum' writes "
                         "a 3-column text file (k [1/m], E(k), Z(k) — "
                         "isotropic shell-averaged energy/enstrophy, "
                         "diagnostics/spectra.py) instead of a .bin field")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    t = SpectralTables.from_config(cfg)
    outdir = Path(cfg.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)

    outname = {"filamentation": "filamentation", "okubo-weiss": "okuboweiss",
               "deformation": "deformation",
               "eddy-diffusivity": "eddydiff"}

    for raw in sys.stdin:
        path = raw.strip()
        if not path or path.startswith("#"):
            continue
        vort = read_field(path, cfg.grid_shape)
        zeta_hat = fft.forward(jnp.asarray(vort))
        stem = Path(path).name
        step = stem.rsplit("_", 1)[-1].replace(".bin", "")
        for d in args.diagnostic:
            if d == "spectrum":
                from ..diagnostics.spectra import energy_enstrophy_spectrum
                sp_ = energy_enstrophy_spectrum(t, zeta_hat, cfg)
                out = outdir / f"spectrum_step_{step}.txt"
                np.savetxt(out, np.column_stack([np.asarray(sp_.k),
                                                 np.asarray(sp_.energy),
                                                 np.asarray(sp_.enstrophy)]),
                           header="k[1/m] E(k) Z(k)")
                print(f"{d} {path} -> {out} "
                      f"summary={float(np.asarray(sp_.energy).sum()):.6e}")
                continue
            if d == "filamentation":
                field = np.asarray(kin.filamentation_time(
                    t, zeta_hat, cfg.grid_shape))
                finite = field[np.isfinite(field)]
                summary = float(np.median(finite)) if finite.size else np.inf
            elif d == "okubo-weiss":
                field = np.asarray(kin.okubo_weiss(t, zeta_hat,
                                                   cfg.grid_shape))
                summary = float(field.min())
            elif d == "deformation":
                field = np.asarray(kin.deformation_factor(
                    t, zeta_hat, cfg.grid_shape))
                summary = float(field.max())
            else:  # eddy-diffusivity: per-level Nakamura profile (nbins,)
                r = ed.effective_diffusivity(t, jnp.asarray(vort),
                                             cfg.dx, cfg.dy)
                field = np.asarray(r.kappa_ratio)
                summary = float(np.nanmean(field))
            out = outdir / f"{outname[d]}_step_{step}.bin"
            write_field(out, np.where(np.isfinite(field), field,
                                      0.0).astype(np.float32))
            print(f"{d} {path} -> {out} summary={summary:.6e}")


if __name__ == "__main__":
    main()
