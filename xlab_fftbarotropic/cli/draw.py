"""CLI: render record-step PNGs from a run's output directory.

Replaces the reference's test/01-runtest/draw.sh + plot/draw_figs.py pair
(which duplicated — and let drift — the grid constants in plot/config.py;
SURVEY.md §5.10-5). Usage:

    python -m xlab_fftbarotropic.cli.draw -O output --fig-dir output_fig \
        --nx 768 --ny 768 --wind streamline --start-step 0
"""

from __future__ import annotations

import argparse

from ..config import add_config_args, config_from_args
from ..viz.plots import draw_run


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="xfb-draw")
    add_config_args(ap)
    ap.add_argument("--fig-dir", default="output_fig")
    ap.add_argument("--wind", choices=["streamline", "barb", "none"],
                    default="streamline")
    ap.add_argument("--start-step", type=int, default=0)
    ap.add_argument("--dpi", type=int, default=100)
    ap.add_argument("--spectra", action="store_true",
                    help="render spectrum_step_*.txt (xfb-diagnose -d "
                         "spectrum output) as log-log E(k)/Z(k) PNGs "
                         "instead of field figures")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    if args.spectra:
        from ..viz.plots import draw_spectra
        made = draw_spectra(args.output_dir, args.fig_dir,
                            dpi=args.dpi, progress=True)
        if not made:
            raise SystemExit(
                f"no spectrum_step_*.txt found in {args.output_dir}")
        return
    made = draw_run(cfg, args.output_dir, args.fig_dir,
                    start_step=args.start_step, wind=args.wind,
                    dpi=args.dpi, progress=True)
    if not made:
        raise SystemExit(f"no record steps found in {args.output_dir}")


if __name__ == "__main__":
    main()
