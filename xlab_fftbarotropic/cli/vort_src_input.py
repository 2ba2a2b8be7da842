"""`xfb-vort-src-input` — forcing stream producer.

Drop-in for vort_src_input.out (/root/reference/src/vort_src_input.cpp):
emits the per-step flag-byte protocol on stdout (pipe into a FIFO consumed
by `xfb-run -f`). Scenario: Kuo2004 cake source pulse over [2 h, 5 h]
(vort_src_input.cpp:35-61).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    # the forcing producer computes with numpy alone and never imports
    # JAX, so it cannot claim the accelerator its consumer runs on
    from ..config import add_config_args, config_from_args
    from ..forcing.source import kuo2004_pulse_stream, write_step

    p = argparse.ArgumentParser(prog="xfb-vort-src-input")
    add_config_args(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    out = sys.stdout.buffer
    for field in kuo2004_pulse_stream(cfg):
        write_step(out, field)
    print("###### input program ends ######", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
