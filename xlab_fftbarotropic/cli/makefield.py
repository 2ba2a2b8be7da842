"""`xfb-makefield` — initial-condition generator CLI.

One binary replacing the reference's four makefield-*.out executables
(/root/reference/src/makefield-{gaussian,const-vortex,elliptic-vortex,
Kuo2004}.cpp): writes input_dir/init_file as raw float32, byte-compatible
with the reference's writeField output.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from ..config import add_config_args, config_from_args
    from ..ic.makefields import GENERATORS, make
    from ..io.fieldio import write_field

    p = argparse.ArgumentParser(prog="xfb-makefield")
    p.add_argument("name", choices=sorted(GENERATORS),
                   help="which initial condition to generate")
    add_config_args(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    field = make(args.name, cfg)
    out = Path(cfg.input_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / cfg.init_file
    write_field(path, field)
    print(f"Output {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
