"""JAX's persistent compilation cache at one fixed place.

A 4096^2 step takes tens of seconds to compile; the persistent cache lets
a second process with the same program load it instead. The cache key
includes the directory, so the directory must not move between runs:
it is `JAX_COMPILATION_CACHE_DIR` when that variable is set (JAX reads it
itself, and this module then sets nothing; an empty value disables the
cache), and otherwise `<repo>/.jax_cache`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ=None) -> Optional[Path]:
    """The directory enable_compile_cache would set, or None when the
    environment already decides (ENV present, even empty)."""
    environ = os.environ if environ is None else environ
    if ENV in environ:
        return None
    return DEFAULT_DIR


def enable_compile_cache() -> Optional[Path]:
    """Point JAX's persistent compilation cache at compile_cache_dir().
    Call before the first compilation; returns the directory set, or
    None when ENV governs."""
    path = compile_cache_dir()
    if path is not None:
        import jax
        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
