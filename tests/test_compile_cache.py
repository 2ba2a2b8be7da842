"""utils/compile_cache.py: JAX's persistent compilation cache lives where
JAX_COMPILATION_CACHE_DIR says, or at the fixed <repo>/.jax_cache."""

import tempfile
from pathlib import Path

import jax
import pytest

from xlab_fftbarotropic.utils import compile_cache as cc

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("value", ["/some/cache", ""])
def test_env_set_decides(value):
    """Present (even empty, which disables the cache): the helper sets
    nothing and leaves the choice to JAX."""
    assert cc.compile_cache_dir({cc.ENV: value}) is None


def test_env_unset_uses_fixed_repo_path():
    path = cc.compile_cache_dir({})
    assert path == REPO / ".jax_cache"
    # a fixed path: never under the temporary directory, and the same on
    # every call (the directory is part of the cache key)
    assert not str(path).startswith(tempfile.gettempdir())
    assert cc.compile_cache_dir({}) == path


def test_enable_sets_jax_config(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(cc.ENV, raising=False)
    try:
        assert cc.enable_compile_cache() == REPO / ".jax_cache"
        assert jax.config.jax_compilation_cache_dir == str(
            REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_enable_leaves_config_when_env_set(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cc.ENV, "/elsewhere")
    assert cc.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
