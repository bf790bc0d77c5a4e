"""Placement of JAX's persistent compilation cache."""

import os

import jax
import pytest

from radioframe.core import compile_cache


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_decides(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_default_inside_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.use_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(compile_cache.__file__)))
    assert path == os.path.join(os.path.dirname(root), ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(os.path.dirname(root), ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
