"""Where the persistent compilation cache lives: JAX_COMPILATION_CACHE_DIR
when it is set (and no other directory), else <checkout>/.jax_cache."""
import os

import jax
import pytest

from tensorkrylov.utils import cache


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_dir_from_env(tmp_path, monkeypatch, restore_cache_dir):
    target = tmp_path / "x"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert cache.enable_compilation_cache() == str(target)
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert target.is_dir()
    assert not os.path.exists(os.path.join(str(tmp_path), ".jax_cache"))


def test_cache_dir_default_is_checkout_root(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expected = os.path.join(root, ".jax_cache")
    assert cache.cache_dir() == expected
    assert cache.enable_compilation_cache() == expected
    assert jax.config.jax_compilation_cache_dir == expected
