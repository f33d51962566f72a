"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set,
otherwise one fixed, git-ignored directory inside the checkout."""

import os

from data_compression_tpu.utils import jit_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jit_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_dir_with_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jit_cache.cache_dir() is None  # JAX reads the variable itself


def test_enable_sets_only_the_checkout_dir(monkeypatch):
    import jax

    seen = {}
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jit_cache, "_done", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    jit_cache.enable_persistent_cache()
    jit_cache.enable_persistent_cache()  # idempotent
    assert seen["jax_compilation_cache_dir"] == jit_cache.CHECKOUT_DIR

    seen.clear()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere")
    monkeypatch.setattr(jit_cache, "_done", False)
    jit_cache.enable_persistent_cache()
    assert seen == {}
