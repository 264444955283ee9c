"""Compile-cache directory resolution (utils/cache.py)."""

import os

import jax

from dr3_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _enable(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    return cache.enable_persistent_cache(), calls


def test_default_is_checkout_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d, calls = _enable(monkeypatch)
    assert d == os.path.join(ROOT, ".jax_cache") == cache.cache_dir()
    assert calls["jax_compilation_cache_dir"] == d


def test_env_var_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    d, calls = _enable(monkeypatch)
    assert d == str(tmp_path) == cache.cache_dir()
    assert "jax_compilation_cache_dir" not in calls


def test_default_dir_is_ignored_by_git():
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
