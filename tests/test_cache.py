"""Persistent compilation cache location (utils/cache.py)."""
import os

import jax

from optixpathtracer.utils import cache


def test_env_dir_is_used_as_is(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache.enable_compilation_cache() == str(tmp_path / "c")
    assert calls == []


def test_default_dir_is_inside_the_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path.startswith(os.path.join(repo, ".jax_cache") + os.sep)
    assert os.path.isdir(path)
    assert ("jax_compilation_cache_dir", path) in calls
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
