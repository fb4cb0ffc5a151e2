"""The persistent compile cache helper honours JAX_COMPILATION_CACHE_DIR
and otherwise uses a fixed ``.jax_cache/`` at the repository root."""

import os

import jax

from idiaptts_tpu.utils import compile_cache


def _spy_config(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_is_used_and_nothing_else_set(monkeypatch, tmp_path):
    calls = _spy_config(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_is_dot_jax_cache_at_repo_root(monkeypatch):
    calls = _spy_config(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(compile_cache.REPO_ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert os.path.isfile(os.path.join(compile_cache.REPO_ROOT,
                                       "chip_smoke.py"))


def test_gitignore_lists_the_cache():
    with open(os.path.join(compile_cache.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
