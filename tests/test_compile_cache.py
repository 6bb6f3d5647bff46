"""Persistent compile cache location (ops/backend.enable_compile_cache).

JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins;
otherwise the cache lives at one fixed path in the checkout,
<repo>/.jax_cache, so a later process finds what an earlier one cached."""

import os

import pytest

from kmerset_tpu.ops import backend


@pytest.fixture
def cache_config():
    import jax

    prev = jax.config.jax_compilation_cache_dir
    yield jax.config
    jax.config.update("jax_compilation_cache_dir", prev)


def test_env_cache_dir_is_honoured(monkeypatch, cache_config):
    cache_config.update("jax_compilation_cache_dir", "/nonexistent/sentinel")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/tmp/kmerset_env_cache")
    backend.enable_compile_cache()
    # Nothing is set in code: the value JAX already holds stays.
    assert cache_config.jax_compilation_cache_dir == "/nonexistent/sentinel"


def test_default_cache_dir_is_fixed_in_repo(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    backend.enable_compile_cache()
    first = cache_config.jax_compilation_cache_dir
    repo = os.path.dirname(os.path.dirname(os.path.abspath(backend.__file__)))
    assert first == os.path.join(os.path.dirname(repo), ".jax_cache")
    backend.enable_compile_cache()
    assert cache_config.jax_compilation_cache_dir == first


def test_cache_dir_ignores_cpu_flags(monkeypatch, cache_config):
    """The directory is the same whatever the host CPU reports."""
    import builtins

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    backend.enable_compile_cache()
    first = cache_config.jax_compilation_cache_dir
    real_open = builtins.open

    def no_cpuinfo(path, *a, **kw):
        if str(path) == "/proc/cpuinfo":
            raise AssertionError("cache location read the CPU flags")
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", no_cpuinfo)
    backend.enable_compile_cache()
    assert cache_config.jax_compilation_cache_dir == first
    assert not hasattr(backend, "_host_cpu_fingerprint")
