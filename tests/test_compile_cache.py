"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it
is set and sits at the fixed <checkout>/.jax_cache otherwise."""

import os

import jax
import pytest

from gr_dtl_jax.utils import compile_cache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, tmp_path, monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv(compile_cache.CACHE_DIR_ENV, str(tmp_path))
    else:
        monkeypatch.delenv(compile_cache.CACHE_DIR_ENV, raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        if env_set:
            # JAX reads the variable itself: nothing else is set
            assert path == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert path == os.path.join(CHECKOUT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            # fixed: the same path on every call, whatever the process
            assert compile_cache.enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
