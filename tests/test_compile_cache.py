"""The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR
says, or else at the fixed <checkout>/.jax_cache."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from nhwcodec_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent


def test_cache_dir_unset_is_checkout(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(REPO / ".jax_cache")
    assert compile_cache.cache_dir() == want
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


_CODE = """
import jax, jax.numpy as jnp
from nhwcodec_tpu.utils.compile_cache import enable_compile_cache
print(enable_compile_cache())
assert jax.config.jax_compilation_cache_dir == {d!r}
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(8)).block_until_ready()
"""


def test_cache_dir_env_set_is_the_only_one(tmp_path):
    """With the variable set, compiled programs land in that directory."""
    d = str(tmp_path / "cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=d)
    r = subprocess.run([sys.executable, "-c", _CODE.format(d=d)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == d
    assert any(Path(d).iterdir())
