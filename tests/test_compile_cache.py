"""Where the persistent compilation cache lives."""

from pathlib import Path

import jax

from gzp_tpu.utils import testing

REPO = Path(__file__).resolve().parent.parent


def test_env_dir_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert testing.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_inside_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = testing.enable_compilation_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


_CACHE_OFF_SCRIPT = """
import os, sys
import jax, jax.numpy as jnp
from gzp_tpu.utils.testing import enable_compilation_cache, persistent_cache_off

d = enable_compilation_cache()
def entries():
    return len(os.listdir(d)) if os.path.isdir(d) else 0
jax.jit(lambda x: x + 1)(jnp.ones(3)).block_until_ready()
n0 = entries()
with persistent_cache_off():
    jax.jit(lambda x: x * 3)(jnp.ones(5)).block_until_ready()
n1 = entries()
jax.jit(lambda x: x - 7)(jnp.ones(7)).block_until_ready()
print(n0, n1, entries())
"""


def test_persistent_cache_off_writes_nothing(tmp_path):
    """Programs compiled inside ``persistent_cache_off`` leave no cache
    entry; the cache works again after the block."""
    import os
    import subprocess
    import sys

    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    r = subprocess.run([sys.executable, "-c", _CACHE_OFF_SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    n0, n1, n2 = map(int, r.stdout.split())
    assert n0 > 0 and n1 == n0 and n2 > n1
