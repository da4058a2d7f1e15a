"""Shared helpers for scripts and tests: compile cache and CPU backend."""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

# <checkout>/.jax_cache: fixed relative to the package, so every process
# of one checkout shares (and finds again) the same cache
DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compilation_cache(default: str = DEFAULT_CACHE_DIR) -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself and
    no other directory is set here); otherwise the cache lives at
    ``default``. Every compiled program is cached, however fast it
    compiled. Call before the first jit compilation.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = default
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


@contextlib.contextmanager
def persistent_cache_off():
    """Compile without the persistent cache inside the block: nothing is
    read from it or written to it.

    For XLA:CPU programs in a process whose cache may be shared with
    other machines: a CPU executable is built for this host's
    instruction set, and loading it on another host type can crash.
    """
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    was = jax.config.jax_enable_compilation_cache
    cc.reset_cache()  # JAX decides once whether to use the cache; ask again
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        cc.reset_cache()


def force_cpu_backend(num_devices: int = 8) -> None:
    """Force JAX onto ``num_devices`` virtual CPU devices.

    Must be called before the first JAX backend initialization.
    """
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={num_devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
