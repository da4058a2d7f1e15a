"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh (the way the reference's proptests
sweep ``num_threads``, reference README.md:146-155); the GPU path is
exercised by ``chip_smoke.py``. This must run before any JAX backend
initialization.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

from gzp_tpu.utils.testing import enable_compilation_cache  # noqa: E402

# Persistent compilation cache for the CPU suite (JAX_COMPILATION_CACHE_DIR
# when set, else <checkout>/.jax_cache_cpu). Two reasons: (a) the suite
# compiles ~100 distinct executables and XLA:CPU's LLVM backend has
# segfaulted after enough in-process compilations — cache hits skip LLVM
# entirely on warm runs; (b) warm runs are several times faster. See also
# pytest.ini: -p xdist --dist loadfile splits cold-run compilations across
# worker processes, which keeps each process under the crash threshold.
enable_compilation_cache(
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache_cpu")
)

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices()
    assert devs[0].platform == "cpu"
    return devs


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Drop live jitted executables between test modules.

    XLA:CPU has segfaulted once a process accumulates enough loaded
    executables (~100; once inside backend_compile_and_load, once inside
    the compilation-cache deserializer). The suite compiles
    O(100) distinct programs, so each module's executables are released
    at module end; the persistent compilation cache (above) makes any
    cross-module re-use a fast disk load instead of an LLVM recompile.
    """
    yield
    from gzp_tpu.ops import deflate_kernel, inflate_kernel, snappy_kernel

    deflate_kernel.get_encoder.cache_clear()
    snappy_kernel.get_snappy_encoder.cache_clear()
    inflate_kernel.get_inflater.cache_clear()
    jax.clear_caches()
    gc.collect()
