"""Device compute kernels for gzp_tpu.

This package is the equivalent of the reference's L0 native-codec layer
(zlib-ng / libdeflate / snap, see reference Cargo.toml:28-57): everything
performance-critical lives here as batched, jit-compiled JAX/XLA programs
over ``[B, N]`` blocks. Nothing in this package does host-side
Python-per-byte work on the hot path.
"""

from gzp_tpu.ops import tables  # noqa: F401
