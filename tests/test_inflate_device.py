"""Device batch-inflate kernel tests (run on the CPU mesh like everything else).

Oracle pattern mirrors the reference's decompression tests
(src/deflate.rs:994-1051): compress with an independent implementation
(zlib), decode with ours, assert byte equality — plus corruption and
fallback behavior (src/par/decompress.rs:174-182).
"""

import io
import zlib

import numpy as np
import pytest

from gzp_tpu import Bgzf, Mgzip, ZBuilder
from gzp_tpu.parallel.decompress import ParDecompress

from test_roundtrip import make_text


def _batch(payloads, levels, in_cap, out_cap):
    import jax.numpy as jnp

    from gzp_tpu.ops.inflate_kernel import InflateConfig, get_inflater

    b = len(payloads)
    streams = np.zeros((b, in_cap), np.uint8)
    in_lens = np.zeros(b, np.int32)
    out_lens = np.zeros(b, np.int32)
    for i, (p, lvl) in enumerate(zip(payloads, levels)):
        comp = zlib.compress(p, lvl)[2:-4]  # strip zlib header/adler
        assert len(comp) <= in_cap, "test payload too incompressible"
        streams[i, : len(comp)] = np.frombuffer(comp, np.uint8)
        in_lens[i] = len(comp)
        out_lens[i] = len(p)
    run = get_inflater(InflateConfig(in_cap=in_cap, out_cap=out_cap))
    return run(jnp.asarray(streams), jnp.asarray(in_lens), jnp.asarray(out_lens))


def test_inflate_kernel_all_block_types():
    """Dynamic (level 9), fixed-ish/dynamic (level 1), stored (level 0),
    empty, and RLE-heavy lanes decoded in one batch."""
    payloads = [
        make_text(3000, seed=1),          # dynamic Huffman
        make_text(1500, seed=2),          # dynamic, different stats
        bytes(np.random.default_rng(3).integers(0, 256, 900, endpoint=False).astype(np.uint8)),  # random -> stored block at level 0
        b"",                               # empty stream
        b"a" * 2500,                       # long RLE run (overlapping copies)
        make_text(40, seed=4),             # tiny
    ]
    levels = [9, 6, 0, 6, 6, 1]
    res = _batch(payloads, levels, in_cap=4096, out_cap=4096)
    out = np.asarray(res["out"])
    ok = np.asarray(res["ok"])
    crc = np.asarray(res["crc"])
    for i, p in enumerate(payloads):
        assert bool(ok[i]), f"lane {i} failed"
        assert out[i, : len(p)].tobytes() == p, f"lane {i} mismatch"
        assert int(crc[i]) == zlib.crc32(p), f"lane {i} crc mismatch"


def test_inflate_kernel_garbage_sets_error():
    import jax.numpy as jnp

    from gzp_tpu.ops.inflate_kernel import InflateConfig, get_inflater

    rng = np.random.default_rng(7)
    streams = rng.integers(0, 256, (2, 512), endpoint=False).astype(np.uint8)
    # lane 1: a valid stream for contrast
    good = zlib.compress(b"hello hello hello hello", 6)[2:-4]
    streams[1] = 0
    streams[1, : len(good)] = np.frombuffer(good, np.uint8)
    in_lens = np.array([512, len(good)], np.int32)
    out_lens = np.array([100, 23], np.int32)
    run = get_inflater(InflateConfig(in_cap=512, out_cap=512))
    res = run(jnp.asarray(streams), jnp.asarray(in_lens), jnp.asarray(out_lens))
    ok = np.asarray(res["ok"])
    assert not bool(ok[0])
    assert bool(ok[1])


@pytest.mark.parametrize("fmt", [Mgzip, Bgzf])
def test_pardecompress_device_backend(fmt):
    """End-to-end: our writer -> device-batched reader (reference
    test_simple_*_etoe_decompress analog, src/deflate.rs:994-1051)."""
    data = make_text(70_000, seed=11)
    buf = io.BytesIO()
    w = ZBuilder(fmt).num_threads(2).buffer_size(32768).from_writer(buf)
    w.write(data)
    w.finish()
    buf.seek(0)
    r = ParDecompress(fmt, buf, num_threads=2, backend="device")
    got = r.read()
    assert got == data


def test_device_backend_falls_back_on_oversize_block():
    """Mgzip blocks bigger than the device cap must silently take the
    native path (foreign writers can emit arbitrarily large members)."""
    data = make_text(200_000, seed=12)
    buf = io.BytesIO()
    w = ZBuilder(Mgzip).num_threads(2).buffer_size(131072).from_writer(buf)
    w.write(data)
    w.finish()
    buf.seek(0)
    r = ParDecompress(Mgzip, buf, num_threads=2, backend="device")
    assert r.read() == data
