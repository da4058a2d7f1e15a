"""Stdlib-oracle roundtrips at the reference's real block widths.

Each case streams ~2.5 blocks through ``ZBuilder`` with two blocks per
device batch, so the second batch is a padded tail and, for the stream
formats, the 32 KiB dictionary carry crosses a batch boundary. Widths
are those the GPU smoke check runs (reference benches use 128 KiB
blocks; BGZF caps input blocks at 65280 bytes; snappy frames at 64 KiB).
"""

import gzip
import io
import zlib

import numpy as np
import pytest

from bench import make_corpus
from gzp_tpu import Bgzf, Gzip, Mgzip, ParDecompress, RawDeflate, Snap, ZBuilder, Zlib
from gzp_tpu.utils.snappy_ref import decode_frames

KIB = 1024


def _decode(fmt, out: bytes) -> bytes:
    if fmt in (Mgzip, Gzip, Bgzf):
        return gzip.decompress(out)
    if fmt is Zlib:
        return zlib.decompress(out)
    if fmt is RawDeflate:
        return zlib.decompress(out, wbits=-15)
    return decode_frames(out)


@pytest.mark.parametrize(
    "fmt,level,block,random_share",
    [
        (Mgzip, 3, 128 * KIB, False),
        (Gzip, 6, 128 * KIB, False),
        (Bgzf, 6, 65280, True),
        (Zlib, 9, 128 * KIB, False),
        (RawDeflate, 1, 128 * KIB, False),
        (Snap, 3, 64 * KIB, False),
    ],
    ids=["mgzip-l3", "gzip-l6-halo", "bgzf-l6-random", "zlib-l9", "deflate-l1", "snappy"],
)
def test_real_width_roundtrip(fmt, level, block, random_share):
    n = 2 * block + block // 2
    data = make_corpus(n, seed=level)
    if random_share:  # one incompressible block: stored fallback + size cap
        rnd = np.random.default_rng(5).integers(0, 256, block, np.uint8).tobytes()
        data = data[:block] + rnd + data[2 * block :]
    buf = io.BytesIO()
    w = ZBuilder(fmt).num_threads(2).compression_level(level).buffer_size(block).from_writer(buf)
    w.write(data)
    w.finish()
    out = buf.getvalue()
    assert _decode(fmt, out) == data
    if fmt is Bgzf:
        r = ParDecompress(Bgzf, io.BytesIO(out), num_threads=2)
        assert r.read() == data
        r.close()
    if not random_share:
        assert len(out) < len(data) // 2  # seeded text compresses
