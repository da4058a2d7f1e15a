"""Multi-host (multi-process) compression tests.

The BASELINE scaling target is 2+ hosts; the reference has no multi-node
layer at all (it is a single-process library), so this is surface
beyond parity. The real code path — ``jax.distributed`` init,
per-host contiguous block ranges, rank-ordered stitch with cross-host
checksum combine — runs as N actual OS processes on the CPU backend.
"""

import gzip
import io
import os
import socket
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from gzp_tpu import Bgzf, Gzip, Mgzip, Zlib
from gzp_tpu.parallel.multihost import (
    ShardResult,
    _worker_args,
    compress_shard,
    init_distributed,
    shard_ranges,
    stitch_shards,
)

REPO = Path(__file__).resolve().parent.parent


def make_text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"multi host stitching test ", b"rank ordered payloads ", b"01234567"]
    reps, total = [], 0
    while total < n:
        reps.append(words[rng.integers(0, len(words))])
        total += len(reps[-1])
    return b"".join(reps)[:n]


def test_shard_ranges_cover_exactly():
    for total, bs, k in ((1000, 100, 3), (5, 100, 2), (0, 64, 2), (1 << 20, 32768, 4)):
        rng = shard_ranges(total, bs, k)
        assert rng[0][0] == 0 and rng[-1][1] == total
        for (s0, e0), (s1, e1) in zip(rng, rng[1:]):
            assert e0 == s1
            assert s0 % bs == 0


@pytest.mark.parametrize("fmt,decode", [
    (Mgzip, gzip.decompress),
    (Gzip, gzip.decompress),
    (Zlib, zlib.decompress),
])
def test_inprocess_shard_stitch(fmt, decode):
    """Shard + stitch inside one process: byte-stream validity across all
    shard boundaries including the 32 KiB dict carry (Gzip/Zlib)."""
    data = make_text(300_000, seed=1)
    shards = [
        compress_shard(fmt, data, r, 3, buffer_size=32768, num_threads=2)
        for r in range(3)
    ]
    out = io.BytesIO()
    stitch_shards(fmt, shards, out)
    assert decode(out.getvalue()) == data


def test_inprocess_shard_stitch_bgzf():
    data = make_text(200_000, seed=2)
    shards = [compress_shard(Bgzf, data, r, 2, num_threads=2) for r in range(2)]
    out = io.BytesIO()
    stitch_shards(Bgzf, shards, out)
    from gzp_tpu import ParDecompress

    assert ParDecompress(Bgzf, io.BytesIO(out.getvalue()), num_threads=2).read() == data
    # trailer: byte-exact BGZF EOF marker at the end
    from gzp_tpu.constants import BGZF_EOF

    assert out.getvalue().endswith(BGZF_EOF)


def test_shard_result_roundtrip():
    s = ShardResult(3, b"payload", 0xDEADBEEF, 12345)
    s2 = ShardResult.from_bytes(s.to_bytes())
    assert (s2.rank, s2.payload, s2.check_sum, s2.check_amount) == (
        3, b"payload", 0xDEADBEEF, 12345,
    )


@pytest.mark.parametrize("flag,want", [(None, None), ("1", [1]), ("2,3", [2, 3])])
def test_worker_local_device_ids(flag, want, monkeypatch):
    """``--local-device-ids`` reaches ``jax.distributed.initialize``, so
    processes that share a machine each open only their own cards."""
    import jax

    argv = ["--coordinator", "localhost:1", "--num-processes", "2", "--rank", "1",
            "--input", "i", "--output", "o"]
    args = _worker_args(argv + (["--local-device-ids", flag] if flag else []))
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: seen.update(kw))
    init_distributed(args.coordinator, args.num_processes, args.rank,
                     args.local_device_ids)
    assert seen == {"coordinator_address": "localhost:1", "num_processes": 2,
                    "process_id": 1, "local_device_ids": want}


@pytest.mark.slow
def test_two_process_jax_distributed(tmp_path):
    """The real multi-process path: 2 OS processes, jax.distributed
    coordination, rank files stitched by the parent (BASELINE 2-host
    scaling target's correctness leg)."""
    data = make_text(260_000, seed=3)
    inp = tmp_path / "input.bin"
    inp.write_bytes(data)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"

    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = []
    outs = []
    for rank in range(2):
        out = tmp_path / f"shard{rank}.bin"
        outs.append(out)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "gzp_tpu.parallel.multihost",
                    "--coordinator", coord, "--num-processes", "2",
                    "--rank", str(rank), "--format", "gzip",
                    "--buffer-size", "32768",
                    "--input", str(inp), "--output", str(out),
                ],
                cwd=REPO,
                env=env,
            )
        )
    for p in procs:
        assert p.wait(timeout=600) == 0

    shards = [ShardResult.from_bytes(o.read_bytes()) for o in outs]
    buf = io.BytesIO()
    stitch_shards(Gzip, shards, buf)
    assert gzip.decompress(buf.getvalue()) == data
