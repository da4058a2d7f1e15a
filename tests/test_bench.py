"""bench.py's own checks: any decode mismatch, and a missing GPU, fail
the run."""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench


def _members(data):
    blobs = [gzip.compress(row.tobytes(), 0) for row in data]  # stored: bytes verbatim
    m = max(map(len, blobs))
    out = np.zeros((len(blobs), m), np.uint8)
    for i, b in enumerate(blobs):
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out, np.array([len(b) for b in blobs], np.int32)


def test_validate_members_raises_on_one_flipped_literal():
    data = np.frombuffer(bench.make_corpus(4 * 4096), np.uint8).reshape(4, 4096)
    out, out_len = _members(data)
    bench._validate_members(out, out_len, data, 4, "clean")  # passes
    i = out_len[2] - 8 - 100  # a literal byte inside member 2's stored payload
    out[2, i] ^= 1
    with pytest.raises((gzip.BadGzipFile, AssertionError)):
        bench._validate_members(out, out_len, data, 4, "flipped")


def test_make_corpus_is_seeded():
    a = bench.make_corpus(10000)
    assert a == bench.make_corpus(10000) and len(a) == 10000
    assert bench.make_corpus(10000, seed=1) != a


def test_refuses_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "bench.py", "--batch", "2", "--block", "4096", "--reps", "1"],
        cwd=Path(__file__).resolve().parent.parent, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"metric"' not in r.stdout and "_info" not in r.stdout
    assert "bench needs a GPU" in r.stderr
