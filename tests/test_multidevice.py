"""Multi-device sharded compression on the virtual 8-CPU mesh — the
device analog of the reference's multi-thread proptests (SURVEY.md §4:
"parameterize tests over device counts")."""

import gzip
import io

import jax
import numpy as np
import pytest

from gzp_tpu import Bgzf, Gzip, Mgzip, Snap, ZBuilder
from gzp_tpu.constants import DICT_SIZE


def make_text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"lorem ipsum dolor sit amet ", b"consectetur adipiscing elit "]
    reps, total = [], 0
    while total < n:
        w = words[rng.integers(0, len(words))]
        reps.append(w)
        total += len(w)
    return b"".join(reps)[:n]


@pytest.mark.parametrize("ndev", [2, 8])
def test_mesh_sharded_compress(ndev, cpu_devices):
    devices = cpu_devices[:ndev]
    mesh = jax.sharding.Mesh(np.array(devices), ("blocks",))
    data = make_text(DICT_SIZE * 3 * ndev + 1234, seed=ndev)
    buf = io.BytesIO()
    w = (
        ZBuilder(Mgzip)
        .num_threads(ndev * 2)
        .buffer_size(DICT_SIZE)
        .mesh(mesh)
        .from_writer(buf)
    )
    w.write(data)
    w.finish()
    assert gzip.decompress(buf.getvalue()) == data


def test_mesh_output_matches_single_device(cpu_devices):
    """Sharding must not change emitted bytes (ordered reassembly)."""
    data = make_text(DICT_SIZE * 7, seed=42)
    outs = []
    for mesh in [None, jax.sharding.Mesh(np.array(cpu_devices[:4]), ("blocks",))]:
        buf = io.BytesIO()
        b = ZBuilder(Gzip).num_threads(4).buffer_size(DICT_SIZE)
        if mesh is not None:
            b = b.mesh(mesh)
        w = b.from_writer(buf)
        w.write(data)
        w.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("fmt,level", [(Gzip, 6), (Bgzf, 6), (Snap, 3)],
                         ids=["gzip-halo", "bgzf", "snappy"])
def test_four_device_mesh_matches_one_device(fmt, level, cpu_devices):
    """The ``chip_smoke.py --four`` check on virtual devices: a writer
    sharded over a 4-device mesh emits the same bytes as one device,
    across several batches (the halo carry crosses batch boundaries)."""
    data = make_text(DICT_SIZE * 19 + 777, seed=level)
    if fmt is Bgzf:  # one incompressible block: stored fallback
        rnd = np.random.default_rng(1).integers(0, 256, DICT_SIZE, np.uint8).tobytes()
        data = data[: 5 * DICT_SIZE] + rnd + data[6 * DICT_SIZE :]
    outs = []
    for mesh in [None, jax.sharding.Mesh(np.array(cpu_devices[:4]), ("blocks",))]:
        buf = io.BytesIO()
        b = ZBuilder(fmt).num_threads(4).compression_level(level).buffer_size(DICT_SIZE)
        w = b.mesh(mesh).from_writer(buf)
        w.write(data)
        w.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    if fmt is Snap:
        from gzp_tpu.utils.snappy_ref import decode_frames

        assert decode_frames(outs[1]) == data
    else:
        assert gzip.decompress(outs[1]) == data
