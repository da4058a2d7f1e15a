"""``chip_smoke.py`` rehearsed on the CPU at tiny sizes.

The script itself needs a GPU; here its refusal without one and the
control flow of its phases (compress through ``ZBuilder``, oracle decode,
device-vs-CPU identity, compiled memory, device inflate) run on the CPU
backend.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs
from gzp_tpu import Bgzf, Gzip, Mgzip, Snap

REPO = Path(__file__).resolve().parent.parent
BLOCK = 32 * 1024


@pytest.fixture(scope="module")
def text():
    return cs.corpus(1 << 20, seed=7)


def test_refuses_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py", "--mib", "1", "--other-mib", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.mark.parametrize("fmt,level", [(Mgzip, 3), (Gzip, 6), (Snap, 3)])
def test_encode_and_identity_phases(fmt, level, text, capsys):
    data = text[: 5 * BLOCK + 123]
    out = cs.encode_phase(fmt.name, fmt, level, BLOCK, data, "cpu", threads=2)
    assert cs.oracle_decode(fmt.name, out) == data
    cs.identity_phase(fmt.name, fmt, level, BLOCK, data[: 4 * BLOCK], threads=2)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"phase {fmt.name}: in={len(data)} B")
    assert lines[1].startswith(f"identity {fmt.name}: 4 blocks")


def test_bgzf_random_share_phase(text, capsys):
    data = cs.with_random(text[: 6 * BLOCK], BLOCK, seed=1)
    assert len(data) == 6 * BLOCK and data != text[: 6 * BLOCK]
    cs.encode_phase("bgzf", Bgzf, 6, BLOCK, data, "cpu", threads=2)
    assert "decoded=oracle+ParDecompress" in capsys.readouterr().out


def test_memory_phase(capsys):
    cs.memory_phase("gzip-l6", Gzip, 6, BLOCK, threads=2)
    line = capsys.readouterr().out.strip()
    assert line.startswith("memory gzip-l6: argument=")
    assert int(line.split("temp=")[1].split()[0]) > 0


def test_device_inflate_phase(text, capsys):
    cs.device_inflate_phase(text, threads=2)
    assert "'native': 0" in capsys.readouterr().out
