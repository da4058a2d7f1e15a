"""Benchmark harness: device encode throughput of the Mgzip encoder.

    python bench.py [--level 3] [--batch 64] [--block 131072] [--reps 8]

Needs a GPU: a run that finds another platform fails. One process, the
only one that opens the card. It prints one JSON line each for the host
decode rate, the snappy encoder and the Mgzip encoder at the flagship
configuration (64 x 128 KiB, level 3; the last line). Every line names
the device it ran on (platform, device_kind, device count). Any failed
check raises, so the run exits non-zero and prints no result line for
that measurement.

Method: R iterations of the full batched encoder are chained INSIDE one
jitted fori_loop with a one-byte data dependency between iterations, so
XLA can neither elide nor overlap them; one scalar fetch forces the
chain. Per-iteration time is device compute on device-resident data.
Correctness is checked in the same run: sampled members of one batch are
gzip-decoded against the input (any mismatch fails the run), and the
compressed size is compared with CPython zlib at the same level.

Corpus: the reference benches on ~550 MB of shakespeare (reference
benches/bench.rs:120-150, file stripped from the mirror); an
equivalent-entropy English-text corpus is synthesized deterministically.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def make_corpus(nbytes: int, seed: int = 1234) -> bytes:
    """Deterministic shakespeare-like English text."""
    rng = np.random.default_rng(seed)
    vocab = (
        "the quick brown fox jumps over lazy dog and all that glitters is not gold "
        "to be or not to be that is the question whether tis nobler in the mind to "
        "suffer the slings and arrows of outrageous fortune or to take arms against "
        "a sea of troubles and by opposing end them to die to sleep no more and by a "
        "sleep to say we end the heartache and the thousand natural shocks that flesh "
        "is heir to tis a consummation devoutly to be wished to die to sleep"
    ).split()
    words = [w.encode() for w in vocab]
    picks = rng.integers(0, len(words), size=nbytes // 3)
    parts = []
    total = 0
    line = 0
    for p in picks:
        w = words[p]
        parts.append(w)
        total += len(w) + 1
        line += len(w) + 1
        if line > 70:
            parts.append(b"\n")
            line = 0
        else:
            parts.append(b" ")
        if total >= nbytes:
            break
    return b"".join(parts)[:nbytes]



def _validate_members(out, out_len, data, batch, label):
    """gzip-decode sampled members against their input blocks; any
    difference raises. Block 0 byte 0 carries the timing chain's
    perturbation and is skipped."""
    import gzip as _gzip

    for i in range(0, batch, max(batch // 8, 1)):
        plain = _gzip.decompress(out[i, : out_len[i]].tobytes())
        want = data[i].tobytes()
        if i == 0:
            plain, want = plain[1:], want[1:]
        if plain != want:
            raise AssertionError(f"{label}: content mismatch at block {i}")


def device_info() -> dict:
    """The device the numbers come from; raises unless it is a GPU."""
    import jax

    devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(f"bench needs a GPU; JAX found {d.platform!r}")
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(devices)}


def measure_mgzip(batch: int, block_size: int, reps: int, level: int) -> dict:
    """Compile + time + validate the Mgzip encoder on one [batch,
    block_size] batch. Returns the result dict."""
    import zlib as _zlib

    import jax
    import jax.numpy as jnp

    from gzp_tpu.ops.deflate_kernel import DeflateEncodeConfig, encode_deflate_blocks

    cfg = DeflateEncodeConfig.for_level(block_size, "mgzip", "none", level)
    batch_bytes = batch * block_size
    corpus = make_corpus(batch_bytes)
    data = np.frombuffer(corpus, np.uint8).reshape(batch, block_size)
    lengths = np.full((batch,), block_size, np.int32)
    finals = np.zeros((batch,), bool)

    dd = jax.device_put(data)
    dl = jax.device_put(lengths)
    df = jax.device_put(finals)
    jax.block_until_ready(dd)

    # the chain does not carry the framed output buffers through the
    # loop; a separate jit fetches outputs for validation
    @jax.jit
    def chain(d):
        def body(_, carry):
            salt, x = carry
            x = x.at[0, 0].set((x[0, 0].astype(jnp.uint32) ^ (salt & 1)).astype(jnp.uint8))
            res = encode_deflate_blocks(cfg, x, dl, df)
            tot = jnp.sum(res["out_len"]).astype(jnp.uint32)
            return tot ^ res["check"][0], x

        salt, _ = jax.lax.fori_loop(0, reps, body, (jnp.uint32(0), d))
        return salt

    t0 = time.perf_counter()
    int(chain(dd))
    compile_s = time.perf_counter() - t0

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        int(chain(dd))
        best = min(best, (time.perf_counter() - t0) / reps)
    gbps = batch_bytes / best / 1e9

    # correctness + size: one un-chained encode, gzip-decode members
    res = jax.jit(lambda d: encode_deflate_blocks(cfg, d, dl, df))(dd)
    out = np.asarray(res["out"])
    out_len = np.asarray(res["out_len"])
    total_out = int(out_len.sum())
    _validate_members(out, out_len, data, batch, f"{batch}x{block_size}")

    zlib_size = sum(
        len(_zlib.compress(data[i].tobytes(), level)) for i in range(batch)
    )
    return {
        "metric": "mgzip_encode_device_throughput",
        "value": round(gbps, 4),
        "unit": "GB/s",
        "device": device_info(),
        "extra": {
            "batch_blocks": batch,
            "block_size": block_size,
            "level": level,
            "per_batch_ms": round(best * 1e3, 2),
            "compile_s": round(compile_s, 1),
            "compression_ratio": round(batch_bytes / total_out, 3),
            f"size_vs_zlib{level}": round(total_out / zlib_size, 3),
            "timing": "chained fori_loop, scalar-fetch forced; device compute only",
        },
    }


def measure_snappy(batch: int = 64, block: int = 65536, reps: int = 8) -> dict:
    """Snappy-frame encode throughput on device (the reference benches
    gzip AND snappy, benches/bench.rs:120-150).
    Same dispatch-proof chained-fori timing as the mgzip ladder; frames
    validated with the host frame-decoder oracle."""
    import jax
    import jax.numpy as jnp

    from gzp_tpu.ops.snappy_kernel import SnappyEncodeConfig, encode_snappy_blocks
    from gzp_tpu.utils.snappy_ref import decode_frames

    cfg = SnappyEncodeConfig(block)
    total = batch * block
    data = np.frombuffer(make_corpus(total), np.uint8).reshape(batch, block)
    lengths = jnp.asarray(np.full((batch,), block, np.int32))
    finals = jnp.asarray(np.zeros((batch,), bool))
    dd = jax.device_put(data)
    jax.block_until_ready(dd)

    @jax.jit
    def chain(d):
        def body(_, carry):
            salt, x = carry
            x = x.at[0, 0].set((x[0, 0].astype(jnp.uint32) ^ (salt & 1)).astype(jnp.uint8))
            res = encode_snappy_blocks(cfg, x, lengths, finals)
            tot = jnp.sum(res["out_len"]).astype(jnp.uint32)
            return tot ^ res["check"][0], x

        salt, _ = jax.lax.fori_loop(0, reps, body, (jnp.uint32(0), d))
        return salt

    t0 = time.perf_counter()
    int(chain(dd))
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        int(chain(dd))
        best = min(best, (time.perf_counter() - t0) / reps)
    gbps = total / best / 1e9

    # validation: one un-chained encode
    res = jax.jit(lambda d: encode_snappy_blocks(cfg, d, lengths, finals))(dd)
    out = np.asarray(res["out"])
    out_len = np.asarray(res["out_len"])
    bad = 0
    for i in range(0, batch, max(batch // 8, 1)):
        frame = out[i, : out_len[i]].tobytes()
        bad += decode_frames(frame) != data[i].tobytes()
    if bad:
        raise AssertionError(f"snappy validation: {bad} bad frames")
    return {
        "gbps": round(gbps, 4),
        "batch": batch,
        "block": block,
        "ratio": round(total / int(out_len.sum()), 3),
        "compile_s": round(compile_s, 1),
    }


def measure_decode() -> dict:
    """Native parallel-decode throughput: ParDecompress over the C++
    inflate pool — the documented decode path (ARCHITECTURE.md §3; the
    reference's analog is libdeflate on N threads,
    src/par/decompress.rs:161-187). Members are built host-side with
    zlib so no device compile is involved."""
    import io
    import struct
    import zlib as _zlib

    from gzp_tpu import Mgzip, ParDecompress

    block = 131072
    total = 64 * block
    corpus = make_corpus(total)
    members = []
    for off in range(0, total, block):
        chunk = corpus[off : off + block]
        co = _zlib.compressobj(3, wbits=-15)
        payload = co.compress(chunk) + co.flush()
        hdr = bytes(
            [31, 139, 8, 4, 0, 0, 0, 0, 0, 255, 8, 0, ord("I"), ord("G"), 4, 0]
        ) + struct.pack("<I", len(payload) + 28)
        foot = struct.pack("<II", _zlib.crc32(chunk), len(chunk))
        members.append(hdr + payload + foot)
    blob = b"".join(members)
    nt = os.cpu_count() or 2
    best = float("inf")
    for _ in range(3):
        r = ParDecompress(Mgzip, io.BytesIO(blob), num_threads=nt)
        t0 = time.perf_counter()
        out = r.read()
        dt = time.perf_counter() - t0
        r.close()
        if out != corpus:
            raise AssertionError("decode bench: output differs from the input")
        best = min(best, dt)
    return {
        "gbps_uncompressed": round(total / best / 1e9, 4),
        "threads": nt,
        "input_mb": round(len(blob) / 1e6, 1),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # the flagship: 128 KiB blocks at level 3 (reference benches/bench.rs:120-150),
    # 64 blocks per device batch (num_threads(64))
    ap.add_argument("--level", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--block", type=int, default=131072)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)

    from gzp_tpu.utils.testing import enable_compilation_cache

    dev = device_info()  # fails the run before any measurement without a GPU
    enable_compilation_cache()
    print(json.dumps({"decode_info": {**measure_decode(), "device": dev}}), flush=True)
    print(json.dumps({"snappy_info": {**measure_snappy(), "device": dev}}), flush=True)
    print(json.dumps(measure_mgzip(args.batch, args.block, args.reps, args.level)), flush=True)


if __name__ == "__main__":
    main()
