#!/usr/bin/env python3
"""Smoke check of gzp_tpu's main path on NVIDIA GPUs.

Compresses seeded text through the public writer (``ZBuilder``) at the
reference's widths: 64 blocks per device batch, 128 KiB blocks (65280 for
BGZF, 64 KiB for snappy frames). Every stream is decoded by an
independent oracle (stdlib ``gzip``/``zlib``, ``gzp_tpu.utils.snappy_ref``)
and the block formats also by ``ParDecompress``. Further phases check
that the GPU encoder emits the same bytes as the CPU backend, report the
compiled memory of two encoder steps, and run the device inflate path.

    python chip_smoke.py           # one GPU, every phase
    python chip_smoke.py --four    # four GPUs: a mesh-sharded writer vs one card

Each phase prints one line. The last line is one JSON object,
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero; with no GPU it exits non-zero before the first phase.
Timings are smoke timings (one run, compile included where stated), not
benchmark results.
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

KIB, MIB = 1 << 10, 1 << 20
BATCH = 64  # blocks per device batch, the flagship num_threads(64)
WRITE_CHUNK = MIB  # callers stream into the writer in 1 MiB writes


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return " | ".join(line.strip() for line in out.splitlines() if line.strip())


def require_gpus(count: int):
    """The JAX devices, or exit non-zero unless ``count`` GPUs are there."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform {devices[0].platform!r})")
    if len(devices) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX found {len(devices)}")
    return devices


def corpus(nbytes: int, seed: int) -> bytes:
    from bench import make_corpus

    return make_corpus(nbytes, seed=seed)


def with_random(text: bytes, nrandom: int, seed: int) -> bytes:
    """``text`` with ``nrandom`` seeded random bytes spliced into its
    middle (same total length): those blocks only compress by falling
    back to stored encodings."""
    rnd = np.random.default_rng(seed).integers(0, 256, nrandom, np.uint8).tobytes()
    mid = (len(text) - nrandom) // 2
    return text[:mid] + rnd + text[mid + nrandom :]


def compress(fmt, level: int, block: int, data: bytes, *, threads: int = BATCH,
             mesh=None, on_first=None):
    """Compress ``data`` through ``ZBuilder``; returns (stream, first_s, rest_s).

    ``first_s`` covers the first batch (its compile included) up to its
    bytes reaching the sink; ``rest_s`` the remaining batches through
    ``finish()``. ``on_first(writer)`` runs after the first batch is
    dispatched and before it is drained."""
    from gzp_tpu import ZBuilder

    sink = io.BytesIO()
    w = (
        ZBuilder(fmt).num_threads(threads).compression_level(level)
        .buffer_size(block).mesh(mesh).from_writer(sink)
    )
    view = memoryview(data)
    first = min(len(data), block * w.batch)
    t0 = time.perf_counter()
    w.write(view[:first])
    if on_first is not None:
        on_first(w)
    w.flush()
    t1 = time.perf_counter()
    for off in range(first, len(data), WRITE_CHUNK):
        w.write(view[off : off + WRITE_CHUNK])
    w.finish()
    t2 = time.perf_counter()
    return sink.getvalue(), t1 - t0, t2 - t1


def oracle_decode(name: str, out: bytes) -> bytes:
    """Decode with an implementation independent of gzp_tpu's decoders."""
    if name in ("mgzip", "gzip", "bgzf"):
        return gzip.decompress(out)
    if name == "zlib":
        return zlib.decompress(out)
    if name == "raw_deflate":
        return zlib.decompress(out, wbits=-15)
    if name == "snappy":
        from gzp_tpu.utils.snappy_ref import decode_frames

        return decode_frames(out)
    raise ValueError(name)


def encode_phase(label: str, fmt, level: int, block: int, data: bytes, card: str,
                 threads: int = BATCH) -> bytes:
    out, first_s, rest_s = compress(fmt, level, block, data, threads=threads)
    if oracle_decode(fmt.name, out) != data:
        raise AssertionError(f"{label}: oracle decode differs from the input")
    checked = "oracle"
    if fmt.name in ("mgzip", "bgzf"):
        from gzp_tpu import ParDecompress

        r = ParDecompress(fmt, io.BytesIO(out), num_threads=os.cpu_count() or 1)
        back = r.read()
        r.close()
        if back != data:
            raise AssertionError(f"{label}: ParDecompress output differs from the input")
        checked += "+ParDecompress"
    rest = len(data) - min(len(data), block * threads)
    log(
        f"phase {label}: in={len(data)} B out={len(out)} B "
        f"ratio={len(data) / len(out):.4f} first_batch_s={first_s:.2f} "
        f"steady_s={rest_s:.2f} steady_GBps={rest / rest_s / 1e9 if rest else 0:.4f} "
        f"decoded={checked} card=[{card}] (smoke timing)"
    )
    return out


def identity_phase(label: str, fmt, level: int, block: int, data: bytes,
                   threads: int = BATCH) -> None:
    """The same 4 blocks through the default-device writer (one batch
    of ``threads`` blocks, the program of the encode phases) and through
    a writer pinned to the CPU backend (a one-device CPU mesh, 4 blocks
    per batch): identical bytes. The CPU programs bypass the persistent
    compile cache, which other host types may share."""
    import jax

    from gzp_tpu.utils.testing import persistent_cache_off

    cpu_mesh = jax.sharding.Mesh(np.array(jax.devices("cpu")[:1]), ("blocks",))
    gpu_out, _, _ = compress(fmt, level, block, data, threads=threads)
    with persistent_cache_off():
        cpu_out, _, _ = compress(fmt, level, block, data, threads=4, mesh=cpu_mesh)
    if gpu_out != cpu_out:
        diff = next(
            (i for i, (a, b) in enumerate(zip(gpu_out, cpu_out)) if a != b),
            min(len(gpu_out), len(cpu_out)),
        )
        raise AssertionError(
            f"identity {label}: GPU and CPU streams differ "
            f"(lengths {len(gpu_out)}/{len(cpu_out)}, first difference at byte {diff})"
        )
    if oracle_decode(fmt.name, gpu_out) != data:
        raise AssertionError(f"identity {label}: oracle decode differs from the input")
    log(f"identity {label}: 4 blocks, GPU == CPU, {len(gpu_out)} B identical")


def memory_phase(label: str, fmt, level: int, block: int, threads: int = BATCH) -> None:
    """``memory_analysis()`` of the compiled [threads, block] encoder step."""
    import jax

    from gzp_tpu import ParCompress

    w = ParCompress(fmt, io.BytesIO(), num_threads=threads, compression_level=level,
                    buffer_size=block)
    b, n = w.batch, w.block_size
    args = [
        jax.ShapeDtypeStruct((b, n), np.uint8),
        jax.ShapeDtypeStruct((b,), np.int32),
        jax.ShapeDtypeStruct((b,), np.bool_),
    ]
    d = getattr(w._cfg, "dict_size", 0)
    if d:
        args += [jax.ShapeDtypeStruct((b, d), np.uint8), jax.ShapeDtypeStruct((b,), np.int32)]
    ma = w._encoder.lower(*args).compile().memory_analysis()
    w.finish()
    log(
        f"memory {label}: argument={ma.argument_size_in_bytes} B "
        f"output={ma.output_size_in_bytes} B temp={ma.temp_size_in_bytes} B "
        f"generated_code={ma.generated_code_size_in_bytes} B"
    )


def device_inflate_phase(text: bytes, threads: int = BATCH) -> None:
    """``ParDecompress(Bgzf, backend="device")`` on an 8-block BGZF file:
    every block must be inflated on the device, none by the host pool."""
    from gzp_tpu import Bgzf, ParDecompress
    from gzp_tpu.constants import BGZF_BLOCK_SIZE

    data = text[: 8 * BGZF_BLOCK_SIZE]
    out, _, _ = compress(Bgzf, 6, BGZF_BLOCK_SIZE, data, threads=threads)
    t0 = time.perf_counter()
    r = ParDecompress(Bgzf, io.BytesIO(out), num_threads=8, backend="device")
    back = r.read()
    r.close()
    dt = time.perf_counter() - t0
    if back != data:
        raise AssertionError("device inflate: output differs from the input")
    if r.fallback_stats["native"] != 0:
        raise AssertionError(f"device inflate: host fallbacks {r.fallback_stats}")
    log(
        f"device-inflate bgzf: 8 blocks, {len(data)} B, stats={r.fallback_stats}, "
        f"{dt:.2f} s with compile (smoke timing)"
    )


def single_card(args, devices, card: str) -> None:
    from gzp_tpu import Bgzf, Gzip, Mgzip, RawDeflate, Snap, Zlib

    flag, other = args.mib * MIB, args.other_mib * MIB
    t0 = time.perf_counter()
    text = corpus(max(flag, 5 * other), seed=args.seed)
    log(f"corpus: {len(text)} B of seeded text in {time.perf_counter() - t0:.1f} s")

    # (label, format, level, block, input) for every format of the main path
    phases = [
        ("mgzip-l3", Mgzip, 3, 128 * KIB, text[:flag]),
        ("gzip-l6", Gzip, 6, 128 * KIB, text[other : 2 * other]),
        ("bgzf-l6", Bgzf, 6, 65280, with_random(text[: other], MIB, args.seed)),
        ("zlib-l9", Zlib, 9, 128 * KIB, text[2 * other : 3 * other]),
        ("deflate-l1", RawDeflate, 1, 128 * KIB, text[3 * other : 4 * other]),
        ("snappy", Snap, 3, 64 * KIB, text[4 * other : 5 * other]),
    ]
    for label, fmt, level, block, data in phases:
        encode_phase(label, fmt, level, block, data, card)
        if label == "mgzip-l3":
            peak = devices[0].memory_stats()["peak_bytes_in_use"]
            log(f"memory mgzip-l3: peak_bytes_in_use={peak} B after {len(data)} B")

    for label, fmt, level, block, data in phases:
        if label == "bgzf-l6":  # two text blocks, then two random ones
            mid = (len(data) - MIB) // 2
            four = data[mid - 2 * block : mid + 2 * block]
        else:
            four = data[: 4 * block]
        identity_phase(label, fmt, level, block, four)

    memory_phase("mgzip-l3", Mgzip, 3, 128 * KIB)
    memory_phase("gzip-l6", Gzip, 6, 128 * KIB)
    device_inflate_phase(text)


def four_cards(args, devices, card: str, threads: int = BATCH) -> None:
    """One writer sharded over four cards vs the same writer on one card."""
    import jax

    from gzp_tpu import Bgzf, Gzip

    mesh = jax.sharding.Mesh(np.array(devices[:4]), ("blocks",))
    nbytes = args.four_mib * MIB
    text = corpus(nbytes, seed=args.seed)
    cases = [
        ("gzip-l6", Gzip, 6, 128 * KIB, text),
        ("bgzf-l6", Bgzf, 6, 65280, with_random(text, MIB, args.seed)),
    ]
    for label, fmt, level, block, data in cases:
        def show_sharding(w):
            res = w._inflight[0][0]
            log(f"four {label}: flat output sharding {res['flat'].sharding}")

        out4, f4, r4 = compress(fmt, level, block, data, threads=threads, mesh=mesh,
                                on_first=show_sharding)
        out1, f1, r1 = compress(fmt, level, block, data, threads=threads)
        if out4 != out1:
            raise AssertionError(f"four {label}: 4-card stream differs from 1-card stream")
        if gzip.decompress(out4) != data:
            raise AssertionError(f"four {label}: stdlib decode differs from the input")
        log(
            f"four {label}: in={len(data)} B out={len(out4)} B identical to one card; "
            f"4 cards first_batch_s={f4:.2f} rest_s={r4:.2f} | "
            f"1 card first_batch_s={f1:.2f} rest_s={r1:.2f} card=[{card}] (smoke timing)"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase and its one-card comparison")
    ap.add_argument("--mib", type=int, default=512, help="flagship input size (MiB)")
    ap.add_argument("--other-mib", type=int, default=64,
                    help="input size of each other format (MiB)")
    ap.add_argument("--four-mib", type=int, default=256, help="--four input size (MiB)")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)

    count = 4 if args.four else 1
    devices = require_gpus(count)
    import jax

    from gzp_tpu.utils.testing import enable_compilation_cache

    card = card_label()
    d0 = devices[0]
    log(f"device: {d0.device_kind} x{len(devices)} jax {jax.__version__}")
    log(f"nvidia-smi: {card}")
    cache = enable_compilation_cache()
    log(f"compile cache: {cache}")

    if args.four:
        four_cards(args, devices, card)
    else:
        single_card(args, devices, card)
    result = {"ok": True, "device": {"platform": d0.platform, "kind": d0.device_kind,
                                     "count": len(devices)}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
