#!/usr/bin/env python
"""Criterion-style benchmark sweep (reference benches/bench.rs:120-150):
gzip + snappy encode across parallelism degrees on the synthesized
corpus, plus block-format decode. Prints one JSON line per config.

Run on the default device:   python benches/sweep.py --size-mb 64
Run on virtual CPU devices:  python benches/sweep.py --cpu
"""

import argparse
import io
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


class NullWriter:
    def __init__(self):
        self.count = 0

    def write(self, b):
        self.count += len(b)
        return len(b)

    def flush(self):
        pass


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size-mb", type=int, default=32)
    ap.add_argument("--threads", type=int, nargs="*", default=[1, 4, 16, 64])
    ap.add_argument("--formats", nargs="*", default=["gzip", "snappy", "mgzip", "bgzf"])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--device-decode", action="store_true",
                    help="also sweep the device batch-inflate decode backend")
    ap.add_argument("--decode-only", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        from gzp_tpu.utils.testing import force_cpu_backend

        force_cpu_backend()
    from gzp_tpu.utils.testing import enable_compilation_cache

    enable_compilation_cache()

    from bench import make_corpus
    from gzp_tpu import ALL_FORMATS, ParDecompress, ZBuilder

    corpus = make_corpus(args.size_mb * 1024 * 1024)
    for fmt_name in args.formats if not args.decode_only else []:
        fmt = ALL_FORMATS[fmt_name]
        for nt in args.threads:
            # warmup (compilation)
            w = ZBuilder(fmt).num_threads(nt).from_writer(NullWriter())
            w.write(corpus[: w.block_size * max(nt, 1)])
            w.finish()
            sink = NullWriter()
            w = ZBuilder(fmt).num_threads(nt).from_writer(sink)
            t0 = time.perf_counter()
            w.write(corpus)
            w.finish()
            dt = time.perf_counter() - t0
            print(
                json.dumps(
                    {
                        "bench": f"{fmt_name}_encode",
                        "threads": nt,
                        "gbps": round(len(corpus) / dt / 1e9, 4),
                        "ratio": round(len(corpus) / sink.count, 3),
                    }
                ),
                flush=True,
            )

    # block-format decode sweep; the blob is built with host zlib so the
    # decode numbers are independent of our encoder's ratio
    import struct
    import zlib

    def mgzip_blob(data: bytes, block: int = 131072) -> bytes:
        parts = []
        for off in range(0, len(data), block):
            chunk = data[off : off + block]
            payload = zlib.compress(chunk, 6)[2:-4]
            blen = len(payload) + 28
            hdr = (
                bytes([31, 139, 8, 4, 0, 0, 0, 0, 0, 255, 8, 0])
                + b"IG" + struct.pack("<H", 4) + struct.pack("<I", blen)
            )
            foot = struct.pack("<II", zlib.crc32(chunk), len(chunk))
            parts.append(hdr + payload + foot)
        return b"".join(parts)

    for fmt_name in ("bgzf", "mgzip"):
        if fmt_name not in args.formats:
            continue
        fmt = ALL_FORMATS[fmt_name]
        if fmt_name == "mgzip":
            blob = mgzip_blob(corpus)
        else:
            from gzp_tpu.constants import BGZF_EOF

            parts = []
            for off in range(0, len(corpus), 65280):
                chunk = corpus[off : off + 65280]
                payload = zlib.compress(chunk, 6)[2:-4]
                bsize = len(payload) + 18 + 8 - 1
                hdr = (
                    bytes([31, 139, 8, 4, 0, 0, 0, 0, 0, 255, 6, 0])
                    + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize)
                )
                foot = struct.pack("<II", zlib.crc32(chunk), len(chunk))
                parts.append(hdr + payload + foot)
            parts.append(BGZF_EOF)
            blob = b"".join(parts)
        backends = ["native"] + (["device"] if args.device_decode else [])
        for backend in backends:
            for nt in args.threads:
                r = ParDecompress(
                    fmt, io.BytesIO(blob), num_threads=nt, backend=backend
                )
                t0 = time.perf_counter()
                total = len(r.read())
                dt = time.perf_counter() - t0
                assert total == len(corpus)
                print(
                    json.dumps(
                        {
                            "bench": f"{fmt_name}_decode_{backend}",
                            "threads": nt,
                            "gbps": round(total / dt / 1e9, 4),
                        }
                    ),
                    flush=True,
                )


if __name__ == "__main__":
    main()
