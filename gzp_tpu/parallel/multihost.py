"""Multi-host (multi-process) parallel compression.

The reference is a single-process library whose scaling axis is worker
threads (reference src/par/compress.rs:248-323). Here the scaling
axis above one host is processes: each host compresses a *contiguous
range of blocks* on its local devices and the partial streams are
stitched in host-rank order — exactly the reference's ordered-writer
contract lifted one level up (SURVEY.md §5 distributed-backend mapping).

Design:

* ``shard_ranges(total_len, block_size, num_shards)`` — contiguous
  block-aligned byte ranges, one per host rank.
* ``compress_shard(...)`` — run the normal single-host ``ParCompress``
  pipeline over one range, suppressing the stream header (rank > 0) and
  the stream footer (every rank): for the zlib family the shard ends in
  a Z_SYNC_FLUSH block join (non-final blocks already do), the dict
  carry is preset from the previous shard's trailing ``DICT_SIZE``
  input bytes, and the per-shard running checksum is returned.
* ``stitch_shards(...)`` — concatenate partial payloads in rank order,
  fold the per-shard checksums with the O(1) combine (pigz COMB across
  hosts), and emit header/footer/trailer once.

``init_distributed()`` wires this to ``jax.distributed`` so N real
processes (one per host) can run ``compress_shard`` concurrently; the
rank-0 process stitches. ``tests/test_multihost.py`` exercises the full
2-process path on the CPU backend (its children set ``JAX_PLATFORMS``).
The worker entry runs on whatever backend JAX finds.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import BinaryIO

from gzp_tpu.constants import DICT_SIZE
from gzp_tpu.formats.base import FormatSpec
from gzp_tpu.parallel.compress import ParCompress


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: list[int] | None = None,
):
    """Initialize jax.distributed for a multi-process run (idempotent).

    Meant for one process per host, each driving its host's devices.
    When several processes share one machine, give each its own cards
    with ``local_device_ids``: otherwise every process opens, and
    reserves memory on, every card.
    """
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
    return jax.process_index(), jax.process_count()


def shard_ranges(
    total_len: int, block_size: int, num_shards: int
) -> list[tuple[int, int]]:
    """Contiguous block-aligned [start, end) byte ranges per host rank.

    Every shard gets a whole number of blocks; the final shard takes the
    ragged tail. Block-alignment keeps the emitted stream identical to
    the single-host stream (same block boundaries, same dict carry).
    """
    nblocks = max(-(-total_len // block_size), 1)
    per = -(-nblocks // num_shards)
    out = []
    for r in range(num_shards):
        s = min(r * per * block_size, total_len)
        e = min((r + 1) * per * block_size, total_len)
        out.append((s, e))
    return out


@dataclass
class ShardResult:
    """One host's partial stream + checksum state for rank-order stitch."""

    rank: int
    payload: bytes
    check_sum: int
    check_amount: int

    def to_bytes(self) -> bytes:
        """Serialize for cross-process transport (files/sockets)."""
        import struct

        head = struct.pack("<IIQ", self.rank, self.check_sum, self.check_amount)
        return head + self.payload

    @classmethod
    def from_bytes(cls, blob: bytes) -> "ShardResult":
        import struct

        rank, csum, amount = struct.unpack_from("<IIQ", blob, 0)
        return cls(rank, blob[16:], csum, amount)


def compress_shard(
    format_spec: FormatSpec,
    data: bytes,
    rank: int,
    num_shards: int,
    *,
    compression_level: int = 3,
    buffer_size: int | None = None,
    num_threads: int = 16,
    mesh=None,
) -> ShardResult:
    """Compress this rank's contiguous block range of ``data``.

    ``data`` is the whole input (each host reads its slice plus the
    32 KiB dict halo from the previous shard — contiguous ranges make
    that a local slice, the halo-exchange analog of
    reference src/par/compress.rs:417-423).
    """
    buffer_size = buffer_size or format_spec.default_bufsize
    if format_spec.max_input_block is not None:
        buffer_size = min(buffer_size, format_spec.max_input_block)
    ranges = shard_ranges(len(data), buffer_size, num_shards)
    start, end = ranges[rank]
    last = rank == num_shards - 1
    sink = io.BytesIO()
    # header/footer/trailer are the stitcher's job; non-last shards end
    # mid-stream (Z_SYNC_FLUSH block join), the last closes the stream
    pc = ParCompress(
        format_spec,
        sink,
        num_threads=num_threads,
        compression_level=compression_level,
        buffer_size=buffer_size,
        mesh=mesh,
        emit_header=False,
        emit_footer=False,
        final_on_finish=last,
        preset_carry=data[max(0, start - DICT_SIZE) : start] if rank > 0 else b"",
    )
    pc.write(data[start:end])
    pc.finish()
    check = pc.check
    return ShardResult(rank, sink.getvalue(), check.sum(), check.amount())


def stitch_shards(
    format_spec: FormatSpec,
    shards: list[ShardResult],
    writer: BinaryIO,
    *,
    compression_level: int = 3,
) -> None:
    """Rank-ordered stitch: header, payloads, combined check footer,
    format trailer (e.g. the BGZF EOF marker)."""
    shards = sorted(shards, key=lambda s: s.rank)
    for i, s in enumerate(shards):
        if s.rank != i:
            raise ValueError(f"missing shard rank {i}")
    hdr = format_spec.header(compression_level)
    if hdr:
        writer.write(hdr)
    running = format_spec.create_check()
    for s in shards:
        writer.write(s.payload)
        running.combine(format_spec.check_cls.from_sum(s.check_sum, s.check_amount))
    trailer = format_spec.trailer_bytes()
    if trailer:
        writer.write(trailer)
    footer = format_spec.footer(running)
    if footer:
        writer.write(footer)


def _worker_args(argv=None):
    """Command line of :func:`_worker_main`."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--format", default="mgzip")
    p.add_argument("--level", type=int, default=3)
    p.add_argument("--buffer-size", type=int, default=None)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument(
        "--local-device-ids",
        type=lambda v: [int(i) for i in v.split(",")],
        default=None,
        help="comma-separated local devices of this process (e.g. 0 or 2,3) "
        "when several processes share one machine",
    )
    return p.parse_args(argv)


def _worker_main() -> None:
    """Entry for one process of an N-process run (used by the multi-host
    test): compress one shard and write the serialized ShardResult."""
    import sys

    args = _worker_args()
    rank, nproc = init_distributed(
        args.coordinator, args.num_processes, args.rank, args.local_device_ids
    )
    assert rank == args.rank and nproc == args.num_processes

    from gzp_tpu import ALL_FORMATS

    fmt = ALL_FORMATS[args.format]
    data = open(args.input, "rb").read()
    res = compress_shard(
        fmt,
        data,
        args.rank,
        args.num_processes,
        compression_level=args.level,
        buffer_size=args.buffer_size,
        num_threads=4,
    )
    with open(args.output, "wb") as f:
        f.write(res.to_bytes())
    sys.exit(0)


if __name__ == "__main__":
    _worker_main()
