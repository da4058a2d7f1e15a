"""Parallel block decompression — the ``ParDecompress`` equivalent.

Reference architecture (src/par/decompress.rs): a reader thread parses
block headers (magic + SID + BSIZE), fans complete compressed blocks out
to decode workers, and the caller's ``read()`` drains per-block results
in stream order with every block's CRC verified.

Host-native shape of the same design: the header scan is a cheap serial
loop (exactly the reference's reader thread); blocks are decoded by the
self-written native inflate (``gzp_tpu/runtime``) on a thread pool —
ctypes releases the GIL, so ``num_threads`` scales like the reference's
worker pool. Ordering comes from submission-order futures. A batched
device inflate (data-parallel Huffman decode over independent blocks)
sits behind the same interface as ``backend='device'``.
"""

from __future__ import annotations

import io
import struct
from concurrent.futures import Future, ThreadPoolExecutor
from typing import BinaryIO

from gzp_tpu.errors import (
    DecompressError,
    InvalidBlockSizeError,
    InvalidCheckError,
    InvalidHeaderError,
    NumThreadsError,
)
from gzp_tpu.formats.base import BlockFormatSpec
from gzp_tpu.runtime import get_native
from gzp_tpu.utils.io import read_exact

DEFAULT_DECOMPRESS_THREADS = 8


def _decode_block(fmt: BlockFormatSpec, block: bytes) -> bytes:
    """Worker: inflate one framed block and verify its CRC
    (reference src/par/decompress.rs:161-187)."""
    native = get_native()
    fv = fmt.get_footer_values(block)
    payload = block[fmt.header_size : len(block) - 8]
    if fv.amount == 0:
        plain = b""
    else:
        plain = native.inflate(payload, fv.amount)
    crc = native.crc32(plain, 0)
    if crc != fv.sum:
        raise InvalidCheckError(found=crc, expected=fv.sum)
    return plain


class ParDecompress(io.RawIOBase):
    """Streaming reader decompressing a block format in parallel.

    Only block formats (Mgzip, BGZF) support this — plain gzip can't be
    split without decoding (reference: ParDecompress is bound by
    ``BlockFormatSpec``).

    ``backend='native'`` (default) fans blocks over the C++ inflate
    thread pool; ``backend='device'`` is **experimental**: it batches
    blocks through the device inflate kernel
    (``gzp_tpu.ops.inflate_kernel``) with per-block CRC verification on
    device. Its lockstep symbol-serial decode is not expected to beat
    the native pool (ARCHITECTURE.md §3). Blocks exceeding the device caps
    or failing on device fall back to the native path (which also
    produces precise error types); every fallback is counted in
    :attr:`fallback_stats` and the first one logs a warning.
    """

    def __init__(
        self,
        format_spec: BlockFormatSpec,
        reader: BinaryIO,
        *,
        num_threads: int = DEFAULT_DECOMPRESS_THREADS,
        queue_depth: int | None = None,
        backend: str = "native",
    ) -> None:
        if num_threads < 1:
            raise NumThreadsError(num_threads)
        if not isinstance(format_spec, BlockFormatSpec):
            raise TypeError(
                f"{format_spec.name} is not a block format; parallel "
                "decompression needs self-framed blocks (mgzip/bgzf)"
            )
        self.format = format_spec
        self.reader = reader
        self.backend = backend
        self.pool = ThreadPoolExecutor(max_workers=num_threads)
        # bounded lookahead = backpressure (reference bounds its channels
        # at 2x num_threads, src/par/decompress.rs:70,142)
        self.queue_depth = queue_depth or num_threads * 2
        self._pending: list = []
        self._buffer = bytearray()
        self._eof = False
        self._closed = False
        # public telemetry (documented): device-vs-native routing counts
        # for backend='device'; stays all-zero under backend='native'
        self.fallback_stats = {"device": 0, "native": 0}
        self._warned_fallback = False
        if backend == "device":
            self._device_batch = max(num_threads, 8)
            self.queue_depth = queue_depth or 2

    # -- block scanning (the reference's reader thread, :194-210) --

    def _scan_one(self) -> bytes | None:
        # read-exact loops: pipes/sockets/raw files legally return short
        # (reference uses read_exact, src/par/decompress.rs:197-202)
        hdr = read_exact(self.reader, self.format.header_size)
        if not hdr:
            return None
        if len(hdr) < self.format.header_size:
            raise InvalidHeaderError("truncated block header")
        self.format.check_header(hdr)
        size = self.format.get_block_size(hdr)
        if size < self.format.header_size + 8:
            raise InvalidBlockSizeError(
                f"invalid block size {size} (< header + footer)"
            )
        rest = read_exact(self.reader, size - self.format.header_size)
        if len(rest) != size - self.format.header_size:
            raise DecompressError("truncated block body")
        return hdr + rest

    def _fill_pipeline(self) -> None:
        while not self._eof and len(self._pending) < self.queue_depth:
            if self.backend == "device":
                batch = []
                while len(batch) < self._device_batch:
                    block = self._scan_one()
                    if block is None:
                        self._eof = True
                        break
                    batch.append(block)
                if batch:
                    # construct + dispatch + gather on a pool thread, so
                    # the [B, 64 KiB] staging and device dispatch overlap
                    # the caller's read()
                    self._pending.append(
                        self.pool.submit(
                            lambda blocks=batch: _DeviceBatch(
                                self.format, blocks, self
                            ).result()
                        )
                    )
            else:
                block = self._scan_one()
                if block is None:
                    self._eof = True
                    break
                self._pending.append(
                    self.pool.submit(_decode_block, self.format, block)
                )

    def _next_chunk(self) -> bytes | None:
        self._fill_pipeline()
        if not self._pending:
            return None
        fut = self._pending.pop(0)
        self._fill_pipeline()
        return fut.result()

    # -- read API --

    def read(self, size: int = -1) -> bytes:
        if self._closed:
            raise ValueError("reader closed")
        if size is None or size < 0:
            if self.backend == "native":
                return self._read_all_native()
            chunks = [bytes(self._buffer)]
            self._buffer.clear()
            while True:
                c = self._next_chunk()
                if c is None:
                    break
                chunks.append(c)
            return b"".join(chunks)
        while len(self._buffer) < size:
            c = self._next_chunk()
            if c is None:
                break
            self._buffer += c
        out = bytes(self._buffer[:size])
        del self._buffer[:size]
        return out

    def _read_all_native(self) -> bytes:
        """read(-1) fast path: scan every remaining member up front,
        inflate each directly into its slice of ONE preallocated output
        buffer (`inflate_into`), and checksum the slices in place. The
        chunk-at-a-time path pays ~3 GIL-held copies per member
        (payload slice, bytes return, buffer append, final join) which
        capped the 2-thread pool at ~0.42 GB/s while the C++ inflate
        alone sustains 0.58 GB/s single-thread; here workers run
        GIL-free end to end and reassembly is free by construction.
        read(-1) materializes the whole stream either way, so the
        bounded-queue backpressure the streaming path provides is moot."""
        chunks = [bytes(self._buffer)]
        self._buffer.clear()
        pending, self._pending = self._pending, []
        chunks.extend(f.result() for f in pending)

        fmt = self.format
        blocks: list[bytes] = []
        offs = [0]
        while True:
            blk = self._scan_one()
            if blk is None:
                self._eof = True
                break
            blocks.append(blk)
            offs.append(offs[-1] + fmt.get_footer_values(blk).amount)
        out = bytearray(offs[-1])
        view = memoryview(out)
        native = get_native()

        def work(i: int) -> None:
            blk = blocks[i]
            fv = fmt.get_footer_values(blk)
            seg = view[offs[i] : offs[i + 1]]
            if fv.amount:
                written, _ = native.inflate_into(
                    blk[fmt.header_size : len(blk) - 8], seg
                )
                if written != fv.amount:
                    raise DecompressError(
                        f"inflate produced {written} bytes, expected {fv.amount}"
                    )
            crc = native.crc32_view(seg)
            if crc != fv.sum:
                raise InvalidCheckError(found=crc, expected=fv.sum)

        futs = [self.pool.submit(work, i) for i in range(len(blocks))]
        for f in futs:
            f.result()
        if len(chunks) == 1 and not chunks[0]:
            return bytes(out)
        chunks.append(bytes(out))
        return b"".join(chunks)

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def finish(self) -> None:
        self.close()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.pool.shutdown(wait=False, cancel_futures=True)
        super().close()


class _DeviceBatch:
    """A dispatched device-inflate batch; ``result()`` gathers outputs,
    verifies CRCs, and falls back to the native path per failing block."""

    # caps sized for BGZF/Mgzip members (compressed member < 64 KiB for
    # BGZF; larger foreign mgzip blocks fall back to native)
    IN_CAP = 65536
    OUT_CAP = 65536

    def __init__(self, fmt: BlockFormatSpec, blocks: list[bytes], owner: "ParDecompress"):
        import jax.numpy as jnp
        import numpy as np

        from gzp_tpu.ops.inflate_kernel import InflateConfig, get_inflater

        self.fmt = fmt
        self.blocks = blocks
        self.owner = owner
        b = len(blocks)
        self.footers = [fmt.get_footer_values(blk) for blk in blocks]
        payloads = [blk[fmt.header_size : len(blk) - 8] for blk in blocks]
        self.native_idx = [
            i
            for i, (p, fv) in enumerate(zip(payloads, self.footers))
            if len(p) > self.IN_CAP or fv.amount > self.OUT_CAP
        ]
        streams = np.zeros((b, self.IN_CAP), np.uint8)
        in_lens = np.zeros(b, np.int32)
        out_lens = np.zeros(b, np.int32)
        for i, (p, fv) in enumerate(zip(payloads, self.footers)):
            if i in self.native_idx:
                continue
            streams[i, : len(p)] = np.frombuffer(p, np.uint8)
            in_lens[i] = len(p)
            out_lens[i] = fv.amount
        cfg = InflateConfig(in_cap=self.IN_CAP, out_cap=self.OUT_CAP)
        run = get_inflater(cfg)
        self.out_lens = out_lens
        self.res = run(jnp.asarray(streams), jnp.asarray(in_lens), jnp.asarray(out_lens))

    def result(self) -> bytes:
        import numpy as np

        out = np.asarray(self.res["out"])
        ok = np.asarray(self.res["ok"])
        crc = np.asarray(self.res["crc"])
        pieces = []
        # per-reader telemetry: stats live on the owning ParDecompress
        # (``reader.fallback_stats``) and the FIRST fallback warns.
        stats = self.owner.fallback_stats
        batch_fallbacks = 0
        for i, blk in enumerate(self.blocks):
            fv = self.footers[i]
            good = (
                i not in self.native_idx
                and bool(ok[i])
                and int(crc[i]) == fv.sum
            )
            if good:
                stats["device"] += 1
                pieces.append(out[i, : fv.amount].tobytes())
            else:
                # native path re-decodes and raises precise errors
                stats["native"] += 1
                batch_fallbacks += 1
                pieces.append(_decode_block(self.fmt, blk))
        if batch_fallbacks and not self.owner._warned_fallback:
            self.owner._warned_fallback = True
            import logging

            logging.getLogger("gzp_tpu").warning(
                "backend='device': %d/%d blocks of this batch fell back "
                "to the native decoder (block exceeds device caps or "
                "device decode failed); totals so far: %r — consider "
                "backend='native'",
                batch_fallbacks, len(self.blocks), stats,
            )
        return b"".join(pieces)


class SyncBlockReader(io.RawIOBase):
    """Single-threaded block reader (``MgzipSyncReader``/``BgzfSyncReader``
    equivalents, reference src/mgzip.rs:327-376, src/bgzf.rs:359-408)."""

    def __init__(self, format_spec: BlockFormatSpec, reader: BinaryIO) -> None:
        self._par = ParDecompress(format_spec, reader, num_threads=1, queue_depth=1)

    def read(self, size: int = -1) -> bytes:
        return self._par.read(size)

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        self._par.close()
        super().close()


class MultiGzDecoder(io.RawIOBase):
    """Streaming multi-member gzip decoder over the native inflate — the
    0-thread fallback reader (reference maybe_par_from_reader returns
    flate2's MultiGzDecoder, src/par/decompress.rs:93-99).

    Handles arbitrary standard gzip streams (FEXTRA/FNAME/FCOMMENT/FHCRC),
    concatenated members included. Decodes one member at a time with
    bounded buffering: memory is O(largest member + read chunk),
    constant for multi-member streams, NOT O(stream).
    """

    _READ0 = 1 << 20

    def __init__(self, reader: BinaryIO) -> None:
        self.reader = reader
        self._in = bytearray()
        self._eof_in = False
        self._readsize = self._READ0
        self._pending = b""  # decoded bytes not yet handed to the caller

    def _fill(self) -> None:
        # loop to the full chunk size: short-read sources (pipes,
        # sockets) would otherwise add a few bytes per failed decode
        # attempt, turning member decoding quadratic
        want = self._readsize
        got = 0
        while got < want:
            chunk = self.reader.read(want - got)
            if not chunk:
                self._eof_in = True
                break
            self._in += chunk
            got += len(chunk)
        # grow so a large member is retried O(log) times, not O(n)
        self._readsize = min(self._readsize * 2, 1 << 27)

    def _next_member(self) -> bytes | None:
        """Decode the next complete member from the input buffer, reading
        more input as needed. None at clean end-of-stream."""
        native = get_native()
        while True:
            if self._in:
                try:
                    newpos, plain = self._decode_member(bytes(self._in), 0, native)
                    del self._in[:newpos]
                    return plain
                except InvalidCheckError:
                    raise  # complete member, wrong CRC: real corruption
                except (DecompressError, InvalidHeaderError, ValueError, struct.error):
                    if self._eof_in:
                        raise  # truncated/garbage tail with no more input
            elif self._eof_in:
                return None
            self._fill()

    @staticmethod
    def _decode_member(blob: bytes, pos: int, native) -> tuple[int, bytes]:
        if len(blob) - pos < 18:
            raise InvalidHeaderError("truncated gzip member")
        if blob[pos] != 0x1F or blob[pos + 1] != 0x8B or blob[pos + 2] != 8:
            raise InvalidHeaderError("bad gzip magic")
        flg = blob[pos + 3]
        p = pos + 10
        if flg & 4:  # FEXTRA
            xlen = struct.unpack_from("<H", blob, p)[0]
            p += 2 + xlen
        if flg & 8:  # FNAME
            p = blob.index(b"\x00", p) + 1
        if flg & 16:  # FCOMMENT
            p = blob.index(b"\x00", p) + 1
        if flg & 2:  # FHCRC
            p += 2
        # inflate with unknown output size: grow the buffer on overflow
        cap = max(4 * (len(blob) - p), 1 << 16)
        import numpy as np

        while True:
            out = np.empty(cap, dtype=np.uint8)
            try:
                n, consumed = native.inflate_into(blob[p:], memoryview(out))
                break
            except DecompressError as e:
                if "overflow" in str(e) and cap < 1 << 34:
                    cap *= 4
                    continue
                raise
        plain = out[:n].tobytes()
        fpos = p + consumed
        if len(blob) - fpos < 8:
            raise DecompressError("truncated gzip footer")
        crc_want, isize_want = struct.unpack_from("<II", blob, fpos)
        crc = native.crc32(plain, 0)
        if crc != crc_want:
            raise InvalidCheckError(found=crc, expected=crc_want)
        if (len(plain) & 0xFFFFFFFF) != isize_want:
            raise DecompressError("gzip ISIZE mismatch")
        return fpos + 8, plain

    def read(self, size: int = -1) -> bytes:
        parts = []
        have = 0
        if self._pending:
            parts.append(self._pending)
            have = len(self._pending)
            self._pending = b""
        while size < 0 or have < size:
            member = self._next_member()
            if member is None:
                break
            parts.append(member)
            have += len(member)
        out = b"".join(parts)
        if size >= 0 and len(out) > size:
            self._pending = out[size:]
            out = out[:size]
        return out

    def readable(self) -> bool:
        return True


class ParDecompressBuilder:
    """Mirror of the reference's ``ParDecompressBuilder``
    (src/par/decompress.rs:17-109): ``num_threads`` / ``buffer_size`` /
    ``queue_size`` / ``pin_threads`` knobs ahead of ``from_reader``."""

    def __init__(self, format_spec: BlockFormatSpec):
        self.format_spec = format_spec
        self._num_threads = DEFAULT_DECOMPRESS_THREADS
        self._queue_depth: int | None = None

    def num_threads(self, n: int) -> "ParDecompressBuilder":
        if n < 1:
            raise NumThreadsError(n)
        self._num_threads = n
        return self

    def buffer_size(self, size: int) -> "ParDecompressBuilder":
        """Validated for parity (reference src/par/decompress.rs:40-46);
        block reads are sized by each block's own framing, so the knob
        has no effect beyond validation here."""
        from gzp_tpu.constants import DICT_SIZE
        from gzp_tpu.errors import BufferSizeError

        if size < DICT_SIZE:
            raise BufferSizeError(size, DICT_SIZE)
        return self

    def queue_size(self, n: int) -> "ParDecompressBuilder":
        """Bounded lookahead (the reference's channel bound is
        ``2 * num_threads``, src/par/decompress.rs:70)."""
        if n < 1:
            raise ValueError(f"queue_size must be >= 1, got {n}")
        self._queue_depth = n
        return self

    def pin_threads(self, pin: int | None) -> "ParDecompressBuilder":
        # API parity no-op: thread pinning is meaningless for the device
        # path, and the reference itself degrades to a warning no-op on
        # unsupported platforms (src/par/decompress.rs:57-66).
        del pin
        return self

    def from_reader(self, reader: BinaryIO) -> ParDecompress:
        return ParDecompress(
            self.format_spec,
            reader,
            num_threads=self._num_threads,
            queue_depth=self._queue_depth,
        )

    def maybe_par_from_reader(self, reader: BinaryIO, num_threads: int | None = None):
        """0 threads -> whole-stream MultiGzDecoder, else ParDecompress
        (reference src/par/decompress.rs:86-99)."""
        n = self._num_threads if num_threads is None else num_threads
        if n == 0:
            return MultiGzDecoder(reader)
        return ParDecompress(
            self.format_spec, reader, num_threads=n, queue_depth=self._queue_depth
        )
