"""Block-parallel compression runtime — the ``ParCompress`` equivalent.

Reference architecture (src/par/compress.rs): caller buffer accumulation,
N compressor worker threads fed over bounded channels, and an ordered
writer thread stitching results. The device-batched shape of the same design:

* the caller's ``write()`` accumulates bytes and cuts fixed-size blocks
  (reference ``ParCompress::write``, src/par/compress.rs:404-463);
* a *batch* of ``num_threads`` blocks is padded into a static ``[B, N]``
  uint8 array and dispatched to the jitted device encoder — the worker
  pool becomes data-parallel lanes of one XLA program (optionally sharded
  over a device mesh);
* JAX's async dispatch is the pipeline: up to ``queue_depth`` batches are
  in flight while the host stitches finished ones in submission order —
  ordering is by construction (batch index), so the reference's
  channel-of-channels reordering machinery is unnecessary;
* per-block checksums come back with each batch and are folded into the
  stream check via O(log) combine (the pigz COMB trick, reference
  src/par/compress.rs:302-313).

Failure semantics mirror the reference: any device/sink error poisons the
writer; later calls surface the root error (src/par/compress.rs:428-457),
and ``close()``/GC finalizes the stream if the user forgets
(src/par/compress.rs:391-402).
"""

from __future__ import annotations

import collections
from typing import BinaryIO

import jax
import jax.numpy as jnp
import numpy as np

from gzp_tpu.constants import (
    DEFAULT_COMPRESSION_LEVEL,
    DICT_SIZE,
    MAX_BGZF_BLOCK_SIZE,
    clamp_compression_level,
)
from gzp_tpu.errors import (
    BlockSizeExceededError,
    BufferSizeError,
    ChannelError,
    NumThreadsError,
    WriterClosedError,
)
from gzp_tpu.formats.base import FormatSpec
from gzp_tpu.ops import host_codec
from gzp_tpu.ops.deflate_kernel import DeflateEncodeConfig, get_encoder

DEFAULT_NUM_THREADS = 16
DEFAULT_QUEUE_DEPTH = 3


class ParCompress:
    """Streaming writer compressing blocks in parallel on device.

    File-like: ``write``, ``flush``, ``finish``, ``close``, context manager.
    ``finish()`` finalizes the stream and returns the underlying writer
    (reference ``ZWriter::finish``, src/lib.rs:166-170).
    """

    def __init__(
        self,
        format_spec: FormatSpec,
        writer: BinaryIO,
        *,
        num_threads: int = DEFAULT_NUM_THREADS,
        compression_level: int = DEFAULT_COMPRESSION_LEVEL,
        buffer_size: int | None = None,
        queue_depth: int = DEFAULT_QUEUE_DEPTH,
        mesh: jax.sharding.Mesh | None = None,
        use_dict: bool = True,
        emit_header: bool = True,
        emit_footer: bool = True,
        final_on_finish: bool = True,
        preset_carry: bytes = b"",
        verify: bool = False,
    ) -> None:
        """Shard-mode knobs (public API for gzp_tpu.parallel.multihost —
        one host compresses a contiguous mid-stream block range):

        * ``emit_header=False``  — suppress the stream header (rank > 0)
        * ``emit_footer=False``  — suppress trailer+footer (the stitcher
          emits them once with the combined check)
        * ``final_on_finish=False`` — ``finish()`` dispatches the tail as
          a NON-final block (the stream continues in the next shard)
        * ``preset_carry``       — preset the 32 KiB dictionary from the
          previous shard's trailing input bytes

        ``verify=True`` oracle-decodes every emitted block on the host
        and swaps in a stored (uncompressed-deflate) encoding on any
        mismatch, recomputing the block checksum host-side, at host
        decode cost (``verify_stats`` counts checks and repairs). Off by
        default, like the reference, which trusts its codecs
        (src/par/compress.rs:288-289).
        """
        if num_threads < 1:
            raise NumThreadsError(num_threads)
        buffer_size = buffer_size or format_spec.default_bufsize
        if buffer_size < DICT_SIZE:
            # reference ParCompressBuilder::buffer_size (src/par/compress.rs:68-74)
            raise BufferSizeError(buffer_size, DICT_SIZE)
        if format_spec.max_input_block is not None:
            buffer_size = min(buffer_size, format_spec.max_input_block)

        self.format = format_spec
        self.writer = writer
        self.level = clamp_compression_level(compression_level)
        self.block_size = buffer_size
        self.batch = max(1, num_threads)
        self.queue_depth = queue_depth
        self.mesh = mesh

        self._verify = verify
        self.verify_stats = {"checked": 0, "repaired": 0}
        self._verify_stream = None  # lazy zlib.decompressobj for stream mode
        self._emit_footer = emit_footer
        self._final_on_finish = final_on_finish
        self._buffer = bytearray()
        self._carry = b""  # previous block's trailing dict bytes
        self._inflight: collections.deque = collections.deque()
        self._check = format_spec.create_check()
        self._header_written = not emit_header
        self._finished = False
        self._error: BaseException | None = None
        self._wrote_final_block = False
        self._emitted_any = False
        if preset_carry:
            self._carry = preset_carry[-DICT_SIZE:]

        if format_spec.codec == "deflate":
            checksum = {"crc32": "crc32", "adler32": "adler32"}.get(
                format_spec.check_cls().name, "none"
            )
            dict_size = (
                DICT_SIZE
                if (use_dict and format_spec.needs_dict and format_spec.kernel_mode == "stream")
                else 0
            )
            self._cfg = DeflateEncodeConfig.for_level(
                block_len=self.block_size,
                mode=format_spec.kernel_mode,
                checksum=checksum,
                level=self.level,
                dict_size=dict_size,
            )
            self._encoder = get_encoder(self._cfg, compact=True)
        elif format_spec.codec == "snappy":
            from gzp_tpu.ops.snappy_kernel import SnappyEncodeConfig, get_snappy_encoder

            self._cfg = SnappyEncodeConfig(block_len=self.block_size)
            self._encoder = get_snappy_encoder(self._cfg)
        else:
            raise ValueError(f"unknown codec {format_spec.codec}")

        if mesh is not None:
            spec = jax.sharding.PartitionSpec(mesh.axis_names[0])
            sharding = jax.sharding.NamedSharding(mesh, spec)
            nargs = 5 if getattr(self._cfg, "dict_size", 0) else 3
            base = self._encoder
            self._encoder = jax.jit(
                base,
                in_shardings=(sharding,) * nargs,
                out_shardings=None,
            )
            if self.batch % mesh.size != 0:
                self.batch = ((self.batch + mesh.size - 1) // mesh.size) * mesh.size

    # ------------------------------------------------------------------
    # io.RawIOBase-ish surface
    # ------------------------------------------------------------------

    def write(self, data) -> int:
        self._ensure_open()
        self._buffer += data
        batch_bytes = self.block_size * self.batch
        while len(self._buffer) >= batch_bytes:
            chunk = bytes(self._buffer[:batch_bytes])
            del self._buffer[:batch_bytes]
            self._dispatch_full_batch(chunk)
        return len(data)

    def flush(self) -> None:
        """Push all buffered bytes through the device (a partial block is
        emitted as its own non-final block), drain, flush the sink."""
        self._ensure_open()
        if self._buffer:
            self._dispatch_tail(bytes(self._buffer), final=False)
            self._buffer.clear()
        self._drain_all()
        self.writer.flush()

    def finish(self):
        """Finalize the stream; returns the underlying writer."""
        if self._finished:
            return self.writer
        self._ensure_open()
        data = bytes(self._buffer)
        self._buffer.clear()
        self._dispatch_tail(data, final=self._final_on_finish)
        self._drain_all()
        if not self._header_written:
            self._write_header()
        if self._emit_footer:
            trailer = self.format.trailer_bytes()
            if trailer:
                self.writer.write(trailer)
            footer = self.format.footer(self._check)
            if footer:
                self.writer.write(footer)
        self._finished = True
        return self.writer

    @property
    def check(self):
        """The running stream checksum (combined across emitted blocks)."""
        return self._check

    def close(self) -> None:
        if not self._finished and self._error is None:
            self.finish()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.finish()

    def __del__(self):  # drop-implies-finish (reference src/par/compress.rs:391-402)
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    # pipeline internals
    # ------------------------------------------------------------------

    def _ensure_open(self) -> None:
        if self._finished:
            raise WriterClosedError("writer already finished")
        if self._error is not None:
            raise ChannelError("compression pipeline failed") from self._error

    def _write_header(self) -> None:
        hdr = self.format.header(self.level)
        if hdr:
            self.writer.write(hdr)
        self._header_written = True

    def _dispatch_full_batch(self, chunk: bytes) -> None:
        n, b = self.block_size, self.batch
        arr = np.frombuffer(chunk, dtype=np.uint8).reshape(b, n)
        lengths = np.full(b, n, dtype=np.int32)
        finals = np.zeros(b, dtype=bool)
        self._dispatch(arr, lengths, finals)

    def _make_halo(self, arr: np.ndarray, lengths: np.ndarray):
        """Per-block preset dictionaries: row i gets the trailing bytes of
        row i-1 (right-aligned); row 0 gets the carry from the previous
        batch. Returns (halo [B,D] u8, dict_lens [B] i32) or (None, None)."""
        d = getattr(self._cfg, "dict_size", 0)
        if not d:
            return None, None
        b, n = arr.shape
        halo = np.zeros((b, d), dtype=np.uint8)
        dict_lens = np.zeros(b, dtype=np.int32)
        if self._carry:
            cl = min(len(self._carry), d)
            halo[0, d - cl :] = np.frombuffer(self._carry[-cl:], np.uint8)
            dict_lens[0] = cl
        if b > 1:
            # vectorized: row i gets arr[i-1, pl-cl : pl] right-aligned
            pl = lengths[:-1].astype(np.int64)  # [b-1]
            cl = np.minimum(pl, d)
            src = pl[:, None] - d + np.arange(d, dtype=np.int64)[None, :]
            vals = np.take_along_axis(arr[:-1], np.clip(src, 0, n - 1), axis=1)
            halo[1:] = np.where(src >= (pl - cl)[:, None], vals, 0)
            dict_lens[1:] = cl
        return halo, dict_lens

    def _update_carry(self, arr: np.ndarray, lengths: np.ndarray, count: int) -> None:
        d = getattr(self._cfg, "dict_size", 0)
        if not d or count == 0:
            return
        pl = int(lengths[count - 1])
        cl = min(pl, d)
        if cl:
            self._carry = arr[count - 1, pl - cl : pl].tobytes()

    def _dispatch_tail(self, data: bytes, final: bool) -> None:
        """Dispatch remaining bytes (always < one full batch), padding the
        batch; marks the last real block final when closing the stream.
        A final call with no data still dispatches one empty final block —
        that's what closes a deflate stream / emits the empty member for an
        empty input (reference flush_last, src/par/compress.rs:332-341)."""
        n, b = self.block_size, self.batch
        if not data and not final:
            return
        if not data and final and self._wrote_final_block:
            return
        while True:
            take = data[: n * b]
            data = data[n * b :]
            cnt = -(-len(take) // n) if take else (1 if final and not data else 0)
            if cnt == 0:
                return
            arr = np.zeros((b, n), dtype=np.uint8)
            lengths = np.zeros(b, dtype=np.int32)
            finals = np.zeros(b, dtype=bool)
            for i in range(cnt):
                piece = take[i * n : (i + 1) * n]
                arr[i, : len(piece)] = np.frombuffer(piece, dtype=np.uint8)
                lengths[i] = len(piece)
            if final and not data:
                finals[cnt - 1] = True
                self._wrote_final_block = True
            self._dispatch(arr, lengths, finals, count=cnt)
            if not data:
                return

    def _dispatch(self, arr, lengths, finals, count: int | None = None) -> None:
        halo, dict_lens = self._make_halo(arr, lengths)
        self._update_carry(arr, lengths, count or len(lengths))
        try:
            if halo is not None:
                res = self._encoder(
                    jnp.asarray(arr),
                    jnp.asarray(lengths),
                    jnp.asarray(finals),
                    jnp.asarray(halo),
                    jnp.asarray(dict_lens),
                )
            else:
                res = self._encoder(
                    jnp.asarray(arr), jnp.asarray(lengths), jnp.asarray(finals)
                )
        except Exception as e:  # compile/dispatch failure
            self._error = e
            raise
        self._inflight.append((res, arr, lengths, finals, count or len(lengths)))
        while len(self._inflight) > self.queue_depth:
            self._consume_one()

    def _drain_all(self) -> None:
        while self._inflight:
            self._consume_one()

    def _consume_one(self) -> None:
        res, arr, lengths, finals, count = self._inflight.popleft()
        try:
            out_len = np.asarray(res["out_len"])
            chks = np.asarray(res["check"])
            if "flat" in res:
                # compact path: fetch exactly sum(out_len) bytes, not the
                # padded [B, out_bytes] buffer
                total = int(out_len.sum())
                flat = np.asarray(res["flat"][:total])
                starts = np.cumsum(out_len) - out_len

                def get_blob(i):
                    s = int(starts[i])
                    return flat[s : s + int(out_len[i])].tobytes()

            else:
                out = np.asarray(res["out"])

                def get_blob(i):
                    return out[i, : int(out_len[i])].tobytes()

            if not self._header_written:
                self._write_header()
            self._stitch_batch(get_blob, chks, arr, lengths, finals, count)
        except Exception as e:
            # poison the writer; the root error is preserved and re-raised
            # (reference error-transparency, src/par/compress.rs:428-457)
            self._error = e
            raise

    def _stitch_batch(self, get_blob, chks, arr, lengths, finals, count) -> None:
        fmt = self.format
        member = fmt.kernel_mode in ("mgzip", "bgzf")
        pieces: list[bytes] = []
        for i in range(count):
            ln = int(lengths[i])
            fin = bool(finals[i])
            if ln == 0 and not fin:
                continue  # padding block
            if ln == 0 and fin and member and self._emitted_any:
                # member formats don't need a closing block; only an
                # entirely-empty stream gets one empty member
                continue
            blob = get_blob(i)
            raw = arr[i, :ln].tobytes()
            chk = int(chks[i])
            blob = self._maybe_fallback(blob, raw, ln, fin, chk)
            if self._verify:
                blob, chk = self._verify_or_repair(blob, raw, ln, fin, chk)
            self._check.combine(fmt.check_cls.from_sum(chk, ln))
            pieces.append(blob)
            self._emitted_any = True
        if pieces:
            self.writer.write(b"".join(pieces))

    def _verify_or_repair(
        self, blob: bytes, raw: bytes, ln: int, final: bool, chk: int
    ) -> tuple[bytes, int]:
        """Oracle-decode ``blob``; on any mismatch re-emit the block as a
        stored encoding (always byte-correct) with a host-recomputed
        checksum. See the ``verify`` constructor knob."""
        import zlib as _zlib

        mode = self.format.kernel_mode
        self.verify_stats["checked"] += 1
        ok = False
        try:
            if mode in ("mgzip", "bgzf"):
                payload = blob[self._cfg.header_len : len(blob) - 8]
                d = _zlib.decompressobj(-15)
                ok = d.decompress(payload) + d.flush() == raw
            elif mode == "stream":
                if self._verify_stream is None:
                    self._verify_stream = _zlib.decompressobj(-15)
                ok = self._verify_stream.decompress(blob) == raw
            elif mode == "snappy":
                from gzp_tpu.utils.snappy_ref import decode_frames

                ok = decode_frames(blob) == raw
        except Exception:  # noqa: BLE001 - any decode error means repair
            ok = False
        if ok:
            return blob, chk
        self.verify_stats["repaired"] += 1
        import logging

        logging.getLogger("gzp_tpu").warning(
            "verify: device-encoded block failed oracle decode; "
            "re-emitting stored (totals: %r)", self.verify_stats,
        )
        c = self.format.check_cls()
        c.update(raw)
        host_chk = c.sum
        if mode == "stream":
            blob = host_codec.stored_deflate(raw, final)
            # the incremental oracle consumed the bad blob; resync it on
            # the repaired bytes
            self._verify_stream = _zlib.decompressobj(-15)
            prefix_ok = self._verify_stream.decompress(blob) == raw
            assert prefix_ok or not raw
        elif mode in ("mgzip", "bgzf"):
            blob = host_codec.stored_member(raw, mode, self.level)
        else:  # snappy: uncompressed frame chunk (chunk CRC is the
            # device-computed masked CRC32C — the checksum stage reads
            # the input directly and is not part of the packing path)
            from gzp_tpu.constants import SNAPPY_STREAM_IDENTIFIER
            from gzp_tpu.utils.serialize import put_le

            blob = (
                SNAPPY_STREAM_IDENTIFIER
                + b"\x01"
                + put_le(ln + 4, 3)
                + put_le(chk, 4)
                + raw
            )
            host_chk = chk
        return blob, host_chk

    def _maybe_fallback(
        self, blob: bytes, raw: bytes, ln: int, final: bool, chk: int
    ) -> bytes:
        """Swap in a stored encoding when smaller (the per-block
        stored/compressed choice zlib makes); enforce the BGZF cap
        (reference src/bgzf.rs:218-223). For snappy, switch to an
        uncompressed frame chunk when compression expanded the block."""
        mode = self.format.kernel_mode
        if mode == "snappy":
            if ln:
                uncompressed_total = 10 + 4 + 4 + ln
                if len(blob) > uncompressed_total:
                    from gzp_tpu.constants import SNAPPY_STREAM_IDENTIFIER
                    from gzp_tpu.utils.serialize import put_le

                    blob = (
                        SNAPPY_STREAM_IDENTIFIER
                        + b"\x01"
                        + put_le(ln + 4, 3)
                        + put_le(chk, 4)
                        + raw
                    )
            return blob
        if mode == "stream":
            if ln and len(blob) > host_codec.stored_size(ln):
                stored = host_codec.stored_deflate(raw, final)
                if len(stored) < len(blob):
                    blob = stored
            return blob
        if mode in ("mgzip", "bgzf"):
            hdr = self._cfg.header_len
            if ln and len(blob) > hdr + 8 + host_codec.stored_size(ln):
                stored = host_codec.stored_member(raw, mode, self.level)
                if len(stored) < len(blob):
                    blob = stored
            if mode == "bgzf" and len(blob) >= MAX_BGZF_BLOCK_SIZE:
                raise BlockSizeExceededError(len(blob), MAX_BGZF_BLOCK_SIZE)
        return blob


class ParCompressBuilder:
    """Builder mirroring the reference's ``ParCompressBuilder``
    (src/par/compress.rs:33-204)."""

    def __init__(self, format_spec: FormatSpec):
        self.format_spec = format_spec
        self._num_threads = DEFAULT_NUM_THREADS
        self._level = DEFAULT_COMPRESSION_LEVEL
        self._buffer_size: int | None = None
        self._mesh: jax.sharding.Mesh | None = None
        self._queue_depth = DEFAULT_QUEUE_DEPTH
        self._verify = False

    def num_threads(self, n: int) -> "ParCompressBuilder":
        if n < 1:
            raise NumThreadsError(n)
        self._num_threads = n
        return self

    def compression_level(self, level: int) -> "ParCompressBuilder":
        self._level = level
        return self

    def buffer_size(self, size: int) -> "ParCompressBuilder":
        if size < DICT_SIZE:
            raise BufferSizeError(size, DICT_SIZE)
        self._buffer_size = size
        return self

    def pin_threads(self, _pin: int | None) -> "ParCompressBuilder":
        # No-op with a warning-equivalent: device placement replaces CPU
        # pinning (reference src/lib.rs:221-230 logs and continues).
        return self

    def mesh(self, mesh: jax.sharding.Mesh | None) -> "ParCompressBuilder":
        self._mesh = mesh
        return self

    def queue_depth(self, depth: int) -> "ParCompressBuilder":
        self._queue_depth = max(1, depth)
        return self

    def verify(self, on: bool = True) -> "ParCompressBuilder":
        """Oracle-decode every block on the host and repair mismatches
        with stored encodings (see ``ParCompress(verify=...)``)."""
        self._verify = on
        return self

    def from_writer(self, writer: BinaryIO) -> ParCompress:
        return ParCompress(
            self.format_spec,
            writer,
            num_threads=self._num_threads,
            compression_level=self._level,
            buffer_size=self._buffer_size,
            queue_depth=self._queue_depth,
            mesh=self._mesh,
            verify=self._verify,
        )
