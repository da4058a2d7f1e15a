"""gzp_tpu — parallel block compression on JAX accelerators.

A from-scratch JAX/XLA reimplementation of the capabilities of the
Rust library `gzp <https://github.com/sstadick/gzp>`_: parallel compression
of Gzip / Zlib / raw Deflate / Snappy-frame / Mgzip / BGZF streams (and
parallel decompression of the block-framed formats) behind a streaming
writer/reader API, with per-block checksums combined pigz-COMB style.
Blocks are compressed data-parallel as lanes of batched XLA programs and
sharded across device meshes instead of OS threads.

Example (executable — enforced by tests/test_docs.py, the analog of the
reference's doc-tests on its public entry points, reference src/lib.rs:25-72):

    >>> import io, gzip
    >>> from gzp_tpu import ZBuilder, Gzip
    >>> buf = io.BytesIO()
    >>> w = ZBuilder(Gzip).num_threads(4).compression_level(3).from_writer(buf)
    >>> _ = w.write(b"hello world " * 1000)
    >>> _ = w.finish()
    >>> gzip.decompress(buf.getvalue()) == b"hello world " * 1000
    True
"""

from gzp_tpu.check import Adler32, Check, Crc32, Crc32C, PassThroughCheck  # noqa: F401
from gzp_tpu.constants import BGZF_BLOCK_SIZE, BUFSIZE, DICT_SIZE  # noqa: F401
from gzp_tpu.errors import (  # noqa: F401
    BlockSizeExceededError,
    BufferSizeError,
    ChannelError,
    CompressError,
    DecompressError,
    GzpError,
    InvalidCheckError,
    InvalidHeaderError,
    NumThreadsError,
    WriterClosedError,
)
from gzp_tpu.formats import (  # noqa: F401
    ALL_FORMATS,
    Bgzf,
    BlockFormatSpec,
    FormatSpec,
    Gzip,
    Mgzip,
    RawDeflate,
    Snap,
    Zlib,
)
from gzp_tpu.formats.sync_io import (  # noqa: F401
    BgzfSyncReader,
    BgzfSyncWriter,
    MgzipSyncReader,
    MgzipSyncWriter,
)
from gzp_tpu.parallel.builder import ZBuilder  # noqa: F401
from gzp_tpu.parallel.compress import ParCompress, ParCompressBuilder  # noqa: F401
from gzp_tpu.parallel.decompress import (  # noqa: F401
    MultiGzDecoder,
    ParDecompress,
    ParDecompressBuilder,
    SyncBlockReader,
)
from gzp_tpu.parallel.syncz import SyncZ, SyncZBuilder  # noqa: F401

__version__ = "0.1.0"
