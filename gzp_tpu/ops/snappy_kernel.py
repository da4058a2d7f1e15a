"""Batched snappy-frame encoder.

Device-side equivalent of the reference's snap-crate backend
(reference src/snap.rs:34-83: each gzp block is encoded as a complete
snappy *frame* — stream identifier + chunks — so concatenated blocks form
a valid framed stream). One lane = one block = one frame with a single
chunk (blocks are capped at snappy's 65536-byte chunk size).

Snappy block format (byte-aligned, google/snappy format_description.txt):
  * preamble: uncompressed length as LE base-128 varint
  * literal elements: tag ``(len-1)<<2 | 0b00`` (len <= 60 tag-only form)
  * copies with 2-byte offset: tag ``(len-1)<<2 | 0b10`` + u16le offset
    (lengths 4..64 — exactly our match-length cap)

Literal runs are grouped with cummax/cummin over positions and chunked
into <=60-byte tag-only literal elements; each position contributes at
most one <=24-bit entry, and the whole frame body (varint preamble
included, as a dynamic-width head entry) is assembled by the
scatter-free sortscan packer (gzp_tpu.ops.deflate_kernel).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from gzp_tpu.constants import SNAPPY_MAX_CHUNK, SNAPPY_MIN_MATCH, SNAPPY_STREAM_IDENTIFIER
from gzp_tpu.ops import lz
from gzp_tpu.ops.checksum import crc32c_masked_device
from gzp_tpu.ops.deflate_kernel import pack_entries_sortscan

_U32 = jnp.uint32
_I32 = jnp.int32
_U8 = jnp.uint8

_HDR = 18  # stream identifier (10) + chunk header (4) + masked crc (4)
_MAX_LIT_ELEM = 60  # tag-only literal element cap


@dataclass(frozen=True)
class SnappyEncodeConfig:
    block_len: int  # N <= 65536
    window: int = 256  # legacy (round-2 windowed parse A/B only)
    max_words: int = 8
    # matches longer than 64 are emitted as CHAINS of tag-10 copies
    # (reference snap crate behavior, src/snap.rs:34-83); the scan parse
    # bounds a single token at 255, chains split it into <=64 pieces
    max_match: int = 256
    max_chain_piece: int = 64  # tag-10 copy length cap (format limit)
    # matcher knobs: the same defaults as DEFLATE levels 2-5
    payload_words: int = 3
    lags: int = 2
    sample_step: int = 1
    parse: str = "scan"  # 'scan' (default) | 'window' (round-2 A/B)

    @property
    def out_bytes(self) -> int:
        n = self.block_len
        worst = _HDR + 3 + n + (n + _MAX_LIT_ELEM - 1) // _MAX_LIT_ELEM + 8
        return (worst + 3) & ~3


def encode_snappy_blocks(cfg: SnappyEncodeConfig, data_u8, lengths, is_final):
    """Compress a batch of blocks into framed snappy. Returns the same
    output contract as the deflate encoder: ``out`` [B, out_bytes] uint8,
    ``out_len`` [B] int32, ``check`` [B] uint32 (masked CRC32C of the
    uncompressed chunk — also embedded in the frame).

    Emission: one <=24-bit entry per *position* (literal byte /
    tag+byte / match tag+offset, all byte-aligned bit widths), packed by
    the scatter-free sortscan packer — no per-token compaction, no
    gathers, no scatters.
    """
    del is_final  # snappy frames need no stream-close marker
    b, n = data_u8.shape
    assert n == cfg.block_len and n <= SNAPPY_MAX_CHUNK

    match_len, match_dist = lz.best_matches(
        data_u8,
        lengths,
        max_dist=SNAPPY_MAX_CHUNK - 1,
        max_match=cfg.max_match,
        min_emit=SNAPPY_MIN_MATCH,
        max_words=cfg.max_words,
        payload_words=cfg.payload_words,
        lags=cfg.lags,
        sample_step=cfg.sample_step,
    )
    if cfg.parse == "scan":
        marked, l = lz.parse_marks_scan(
            match_len, lengths, min_emit=SNAPPY_MIN_MATCH
        )
    else:
        marked, l = lz.parse_marks(
            match_len, lengths, window=cfg.window, min_emit=SNAPPY_MIN_MATCH
        )
    is_match = jnp.logical_and(marked, l > 0)
    is_lit = jnp.logical_and(marked, l == 0)
    i_idx = jnp.broadcast_to(jnp.arange(n, dtype=_I32)[None, :], (b, n))

    # ----- literal-run grouping over positions -----
    prev_lit = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.bool_), is_lit[:, :-1]], axis=1
    )
    run_start = jnp.logical_and(is_lit, jnp.logical_not(prev_lit))
    start_idx = jax.lax.cummax(jnp.where(run_start, i_idx, -1), axis=1)
    big = jnp.asarray(n, _I32)
    nonlit_idx = jnp.where(is_lit, big, i_idx)
    run_end = jax.lax.cummin(nonlit_idx[:, ::-1], axis=1)[:, ::-1]

    r = i_idx - start_idx  # position within the literal run
    remain = run_end - i_idx  # literals remaining in the run (incl. self)
    has_tag = jnp.logical_and(is_lit, r % _MAX_LIT_ELEM == 0)

    # ----- chained copies: every 64th covered position of a match token
    # starts a fresh tag-10 element with the same offset (matches longer
    # than 64 thereby use ceil(l/64) copies instead of being capped) -----
    tok_start = jax.lax.cummax(jnp.where(is_match, i_idx, -1), axis=1)

    def _propagate(vals):
        # carry the last match-start's value forward across covered slots
        def op(a, bb):
            av, aval = a
            bv, bval = bb
            return jnp.logical_or(av, bv), jnp.where(bv, bval, aval)

        _, out = jax.lax.associative_scan(
            op, (is_match, vals), axis=1
        )
        return out

    carried_l = _propagate(jnp.where(is_match, l, 0))
    carried_d = _propagate(jnp.where(is_match, match_dist, 0))
    rel = i_idx - tok_start
    in_match = jnp.logical_and(tok_start >= 0, rel < carried_l)
    chunk_start = jnp.logical_and(in_match, rel % cfg.max_chain_piece == 0)
    chunk_len = jnp.minimum(cfg.max_chain_piece, carried_l - rel)

    # ----- per-position entries (bit widths are byte multiples) -----
    lit_byte = data_u8.astype(_U32)
    lit_tag = ((jnp.minimum(remain, _MAX_LIT_ELEM) - 1) << 2).astype(_U32)
    m_tag = (2 | ((chunk_len - 1) << 2)).astype(_U32)
    doff = carried_d.astype(_U32)

    entry = jnp.where(
        is_lit,
        jnp.where(has_tag, lit_tag | (lit_byte << 8), lit_byte),
        jnp.where(chunk_start, m_tag | ((doff & 0xFF) << 8) | ((doff >> 8) << 16), 0),
    )
    width = jnp.where(
        is_lit, 8 * (1 + has_tag.astype(_I32)), jnp.where(chunk_start, 24, 0)
    )

    # varint preamble for the uncompressed length, as ONE dynamic-width
    # entry at the head of the element stream — that keeps the packer's
    # base offset static (the frame header is fixed-size) and routes the
    # whole frame body through the scatter-free sortscan packer
    ln = lengths.astype(_I32)
    varint_len = jnp.where(ln < 128, 1, jnp.where(ln < 16384, 2, 3))
    lnu = ln.astype(_U32)
    b0 = jnp.where(varint_len > 1, (lnu & 0x7F) | 0x80, lnu & 0x7F)
    b1 = jnp.where(varint_len > 2, ((lnu >> 7) & 0x7F) | 0x80, (lnu >> 7) & 0x7F)
    b2 = (lnu >> 14) & 0x7F
    ventry = (
        b0
        | jnp.where(varint_len >= 2, b1 << 8, 0)
        | jnp.where(varint_len >= 3, b2 << 16, 0)
    )

    all_bits = jnp.concatenate([ventry[:, None], entry], axis=1)
    all_n = jnp.concatenate([(8 * varint_len)[:, None], width], axis=1)
    out_words = cfg.out_bytes // 4
    words, total_bits = pack_entries_sortscan(
        all_bits, all_n, 8 * _HDR, out_words
    )
    elem_total = (total_bits >> 3) - _HDR - varint_len
    out = jnp.stack(
        [words & 0xFF, (words >> 8) & 0xFF, (words >> 16) & 0xFF, (words >> 24) & 0xFF],
        axis=-1,
    ).reshape(b, cfg.out_bytes).astype(_U8)

    # ----- frame headers -----
    sid = jnp.asarray(np.frombuffer(SNAPPY_STREAM_IDENTIFIER, np.uint8))
    out = out.at[:, :10].set(sid[None, :])
    chunk_len = (4 + varint_len + elem_total).astype(_U32)
    out = out.at[:, 10].set(jnp.zeros((b,), _U8))  # chunk type 0x00
    out = out.at[:, 11].set((chunk_len & 0xFF).astype(_U8))
    out = out.at[:, 12].set(((chunk_len >> 8) & 0xFF).astype(_U8))
    out = out.at[:, 13].set(((chunk_len >> 16) & 0xFF).astype(_U8))
    crc = crc32c_masked_device(data_u8, lengths)
    out = out.at[:, 14].set((crc & 0xFF).astype(_U8))
    out = out.at[:, 15].set(((crc >> 8) & 0xFF).astype(_U8))
    out = out.at[:, 16].set(((crc >> 16) & 0xFF).astype(_U8))
    out = out.at[:, 17].set(((crc >> 24) & 0xFF).astype(_U8))

    out_len = jnp.where(ln > 0, _HDR + varint_len + elem_total, 10)
    ntok = jnp.sum(marked.astype(_I32), axis=1)
    return {"out": out, "out_len": out_len.astype(_I32), "check": crc, "ntok": ntok}


@functools.lru_cache(maxsize=16)
def get_snappy_encoder(cfg: SnappyEncodeConfig):
    @jax.jit
    def run(data_u8, lengths, is_final):
        return encode_snappy_blocks(cfg, data_u8, lengths, is_final)

    return run
