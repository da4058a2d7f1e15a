"""Precomputed numpy lookup tables for the device codecs.

All tables are built once at import (or cached per-shape) on the host with
numpy and baked into jitted programs as constants. This replaces the
reference's reliance on zlib-ng/libdeflate internal tables (reference
src/deflate.rs L0 backends) with explicit, testable table construction.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np

from gzp_tpu import check as _check

# ---------------------------------------------------------------------------
# Bit utilities
# ---------------------------------------------------------------------------


def reverse_bits(value: int, width: int) -> int:
    """Reverse the low ``width`` bits of ``value`` (DEFLATE Huffman codes are
    emitted MSB-first into an LSB-first bitstream, RFC 1951 §3.1.1)."""
    out = 0
    for _ in range(width):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


# ---------------------------------------------------------------------------
# Fixed Huffman tables (RFC 1951 §3.2.6)
# ---------------------------------------------------------------------------


@functools.cache
def fixed_litlen_codes() -> tuple[np.ndarray, np.ndarray]:
    """(codes_reversed[288] uint32, nbits[288] int32) for the fixed
    literal/length alphabet."""
    codes = np.zeros(288, dtype=np.uint32)
    nbits = np.zeros(288, dtype=np.int32)
    for sym in range(288):
        if sym <= 143:
            code, width = 0x30 + sym, 8
        elif sym <= 255:
            code, width = 0x190 + (sym - 144), 9
        elif sym <= 279:
            code, width = sym - 256, 7
        else:
            code, width = 0xC0 + (sym - 280), 8
        codes[sym] = reverse_bits(code, width)
        nbits[sym] = width
    return codes, nbits


@functools.cache
def fixed_dist_codes() -> tuple[np.ndarray, np.ndarray]:
    """(codes_reversed[30] uint32, nbits[30]=5 int32) for fixed distance codes."""
    codes = np.array([reverse_bits(sym, 5) for sym in range(30)], dtype=np.uint32)
    nbits = np.full(30, 5, dtype=np.int32)
    return codes, nbits


# ---------------------------------------------------------------------------
# Length / distance symbol mapping tables (RFC 1951 §3.2.5)
# ---------------------------------------------------------------------------

# (symbol, extra_bits, base_length) rows for length codes 257..285.
_LENGTH_ROWS = [
    (257, 0, 3), (258, 0, 4), (259, 0, 5), (260, 0, 6), (261, 0, 7),
    (262, 0, 8), (263, 0, 9), (264, 0, 10),
    (265, 1, 11), (266, 1, 13), (267, 1, 15), (268, 1, 17),
    (269, 2, 19), (270, 2, 23), (271, 2, 27), (272, 2, 31),
    (273, 3, 35), (274, 3, 43), (275, 3, 51), (276, 3, 59),
    (277, 4, 67), (278, 4, 83), (279, 4, 99), (280, 4, 115),
    (281, 5, 131), (282, 5, 163), (283, 5, 195), (284, 5, 227),
    (285, 0, 258),
]

# (symbol, extra_bits, base_distance) rows for distance codes 0..29.
_DIST_ROWS = [
    (0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 0, 4),
    (4, 1, 5), (5, 1, 7),
    (6, 2, 9), (7, 2, 13),
    (8, 3, 17), (9, 3, 25),
    (10, 4, 33), (11, 4, 49),
    (12, 5, 65), (13, 5, 97),
    (14, 6, 129), (15, 6, 193),
    (16, 7, 257), (17, 7, 385),
    (18, 8, 513), (19, 8, 769),
    (20, 9, 1025), (21, 9, 1537),
    (22, 10, 2049), (23, 10, 3073),
    (24, 11, 4097), (25, 11, 6145),
    (26, 12, 8193), (27, 12, 12289),
    (28, 13, 16385), (29, 13, 24577),
]


@functools.cache
def length_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Indexed by match length 0..258: (symbol, extra_bit_count, base)."""
    sym = np.zeros(259, dtype=np.int32)
    eb = np.zeros(259, dtype=np.int32)
    base = np.zeros(259, dtype=np.int32)
    for s, e, b in _LENGTH_ROWS:
        hi = 259 if s == 285 else b + (1 << e)
        # symbol 285 covers only length 258 (length 258 must use it; the
        # 284+extra encoding of 258 is invalid per RFC 1951)
        if s == 284:
            hi = 258  # 284 covers 227..257 only
        sym[b:hi] = s
        eb[b:hi] = e
        base[b:hi] = b
    sym[258] = 285
    eb[258] = 0
    base[258] = 258
    return sym, eb, base


@functools.cache
def dist_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Indexed by distance 0..32768: (symbol, extra_bit_count, base)."""
    sym = np.zeros(32769, dtype=np.int32)
    eb = np.zeros(32769, dtype=np.int32)
    base = np.zeros(32769, dtype=np.int32)
    for s, e, b in _DIST_ROWS:
        hi = min(32769, b + (1 << e))
        sym[b:hi] = s
        eb[b:hi] = e
        base[b:hi] = b
    return sym, eb, base


# ---------------------------------------------------------------------------
# CRC tables for the device checksum kernels
# ---------------------------------------------------------------------------


@functools.cache
def crc_byte_table(poly: int) -> np.ndarray:
    """Classic 256-entry byte-update table (uint32)."""
    return _check.crc_table(poly)


@functools.cache
def crc_position_table(seg_len: int, poly: int) -> np.ndarray:
    """Flat ``[seg_len * 256]`` uint32 table: entry ``q*256 + v`` is the raw
    CRC register produced by byte ``v`` at offset ``q`` of a ``seg_len``-byte
    segment followed by zeros — i.e. the linear contribution of that byte to
    the segment's raw CRC. A segment's raw CRC is then the XOR of one lookup
    per byte: fully parallel, no byte-serial loop.
    """
    t256 = crc_byte_table(poly)
    out = np.zeros((seg_len, 256), dtype=np.uint32)
    # Row q must equal O_{seg_len-1-q}(t256[v]) where O_k advances the
    # register past k zero bytes; built back-to-front, each row is the next
    # row advanced one more zero byte: r -> (r>>8) ^ t256[r & 0xFF].
    out[seg_len - 1] = t256
    for q in range(seg_len - 2, -1, -1):
        prev = out[q + 1]
        out[q] = (prev >> np.uint32(8)) ^ t256[prev & np.uint32(0xFF)]
    return out.reshape(-1)


@functools.cache
def crc_fold_tables(seg_len: int, num_levels: int, poly: int) -> np.ndarray:
    """``[num_levels, 4, 256]`` operator tables; level k advances a register
    past ``seg_len * 2**k`` zero bytes (for the binary combine tree)."""
    levels = [
        _check.crc_operator_tables(seg_len * (1 << k), poly)
        for k in range(num_levels)
    ]
    return np.stack(levels, axis=0)


@functools.cache
def crc_unshift_ladder(max_log: int, poly: int) -> np.ndarray:
    """``[max_log, 4, 256]`` tables; level k *removes* ``2**k`` trailing zero
    bytes from a raw CRC register (inverse shift operator)."""
    one = _check._zero_bit_operator(poly)
    for _ in range(3):
        one = _check._gf2_matrix_square(one)  # one zero byte
    inv1 = _check.gf2_matrix_invert(one)
    levels = []
    cur = inv1
    for _ in range(max_log):
        levels.append(_matrix_to_tables(cur))
        cur = _check._gf2_matrix_square(cur)
    return np.stack(levels, axis=0)


@functools.cache
def crc_shift_ladder(max_log: int, poly: int) -> np.ndarray:
    """``[max_log, 4, 256]`` tables; level k advances a register past
    ``2**k`` zero bytes (forward shift operator)."""
    one = _check._zero_bit_operator(poly)
    for _ in range(3):
        one = _check._gf2_matrix_square(one)
    levels = []
    cur = one
    for _ in range(max_log):
        levels.append(_matrix_to_tables(cur))
        cur = _check._gf2_matrix_square(cur)
    return np.stack(levels, axis=0)


def _matrix_to_tables(mat: list[int]) -> np.ndarray:
    """32x32 GF(2) matrix -> [4, 256] uint32 byte-lookup tables."""
    tables = np.zeros((4, 256), dtype=np.uint32)
    for byte_idx in range(4):
        vals = np.zeros(256, dtype=np.uint32)
        idx = np.arange(256)
        for bit in range(8):
            col = np.uint32(mat[byte_idx * 8 + bit])
            mask = ((idx >> bit) & 1).astype(bool)
            vals[mask] ^= col
        tables[byte_idx] = vals
    return tables


@functools.cache
def crc_init_constant(total_len: int, poly: int) -> int:
    """Raw register after feeding ``total_len`` zero bytes from init ~0.

    Used to fold the standard pre-conditioning into the linear segment CRC:
    crc32(block) == ~(init_const ^ raw_xor_crc(block)).
    """
    if poly == _check.CRC32_POLY:
        return (zlib.crc32(b"\x00" * total_len) ^ 0xFFFFFFFF) & 0xFFFFFFFF
    # generic: advance ~0 through total_len zero bytes with the table
    t256 = crc_byte_table(poly)
    r = np.uint32(0xFFFFFFFF)
    # O(total_len) python loop would be slow for big N; use operator matrix.
    tabs = _check.crc_operator_tables(total_len, poly)
    return int(_check.apply_operator_tables(tabs, np.array([r], dtype=np.uint32))[0])


@functools.cache
def crc_bit_matrix(seg_len: int, poly: int) -> np.ndarray:
    """``[seg_len*8, 32]`` GF(2) basis matrix: row ``q*8+b`` is the raw CRC
    register contributed by bit ``b`` of the byte at offset ``q`` of a
    ``seg_len``-byte segment, unpacked to 0/1 int8.

    Lets the per-segment raw CRC be computed as ONE int8 matmul mod 2
    (bits[B*S, seg*8] @ M) in place of a per-byte table gather.
    """
    pos = crc_position_table(seg_len, poly).reshape(seg_len, 256)
    contrib = pos[:, [1 << b for b in range(8)]]  # [seg, 8] uint32
    bits = (
        (contrib[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    ).astype(np.int8)
    return bits.reshape(seg_len * 8, 32)


@functools.cache
def crc_seg_fold_matrix(nseg: int, seg_len: int, poly: int) -> np.ndarray:
    """``[nseg*32, 32]`` GF(2) matrix folding per-segment raw CRCs into the
    whole-block raw CRC: rows ``s*32 + j`` hold the register produced by
    bit ``j`` of segment ``s``'s CRC after advancing past the
    ``(nseg-1-s)*seg_len`` zero bytes that follow it (pigz-COMB as one
    matmul instead of a log-depth gather tree)."""
    max_log = max(int(nseg * seg_len).bit_length(), 1)
    ladder = crc_shift_ladder(max_log, poly)  # [L, 4, 256] uint32
    regs = np.broadcast_to(
        (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, :], (nseg, 32)
    ).copy()
    m = (nseg - 1 - np.arange(nseg, dtype=np.int64)) * seg_len
    for k in range(max_log):
        mask = ((m >> k) & 1).astype(bool)
        if not mask.any():
            continue
        t = ladder[k]
        r = regs[mask]
        regs[mask] = (
            t[0, r & 0xFF]
            ^ t[1, (r >> 8) & 0xFF]
            ^ t[2, (r >> 16) & 0xFF]
            ^ t[3, (r >> 24) & 0xFF]
        )
    bits = ((regs[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int8)
    return bits.reshape(nseg * 32, 32)
