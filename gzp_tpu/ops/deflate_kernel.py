"""Batched DEFLATE encoder: token emission, bit packing, member assembly.

The device-side equivalent of the reference's
``FormatSpec::encode`` + libdeflate/zlib-ng compression core (reference
src/deflate.rs:88-110, src/mgzip.rs:184-242, src/bgzf.rs:200-270), for a
whole batch of blocks at once:

1. tokens (from :mod:`gzp_tpu.ops.lz`) are mapped to fixed-Huffman
   (RFC 1951 §3.2.6) bit strings — every token fits in <= 31 bits;
2. a prefix sum over bit lengths assigns each token an absolute bit
   offset; contributions are scattered into a uint32 word buffer (bits are
   LSB-first, so little-endian words == the deflate byte stream);
3. block-format members (Mgzip/BGZF) get their gzip member header (with
   the per-format size field) and CRC32+ISIZE footer written around the
   deflate payload on device, so a member leaves the chip fully framed.

Modes:
  * ``stream``: the block is a chunk of a continuous deflate stream —
    non-final chunks end with an empty stored block (Z_SYNC_FLUSH, the
    pigz block join; reference src/deflate.rs:96-100), the final chunk
    sets BFINAL and pads to a byte (FlushCompress::Finish).
  * ``mgzip`` / ``bgzf``: every block is a standalone gzip member
    (always BFINAL), framed per format.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from gzp_tpu.constants import (
    BGZF_HEADER_SIZE,
    MAX_DIST,
    MAX_MATCH,
    MGZIP_HEADER_SIZE,
    MIN_MATCH,
)
from gzp_tpu.ops import huffman, lz
from gzp_tpu.ops.checksum import adler32_device, crc32_device

_U32 = jnp.uint32
_I32 = jnp.int32
_U8 = jnp.uint8

DEFAULT_WINDOW = 256


def _member_header_template(mode: str, level: int) -> np.ndarray:
    """Constant member header bytes (size field zeroed) for mgzip/bgzf.

    Byte layouts per reference src/mgzip.rs:244-278 and src/bgzf.rs:272-303.
    """
    if level >= 9:
        xfl = 2
    elif level <= 1:
        xfl = 4
    else:
        xfl = 0
    base = [31, 139, 8, 4, 0, 0, 0, 0, xfl, 255]
    if mode == "mgzip":
        hdr = base + [8, 0, ord("I"), ord("G"), 4, 0, 0, 0, 0, 0]  # XLEN=8, SID 'IG', SLEN=4, BLEN u32
        assert len(hdr) == MGZIP_HEADER_SIZE
    elif mode == "bgzf":
        hdr = base + [6, 0, ord("B"), ord("C"), 2, 0, 0, 0]  # XLEN=6, SID 'BC', SLEN=2, BSIZE u16
        assert len(hdr) == BGZF_HEADER_SIZE
    else:
        raise ValueError(mode)
    return np.array(hdr, dtype=np.uint8)


@dataclass(frozen=True)
class DeflateEncodeConfig:
    block_len: int  # N: padded block size (static)
    mode: str  # 'stream' | 'mgzip' | 'bgzf'
    checksum: str  # 'crc32' | 'adler32' | 'none'  (per-block stream checksum)
    level: int = 6
    window: int = DEFAULT_WINDOW
    max_words: int = 8  # legacy knob (unused by the v2 matcher)
    lazy: bool = True  # zlib-style lazy matching
    dynamic: bool = True  # per-block dynamic Huffman (on-device)
    payload_words: int = 3  # suffix context carried through the sort
    lags: int = 2  # sorted-neighbor candidates examined
    # bit packer: 'sortscan' = scatter-free segmented-scan + placement
    # sort (default: dense per-block output, so the per-batch compaction
    # is a prefix slice); 'group8' = in-register 8-entry pre-merge +
    # 9-word-window scatter placement; 'v2' = one scatter-add pair per
    # entry
    pack: str = "sortscan"
    placement: str = "unroll"  # group8 window placement: 'unroll' | 'window'
    # RLE-compress the dynamic table description (CL syms 16/17/18 + a
    # real CL Huffman) instead of the constant 4-bit layout; saves
    # ~100-150 B/block (zlib parity). The fixed/dynamic decision still
    # uses the constant-layout cost (conservative: real headers are
    # smaller, so chosen-dynamic blocks only win more).
    rle_header: bool = True
    # add a 3-byte-hash candidate pass (pure 3-byte matches, zlib parity
    # at high levels; two extra sorts)
    hash3: bool = False
    # hash/sort every S-th position only (fast levels): both match-stage
    # sorts shrink by S; runs stay full-res and unsampled positions
    # inherit left-neighbor matches after extension (lz.best_matches).
    # Costs ~11% in size; an A/B knob, off at every level
    sample_step: int = 1
    # suffix matcher: number of context WORDS used as sort keys (0 = all
    # payload_words). A comparison sort's cost grows with its key count
    # while payload operands only ride along; with fewer keys,
    # key-equal buckets fall back to recency order and LCPs come from
    # min-composition of adjacent full-context LCPs (still genuine
    # matches, possibly shorter — lz.best_matches docstring)
    suffix_keys: int = 0
    # Huffman code fetch: 'f32' = byte-split one-hot f32 matmul; 'int8' =
    # nibble-split int8 matmul (a quarter of the one-hot operand bytes,
    # exact int32 accumulation)
    lookup: str = "f32"
    # candidate discovery: 'hash' sorts (hash4, pos) and probes the
    # ``lags`` nearest previous occurrences (recency order — zlib's
    # chain walk truncated at depth ``lags``); 'suffix' sorts by the
    # carried content bytes so neighbors come in MATCH-QUALITY order —
    # ±lags neighbors approximate an unbounded chain walk (levels >= 6)
    matcher: str = "hash"
    # deflate blocks per gzp block: S > 1 re-derives Huffman tables every
    # block_len/S bytes, zlib's behavior (zlib starts a new deflate block
    # every ~16K symbols, deflate.c lit_bufsize) — local tables recover
    # most of the high-level ratio gap at ~50 B/sub-block header cost.
    # Matches may CROSS sub-block boundaries (any distance < 32K is legal
    # regardless of deflate block framing) but may not START on the last
    # position before one (the distance half would land after the
    # inserted EOB+header), so those S-1 positions are forced literal.
    subblocks: int = 1
    # parse algorithm: 'scan' = windowless δ-state function composition
    # (default: better ratio than 'window', because matches keep their
    # full length instead of being clamped at window boundaries; capped
    # at 255 B/match); 'window' = the windowed reachability closure by
    # repeated matrix squaring, kept for A/B.
    parse: str = "scan"
    # halo bytes carried from the previous block (DICT_SIZE for the zlib
    # family in stream mode, reference src/par/compress.rs:417-423)
    dict_size: int = 0

    @classmethod
    def for_level(cls, block_len: int, mode: str, checksum: str, level: int,
                  dict_size: int = 0) -> "DeflateEncodeConfig":
        """Map a zlib-style compression level onto search-effort knobs
        (the reference's level maps to zlib-ng's chain-depth tiers):
        higher levels carry more context through the candidate sort,
        examine more sorted neighbors, and parse wider windows."""
        skw = 0
        if level <= 1:
            pw, lg, win, lazy, h3 = 2, 1, 256, False, False
        elif level <= 5:
            pw, lg, win, lazy, h3 = 3, 2, 256, True, False
        elif level <= 8:
            # hash3 stays off: measured net-negative on text (short
            # matches displace longer ones in the greedy parse).
            # suffix matcher, ±16 candidate neighbors: x1.0174 vs zlib-6
            # on the bench corpus (benches/ratio.py), against x1.0261
            # with lags=12; the extra neighbor probes are elementwise
            # compares, the sorts are unchanged
            pw, lg, win, lazy, h3 = 7, 16, 512, True, False
            # 5 key words (20-byte sort prefix): beats zlib-6 on the
            # bench corpus AND stays within 1% of the hash matcher on
            # repetitive micro-corpora (x1.009, the suffix-oracle rail;
            # 3 keys measured x1.089 there) with two of the seven sort
            # keys dropped
            skw = 5
        else:
            # ±24 suffix neighbors: x1.0208 vs zlib-9 (benches/ratio.py)
            pw, lg, win, lazy, h3 = 7, 24, 1024, True, False
            # 6 key words: x0.994 vs hash on the repetitive oracle
            # corpus (max-compression level keeps near-full key quality)
            skw = 6
        # levels >= 6 on big blocks: local Huffman tables every ~64 KiB.
        # Measured with benches/ratio.py: at 64 KiB blocks the
        # extra sub-block headers cost more than table locality gains on
        # homogeneous text (x1.0905 vs x1.0873 at level 6), so sub-block
        # tables only engage when blocks exceed 64 KiB.
        sub = 1
        if level >= 6:
            for cand in (4, 2):
                if block_len % cand == 0 and block_len // cand >= 65536:
                    sub = cand
                    break
        return cls(
            block_len=block_len, mode=mode, checksum=checksum, level=level,
            window=win, lazy=lazy, dynamic=True,
            payload_words=pw, lags=lg, dict_size=dict_size, hash3=h3,
            suffix_keys=skw,
            subblocks=sub, matcher="suffix" if level >= 6 else "hash",
        )

    @property
    def header_len(self) -> int:
        return {"stream": 0, "mgzip": MGZIP_HEADER_SIZE, "bgzf": BGZF_HEADER_SIZE}[self.mode]

    @property
    def footer_len(self) -> int:
        return 0 if self.mode == "stream" else 8

    @property
    def out_words(self) -> int:
        # worst case: all-literal block at 9 bits/byte (the dynamic table
        # is only chosen when it beats fixed, so fixed bounds token bits)
        # + one dynamic header and EOB per sub-block + trailers
        max_bits = (
            8 * self.header_len
            + self.subblocks * (1344 + 9)
            + 9 * self.block_len
            + 7
            + 48
        )
        # slack covers the byte footer region and the grouped packer's
        # 9-word placement windows (trailing zero-entry groups)
        return (max_bits + 31) // 32 + 10

    @property
    def out_bytes(self) -> int:
        return 4 * self.out_words


def _ilog2(v: jax.Array) -> jax.Array:
    """floor(log2(v)) for v >= 1 (31 - clz)."""
    return 31 - jax.lax.clz(jnp.maximum(v, 1).astype(_I32))


def length_symbols(l: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """DEFLATE length code (sym, extra_bits, extra_value) for lengths in
    [3, 258], computed arithmetically (RFC 1951 §3.2.5's table is
    exponent-structured: eb = max(ilog2(l-3)-2, 0), sym = 257 + 4*eb +
    ((l-3)>>eb), except 258 -> 285/0) — no per-position table gathers."""
    v = jnp.maximum(l - 3, 0)
    eb = jnp.where(v < 8, 0, _ilog2(v) - 2)
    sym = 257 + (eb << 2) + (v >> eb)
    extra = v & ((1 << eb) - 1)
    is258 = l == 258
    sym = jnp.where(is258, 285, sym)
    eb = jnp.where(is258, 0, eb)
    extra = jnp.where(is258, 0, extra)
    return sym, eb, extra


def dist_symbols(d: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """DEFLATE distance code (sym, extra_bits, extra_value) for distances
    in [1, 32768]: eb = max(ilog2(d-1)-1, 0), sym = 2*eb + ((d-1)>>eb)."""
    u = jnp.maximum(d - 1, 0)
    eb = jnp.where(u < 4, 0, _ilog2(u) - 1)
    sym = (eb << 1) + (u >> eb)
    extra = u & ((1 << eb) - 1)
    return sym, eb, extra


def _onehot_lookup2(
    sym: jax.Array, codes: jax.Array, lens: jax.Array, width: int
) -> tuple[jax.Array, jax.Array]:
    """(codes[b, sym], lens[b, sym]) for per-position ``sym`` via a batched
    one-hot matmul, which stands in for a per-row table gather.

    At default precision an accelerator may run f32 matmuls with reduced
    input precision (TF32 keeps 10 significand bits, bf16 8), so table
    VALUES above 256 could round — Huffman codes reach 15 bits. The table
    is therefore split into byte halves (every operand value <= 255,
    exact in bf16 and TF32; the one-hot row has a single nonzero so the
    accumulation is a copy) and reassembled in integer space.
    """
    o = jax.nn.one_hot(sym, width, dtype=jnp.float32)
    tbl = jnp.stack(
        [
            (codes & 0xFF).astype(jnp.float32),
            (codes >> 8).astype(jnp.float32),
            lens.astype(jnp.float32),
        ],
        axis=-1,
    )
    r = jnp.einsum("bnk,bko->bno", o, tbl)
    code = r[..., 0].astype(_U32) | (r[..., 1].astype(_U32) << 8)
    return code, r[..., 2].astype(_I32)


def _onehot_lookup2_i8(
    sym: jax.Array, codes: jax.Array, lens: jax.Array, width: int
) -> tuple[jax.Array, jax.Array]:
    """Int8 variant of :func:`_onehot_lookup2`: the materialized
    [N, width] one-hot operand is a quarter of the f32 one's bytes. The
    table is NIBBLE-split (signed int8 holds <= 127, codes reach 15
    bits) and the dot accumulates exactly in int32."""
    o = jax.nn.one_hot(sym, width, dtype=jnp.int8)
    tbl = jnp.stack(
        [
            (codes & 0xF),
            ((codes >> 4) & 0xF),
            ((codes >> 8) & 0xF),
            ((codes >> 12) & 0xF),
            lens,
        ],
        axis=-1,
    ).astype(jnp.int8)
    r = jax.lax.dot_general(
        o, tbl,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )
    code = (
        r[..., 0].astype(_U32)
        | (r[..., 1].astype(_U32) << 4)
        | (r[..., 2].astype(_U32) << 8)
        | (r[..., 3].astype(_U32) << 12)
    )
    return code, r[..., 4]


def compute_symbols(data_ext, marked, l, dist):
    """Per-position DEFLATE symbols (arithmetic, no table gathers).

    Returns (sym, leb, lextra, dsym, deb, dextra, is_match): ``sym`` is
    the literal byte at literal token positions and the length symbol at
    match starts (exactly the lit/len alphabet the histogram needs).
    """
    is_match = jnp.logical_and(marked, l > 0)
    lit_byte = data_ext.astype(_I32)
    lsym, leb, lextra = length_symbols(l)
    sym = jnp.where(is_match, lsym, lit_byte)
    leb = jnp.where(is_match, leb, 0)
    lextra = jnp.where(is_match, lextra, 0)
    dsym, deb, dextra = dist_symbols(dist)
    return sym, leb, lextra, dsym, deb, dextra, is_match


def emit_token_entries(
    marked, prev_match, sym, leb, lextra, dsym_s, deb_s, dextra_s,
    lit_codes, lit_lens, dist_codes, dist_lens, lookup: str = "f32",
) -> tuple[jax.Array, jax.Array]:
    """Per-position bit entries (one <=31-bit entry per position + EOB).

    Position ``i`` emits its token's literal-or-length half; a match's
    distance half arrives PRE-STASHED at position ``i+1`` (``prev_match``
    / ``dsym_s`` / ``deb_s`` / ``dextra_s`` are the caller's shift of the
    match-side fields — done at full-block scope so sub-block row splits
    can't lose a boundary-crossing stash). ``i+1`` is always covered
    since matches are >= 3 long, so the stream is ONE entry per position.
    Returns (bits, nbits) of shape ``[R, M+1]`` (last column =
    end-of-block symbol).
    """
    fetch = _onehot_lookup2_i8 if lookup == "int8" else _onehot_lookup2
    code, nb = fetch(sym, lit_codes, lit_lens, huffman.NLIT)
    even_bits = code | (lextra.astype(_U32) << nb.astype(_U32))
    even_n = jnp.where(marked, nb + leb, 0)

    dcode, dnb = fetch(dsym_s, dist_codes, dist_lens, huffman.NDIST)
    odd_bits = dcode | (dextra_s.astype(_U32) << dnb.astype(_U32))
    odd_n = dnb + deb_s

    bits = jnp.where(marked, even_bits, jnp.where(prev_match, odd_bits, 0))
    nbits = jnp.where(marked, even_n, jnp.where(prev_match, odd_n, 0))

    # end-of-block symbol as the final column
    eob_bits = lit_codes[:, 256:257].astype(_U32)
    eob_n = lit_lens[:, 256:257]
    bits = jnp.concatenate([bits, eob_bits], axis=1)
    nbits = jnp.concatenate([nbits, eob_n], axis=1)
    return bits, nbits


def emit_entries(
    marked, is_match, sym, leb, lextra, dsym, deb, dextra,
    lit_codes, lit_lens, dist_codes, dist_lens,
) -> tuple[jax.Array, jax.Array]:
    """Single-table variant of :func:`emit_token_entries`: stashes the
    distance fields at ``i+1`` itself (kept for the v2 pack path and the
    stage profilers)."""
    b = marked.shape[0]

    def stash(x, fill=0):
        return jnp.concatenate([jnp.full((b, 1), fill, x.dtype), x[:, :-1]], axis=1)

    return emit_token_entries(
        marked, stash(is_match, False), sym, leb, lextra,
        stash(dsym), stash(deb), stash(dextra),
        lit_codes, lit_lens, dist_codes, dist_lens,
    )


def _scatter_bits(words, rows, off, value_u32, max_sig_bits: int):
    """OR a <=32-bit value at absolute bit offset ``off`` into the word
    buffer via two scatter-adds (contributions have disjoint bits)."""
    w = off >> 5
    s = (off & 31).astype(_U32)
    c0 = value_u32 << s
    c1 = (value_u32 >> (jnp.uint32(31) - s)) >> jnp.uint32(1)
    words = words.at[rows, w].add(c0)
    words = words.at[rows, w + 1].add(c1)
    return words


def _shl_carry(lo_words: list[jax.Array], sm: jax.Array) -> list[jax.Array]:
    """Shift a little-endian u32-lane value left by ``sm`` in [0, 31]:
    returns len+1 lanes. (The >>(31-sm)>>1 split keeps shifts < 32.)"""
    sm = sm.astype(_U32)
    out = []
    prev = None
    for w in lo_words:
        carry = jnp.uint32(0) if prev is None else (prev >> (jnp.uint32(31) - sm)) >> jnp.uint32(1)
        out.append((w << sm) | carry)
        prev = w
    out.append((prev >> (jnp.uint32(31) - sm)) >> jnp.uint32(1))
    return out


def _merge_pair(a_words, a_n, b_words, b_n, k_opts: int):
    """OR bit-string B (``b_words`` lanes, ``b_n`` bits) after bit-string A
    (``a_words`` lanes, ``a_n`` bits <= 32*len(a_words)); returns
    (words, n) with len(a_words)+len(b_words) lanes. ``k_opts`` = number
    of possible word offsets for B's start (= len(a_words) + 1 options
    bounded by a_n's range)."""
    wa, wb = len(a_words), len(b_words)
    sm = (a_n & 31).astype(_U32)
    k = (a_n >> 5).astype(_I32)
    u = _shl_carry(b_words, sm)  # wb + 1 lanes
    out = []
    for j in range(wa + wb):
        acc = a_words[j] if j < wa else jnp.zeros_like(a_words[0])
        for kk in range(min(k_opts, j + 1)):
            t = j - kk
            if t < len(u):
                acc = acc | jnp.where(k == kk, u[t], jnp.uint32(0))
        out.append(acc)
    return out, a_n + b_n


def pack_entries_grouped(
    bits: jax.Array,
    nbits: jax.Array,
    base_bits: int,
    out_words: int,
    placement: str = "unroll",
) -> tuple[jax.Array, jax.Array]:
    """Assemble the bit stream from per-entry (value, width) pairs.

    Instead of one scatter-add per entry (the 'v2' packer), entries are
    pre-merged in-register into groups of 8 via three rounds of pairwise
    shift-OR on u32 lanes; only the resulting 9-word windows are
    scattered — 8x fewer scatter indices.

    Args:
      bits:  [B, E] uint32, entry values (< 2**31, i.e. <= 31 bits each)
      nbits: [B, E] int32, entry widths in [0, 31]
      base_bits: static bit offset of entry 0 (the byte header)
      out_words: width of the output u32 buffer
      placement: 'unroll' (9 per-column scatter-adds) or 'window'
        (one lax.scatter_add with a 9-word update window)

    Returns (words [B, out_words] uint32, total_bits [B] int32) where
    total_bits includes ``base_bits``.
    """
    b, e = bits.shape
    e8 = -(-e // 8) * 8
    if e8 != e:
        bits = jnp.concatenate([bits, jnp.zeros((b, e8 - e), _U32)], axis=1)
        nbits = jnp.concatenate([nbits, jnp.zeros((b, e8 - e), _I32)], axis=1)

    # round 1: pairs (<= 62 bits, 2 lanes)
    v0, v1 = bits[:, 0::2], bits[:, 1::2]
    n0, n1 = nbits[:, 0::2], nbits[:, 1::2]
    sm = n0.astype(_U32)
    lo = v0 | (v1 << sm)
    hi = (v1 >> (jnp.uint32(31) - sm)) >> jnp.uint32(1)
    w2, n2 = [lo, hi], n0 + n1

    # round 2: quads (<= 124 bits, 4 lanes)
    a = [w[:, 0::2] for w in w2]
    bb = [w[:, 1::2] for w in w2]
    w4, n4 = _merge_pair(a, n2[:, 0::2], bb, n2[:, 1::2], k_opts=2)

    # round 3: octs (<= 248 bits, 8 lanes)
    a = [w[:, 0::2] for w in w4]
    bb = [w[:, 1::2] for w in w4]
    w8, n8 = _merge_pair(a, n4[:, 0::2], bb, n4[:, 1::2], k_opts=4)

    # absolute group offsets and phase shift into 9-word windows
    csum = jnp.cumsum(n8, axis=1)
    goff = base_bits + csum - n8
    total_bits = base_bits + csum[:, -1]
    win = _shl_carry(w8, (goff & 31).astype(_U32))  # 9 lanes
    gw = goff >> 5

    words = jnp.zeros((b, out_words), _U32)
    if placement == "unroll":
        rows = jnp.arange(b, dtype=_I32)[:, None]
        for c in range(9):
            words = words.at[rows, gw + c].add(win[c], mode="drop")
    elif placement == "window":
        g = w8[0].shape[1]
        dn = jax.lax.ScatterDimensionNumbers(
            update_window_dims=(2,),
            inserted_window_dims=(0,),
            scatter_dims_to_operand_dims=(0, 1),
        )
        rows = jnp.broadcast_to(jnp.arange(b, dtype=_I32)[:, None], (b, g))
        idx = jnp.stack([rows, gw], axis=-1)
        upd = jnp.stack(win, axis=-1)  # [B, G, 9]
        words = jax.lax.scatter_add(
            words, idx, upd, dn, indices_are_sorted=True, unique_indices=False,
            mode=jax.lax.GatherScatterMode.CLIP,
        )
    else:
        raise ValueError(placement)
    return words, total_bits


def pack_entries_sortscan(
    bits: jax.Array,
    nbits: jax.Array,
    base_bits: int,
    out_words: int,
) -> tuple[jax.Array, jax.Array]:
    """Scatter-free bit packing: segmented OR-scan + one placement sort.

    The default packer. It has **zero scatters and zero gathers**, so
    its cost does not depend on how the target backend executes
    data-dependent memory accesses:

    * A prefix sum of entry widths gives each entry's absolute bit
      position; ``cnt = bitpos & 31`` is the in-word phase and
      ``w = bitpos >> 5`` the target word — all known up front, so the
      CPU encoder's sequential bit-buffer state never materializes.
    * Every output word is *completed* by exactly one entry (the one
      whose bits cross the word's end — entries are <= 31 bits, so each
      entry crosses at most one boundary and words are never skipped).
      The word's value is the OR of its entries' phase-shifted low parts
      plus the previous word's spill; both arrive via ONE segmented
      OR-scan over entries (segments = words; the spill ``hi`` of a
      crossing entry is injected at the next segment's start).
    * Placement: sort (target word, value) per block — completing
      entries carry their word index, everything else 0xFFFFFFFF — and
      the sorted prefix IS the dense little-endian word stream.

    Same contract as :func:`pack_entries_grouped` (entries obey
    ``bits < 2**nbits``, widths in [0, 31]), but the returned buffer is
    dense — block ``i``'s stream occupies words ``[0, ceil(total/32))``
    with zero padding after, which also makes the downstream per-batch
    compaction a prefix slice instead of a second placement pass.
    """
    b, _ = bits.shape
    inf = jnp.uint32(0xFFFFFFFF)
    # append one zero-width entry: its segment-scan value is exactly the
    # final partial word (the tail), at bitpos == total_bits
    v = jnp.concatenate([bits, jnp.zeros((b, 1), _U32)], axis=1)
    nb = jnp.concatenate([nbits, jnp.zeros((b, 1), _I32)], axis=1)

    csum = jnp.cumsum(nb, axis=1)
    bitpos = base_bits + csum - nb  # [B, E+1]
    total_bits = base_bits + csum[:, -1]
    cnt = (bitpos & 31).astype(_U32)
    w = (bitpos >> 5).astype(_U32)
    lo = v << cnt
    hi = (v >> (jnp.uint32(31) - cnt)) >> jnp.uint32(1)
    endw = ((bitpos + nb) >> 5).astype(_U32)
    flush = endw > w  # this entry completes word w

    start = jnp.concatenate([jnp.ones((b, 1), jnp.bool_), flush[:, :-1]], axis=1)
    hi_prev = jnp.concatenate([jnp.zeros((b, 1), _U32), hi[:, :-1]], axis=1)
    c = lo | jnp.where(start, hi_prev, jnp.uint32(0))

    def seg_or(a, bb):
        v1, r1 = a
        v2, r2 = bb
        return jnp.where(r2, v2, v1 | v2), jnp.logical_or(r1, r2)

    cval, _ = jax.lax.associative_scan(seg_or, (c, start), axis=1)

    key = jnp.where(flush, w, inf)
    tail_valid = (total_bits & 31) > 0
    key = key.at[:, -1].set(jnp.where(tail_valid, w[:, -1], inf))

    payload = cval
    bw = base_bits // 32  # static header region: dummy zero words
    if bw:
        dk = jnp.broadcast_to(jnp.arange(bw, dtype=_U32)[None, :], (b, bw))
        key = jnp.concatenate([dk, key], axis=1)
        payload = jnp.concatenate([jnp.zeros((b, bw), _U32), payload], axis=1)
    k = key.shape[1]
    if k < out_words:
        pad = out_words - k
        key = jnp.concatenate([key, jnp.full((b, pad), inf, _U32)], axis=1)
        payload = jnp.concatenate([payload, jnp.zeros((b, pad), _U32)], axis=1)

    _, sorted_vals = jax.lax.sort((key, payload), dimension=1, num_keys=1)
    words = sorted_vals[:, :out_words]
    n_words = (total_bits + 31) >> 5
    keep = jnp.arange(out_words, dtype=_I32)[None, :] < n_words[:, None]
    return jnp.where(keep, words, jnp.uint32(0)), total_bits


def match_stage(
    cfg: DeflateEncodeConfig,
    data_u8: jax.Array,
    lengths: jax.Array,
    halo: jax.Array | None = None,
    dict_lens: jax.Array | None = None,
):
    """Stage 1 of the encoder: halo concat + LZ77 match finding.

    Returns ``(ext, match_len, match_dist)``; ``ext`` is the halo-extended
    byte view the later stages index into.
    """
    base = cfg.dict_size
    if base:
        assert halo is not None and dict_lens is not None
        ext = jnp.concatenate([halo, data_u8], axis=1)
        halo_start = (base - dict_lens).astype(_I32)
    else:
        ext = data_u8
        halo_start = None
    match_len, match_dist = lz.best_matches(
        ext,
        lengths,
        max_dist=MAX_DIST,
        max_match=MAX_MATCH,
        min_emit=MIN_MATCH,
        base=base,
        halo_start=halo_start,
        lazy=cfg.lazy,
        payload_words=cfg.payload_words,
        lags=cfg.lags,
        hash3=cfg.hash3,
        suffix=cfg.matcher == "suffix",
        sample_step=cfg.sample_step,
        suffix_keys=cfg.suffix_keys,
    )
    return ext, match_len, match_dist


def parse_stage(cfg: DeflateEncodeConfig, match_len: jax.Array, lengths: jax.Array):
    """Stage 2: greedy parse of the match field into token starts."""
    if cfg.subblocks > 1:
        # a match may not START on the last position before a sub-block
        # boundary: its distance half (stashed at i+1) would land after
        # the next sub-block's EOB+header in the entry stream
        ns = cfg.block_len // cfg.subblocks
        idx = np.array(
            [cfg.dict_size + (s + 1) * ns - 1 for s in range(cfg.subblocks - 1)]
        )
        match_len = match_len.at[:, idx].set(0)
    if cfg.parse == "scan":
        return lz.parse_marks_scan(
            match_len, lengths, min_emit=MIN_MATCH, base=cfg.dict_size,
        )
    return lz.parse_marks(
        match_len, lengths, window=cfg.window, min_emit=MIN_MATCH,
        base=cfg.dict_size,
    )


def encode_deflate_blocks(
    cfg: DeflateEncodeConfig,
    data_u8: jax.Array,
    lengths: jax.Array,
    is_final: jax.Array,
    halo: jax.Array | None = None,
    dict_lens: jax.Array | None = None,
):
    """Compress a batch of blocks. Returns dict with:

    * ``out``:   [B, cfg.out_bytes] uint8 — framed output (header+payload+footer
      for members; bare deflate chunk for stream mode)
    * ``out_len``: [B] int32 — valid bytes of ``out``
    * ``check``: [B] uint32 — per-block crc32/adler32 of the (padded) input,
      or zeros when cfg.checksum == 'none'

    With ``cfg.dict_size > 0``, ``halo`` is ``[B, dict_size]`` uint8 holding
    each block's preset dictionary right-aligned (the previous block's
    trailing bytes) and ``dict_lens`` the valid halo byte counts; emitted
    match distances may reach into the halo — the 32 KiB cross-block
    dictionary carry (reference src/par/compress.rs:417-423).
    """
    # the scope names label the stages' device ops in profiler traces
    with jax.named_scope("match"):
        ext, match_len, match_dist = match_stage(cfg, data_u8, lengths, halo, dict_lens)
    with jax.named_scope("parse"):
        marked, l = parse_stage(cfg, match_len, lengths)
    with jax.named_scope("emit"):
        return emit_stage(cfg, data_u8, ext, lengths, is_final, marked, l, match_dist)


def emit_stage(
    cfg: DeflateEncodeConfig,
    data_u8: jax.Array,
    ext: jax.Array,
    lengths: jax.Array,
    is_final: jax.Array,
    marked: jax.Array,
    l: jax.Array,
    match_dist: jax.Array,
):
    """Stage 3: symbols, Huffman tables, entry emission, bit packing and
    member framing — everything downstream of the parse.

    With ``cfg.subblocks = S > 1`` every gzp block is emitted as S
    deflate blocks with their own dynamic Huffman tables (zlib re-derives
    tables every ~16K symbols; one table per 128 KiB costs several
    percent at high levels). Match finding and parsing stay full-block:
    matches freely cross sub-block boundaries — only their distance
    halves must not straddle the EOB+header insertion point, which
    :func:`parse_stage` guarantees by forbidding match starts on the
    last position before each boundary.
    """
    b, n = data_u8.shape
    assert n == cfg.block_len
    rows = jnp.arange(b, dtype=_I32)[:, None]

    sym, leb, lextra, dsym, deb, dextra, is_match = compute_symbols(
        ext, marked, l, match_dist
    )
    ntok = jnp.sum(marked.astype(_I32), axis=1)

    member = cfg.mode != "stream"
    final = jnp.ones((b,), jnp.bool_) if member else is_final

    # stash each match's distance half at i+1 at FULL-block scope (the
    # shift must see across sub-block boundaries), then split rows into
    # S sub-blocks; the halo region is sliced off (its entries were all
    # zero-width anyway)
    s_count = cfg.subblocks
    base = cfg.dict_size
    ns = n // s_count

    def _stash(x, fill=0):
        return jnp.concatenate(
            [jnp.full((b, 1), fill, x.dtype), x[:, :-1]], axis=1
        )

    prev_match = _stash(is_match, False)
    dsym_s, deb_s, dextra_s = _stash(dsym), _stash(deb), _stash(dextra)

    def _rows(x):
        return x[:, base:].reshape(b * s_count, ns)

    marked_r = _rows(marked)
    prev_match_r = _rows(prev_match)
    sym_r, leb_r, lextra_r = _rows(sym), _rows(leb), _rows(lextra)
    dsym_r, deb_r, dextra_r = _rows(dsym_s), _rows(deb_s), _rows(dextra_s)
    final_r = jnp.broadcast_to(
        final[:, None]
        & (jnp.arange(s_count, dtype=_I32) == s_count - 1)[None, :],
        (b, s_count),
    ).reshape(b * s_count)

    if cfg.dynamic:
        lit_freq, dist_freq = huffman.position_histograms(
            sym_r, dsym_r, marked_r, prev_match_r
        )
        (
            lit_codes,
            lit_lens,
            dist_codes,
            dist_lens,
            use_dyn,
            dlit_lens,
            ddist_lens,
        ) = huffman.choose_tables(lit_freq, dist_freq)
        header_fields = (
            huffman.dynamic_header_fields_rle
            if cfg.rle_header
            else huffman.dynamic_header_fields
        )
        hfield_bits, hfield_n = header_fields(dlit_lens, ddist_lens, final_r, use_dyn)
    else:
        lit_codes, lit_lens, dist_codes, dist_lens = huffman.fixed_table_arrays(
            b * s_count
        )
        lit_codes = lit_codes.astype(_U32)
        dist_codes = dist_codes.astype(_U32)
        hfield_bits = (jnp.uint32(2) | final_r.astype(_U32))[:, None]
        hfield_n = jnp.full((b * s_count, 1), 3, _I32)

    bits, nbits = emit_token_entries(
        marked_r, prev_match_r, sym_r, leb_r, lextra_r, dsym_r, deb_r, dextra_r,
        lit_codes, lit_lens, dist_codes, dist_lens, lookup=cfg.lookup,
    )

    hdr_bits = 8 * cfg.header_len

    if cfg.pack in ("group8", "sortscan"):
        # per sub-block: [deflate hdr (+dyn tables)][tokens][EOB], then
        # sub-blocks concatenate in order within each gzp block
        # (entries obey: bits < 2**nbits)
        sub_bits = jnp.concatenate([hfield_bits.astype(_U32), bits.astype(_U32)], axis=1)
        sub_n = jnp.concatenate([hfield_n, nbits], axis=1)
        all_bits = sub_bits.reshape(b, -1)
        all_n = sub_n.reshape(b, -1)
        with jax.named_scope("pack"):
            if cfg.pack == "sortscan":
                words, total_bits = pack_entries_sortscan(
                    all_bits, all_n, hdr_bits, cfg.out_words
                )
            else:
                words, total_bits = pack_entries_grouped(
                    all_bits, all_n, hdr_bits, cfg.out_words, placement=cfg.placement
                )
    else:
        assert s_count == 1, "pack='v2' supports subblocks=1 only"
        # bit offsets: [member header][deflate block header (+dyn tables)][tokens]
        hcsum = jnp.cumsum(hfield_n, axis=1)
        hoff = hdr_bits + (hcsum - hfield_n)
        deflate_hdr_bits = hdr_bits + hcsum[:, -1]  # [B]

        csum = jnp.cumsum(nbits, axis=1)
        off = deflate_hdr_bits[:, None] + (csum - nbits)
        total_bits = deflate_hdr_bits + csum[:, -1]  # end of EOB

        words = jnp.zeros((b, cfg.out_words), dtype=_U32)
        words = _scatter_bits(words, rows, hoff, hfield_bits.astype(_U32), 5)
        words = _scatter_bits(words, rows, off, bits.astype(_U32), 31)

    if member:
        end_bits = (total_bits + 7) & ~7
    else:
        # Z_SYNC_FLUSH trailer for non-final chunks: empty stored block
        # '000' + pad-to-byte + LEN=0x0000 NLEN=0xFFFF (all-zero bits except
        # the NLEN half, scattered as one aligned 32-bit value).
        o2 = (total_bits + 3 + 7) & ~7
        words = _scatter_bits(
            words,
            rows,
            jnp.where(final, 0, o2)[:, None],
            jnp.where(final, 0, jnp.uint32(0xFFFF0000))[:, None],
            32,
        )
        end_bits = jnp.where(final, (total_bits + 7) & ~7, o2 + 32)

    # words -> little-endian bytes
    by = jnp.stack(
        [
            (words & 0xFF),
            (words >> 8) & 0xFF,
            (words >> 16) & 0xFF,
            (words >> 24) & 0xFF,
        ],
        axis=-1,
    ).reshape(b, cfg.out_bytes).astype(_U8)

    deflate_bytes = (end_bits >> 3) - cfg.header_len

    with jax.named_scope("checksum"):
        if cfg.checksum == "crc32":
            chk = crc32_device(data_u8, lengths)
        elif cfg.checksum == "adler32":
            chk = adler32_device(data_u8, lengths)
        else:
            chk = jnp.zeros((b,), _U32)
        if member and cfg.checksum != "crc32":
            chk = crc32_device(data_u8, lengths)

    if member:
        tmpl = _member_header_template(cfg.mode, cfg.level)
        by = by.at[:, : cfg.header_len].set(jnp.asarray(tmpl)[None, :])
        if cfg.mode == "mgzip":
            blen = (deflate_bytes + MGZIP_HEADER_SIZE + 8).astype(_U32)
            size_bytes = jnp.stack(
                [blen & 0xFF, (blen >> 8) & 0xFF, (blen >> 16) & 0xFF, (blen >> 24) & 0xFF],
                axis=-1,
            ).astype(_U8)
            by = by.at[:, 16:20].set(size_bytes)
        else:  # bgzf: BSIZE u16 = total member size - 1
            bsize = (deflate_bytes + BGZF_HEADER_SIZE + 8 - 1).astype(_U32)
            size_bytes = jnp.stack([bsize & 0xFF, (bsize >> 8) & 0xFF], axis=-1).astype(_U8)
            by = by.at[:, 16:18].set(size_bytes)

        # footer: crc32 (of the uncompressed block) + ISIZE, little-endian
        isize = lengths.astype(_U32)
        foot = jnp.stack(
            [
                chk & 0xFF, (chk >> 8) & 0xFF, (chk >> 16) & 0xFF, (chk >> 24) & 0xFF,
                isize & 0xFF, (isize >> 8) & 0xFF, (isize >> 16) & 0xFF, (isize >> 24) & 0xFF,
            ],
            axis=-1,
        ).astype(_U8)
        foot_pos = (cfg.header_len + deflate_bytes)[:, None] + jnp.arange(8, dtype=_I32)[None, :]
        by = by.at[rows, foot_pos].set(foot)
        out_len = cfg.header_len + deflate_bytes + 8
    else:
        out_len = deflate_bytes

    return {"out": by, "out_len": out_len.astype(_I32), "check": chk, "ntok": ntok}


def compact_outputs(
    out: jax.Array, out_len: jax.Array, placement: str = "sort"
) -> jax.Array:
    """Pack per-block framed outputs end-to-end into one flat buffer.

    ``out`` is ``[B, M]`` uint8 with ``out_len[i]`` valid bytes per row;
    returns ``flat`` ``[B*M]`` uint8 where block ``i``'s bytes occupy
    ``[sum(out_len[:i]), sum(out_len[:i+1]))``. Keeps the host from
    pulling the padded ``[B, M]`` buffer over PCIe: the caller fetches
    ``flat[:sum(out_len)]`` only.

    Word-level: each row is masked past ``out_len``, byte-rotated by its
    destination's word phase (elementwise, select over 4 shifts), and
    placed as u32 words. ``placement='scatter'`` does one scatter-add
    over all row words; ``placement='sort'`` (default) sorts (global word index,
    word) pairs instead — the sorted prefix is the flat stream — and
    scatter-adds only the B first-words that share a boundary word with
    the previous row (bit-disjoint by construction).
    """
    b, m = out.shape
    assert m % 4 == 0
    mw = m // 4
    starts = jnp.cumsum(out_len) - out_len  # exclusive prefix [B]

    # zero the padded tail, then view rows as little-endian u32 words
    valid = jnp.arange(m, dtype=_I32)[None, :] < out_len[:, None]
    ob = jnp.where(valid, out, 0).astype(_U32).reshape(b, mw, 4)
    w = ob[..., 0] | (ob[..., 1] << 8) | (ob[..., 2] << 16) | (ob[..., 3] << 24)

    # shift each row left by its start's byte phase (0..3): one extra
    # carry word catches the spill
    sh = (starts & 3).astype(_U32)[:, None] * 8
    wz = jnp.concatenate([jnp.zeros((b, 1), _U32), w], axis=1)  # [B, MW+1]
    shifted = jnp.where(
        sh > 0,
        (wz[:, 1:] << sh) | (wz[:, :-1] >> (jnp.uint32(32) - jnp.maximum(sh, 1))),
        wz[:, 1:],
    )
    carry = jnp.where(
        sh > 0, w[:, -1:] >> (jnp.uint32(32) - jnp.maximum(sh, 1)), jnp.uint32(0)
    )
    roww = jnp.concatenate([shifted, carry], axis=1)  # [B, MW+1]

    nw = mw * b
    wstart = (starts >> 2)[:, None]
    widx = wstart + jnp.arange(mw + 1, dtype=_I32)[None, :]
    # an empty row must claim ZERO words (the +3 rounding would claim
    # one): harmless under scatter-add, a duplicate-key corruption under
    # sort placement
    row_words = jnp.where(
        out_len > 0, ((starts & 3) + out_len + 3) >> 2, 0
    )[:, None]
    in_row = jnp.arange(mw + 1, dtype=_I32)[None, :] < row_words

    if placement == "scatter":
        widx = jnp.where(in_row, widx, nw)
        flatw = jnp.zeros((nw,), _U32)
        flatw = flatw.at[widx.reshape(-1)].add(roww.reshape(-1), mode="drop")
    else:
        # a row whose start has a byte phase shares its FIRST word with
        # the previous row's last; keep exactly one owner per global
        # word in the sort and add the shared first-words afterwards
        # (disjoint byte lanes, <= B scattered elements)
        shared_first = ((starts & 3) > 0) & (out_len > 0)  # [B]
        col0 = jnp.arange(mw + 1, dtype=_I32)[None, :] == 0
        owned = in_row & ~(col0 & shared_first[:, None])
        key = jnp.where(owned, widx.astype(_U32), jnp.uint32(0xFFFFFFFF))
        _, sorted_w = jax.lax.sort(
            (key.reshape(-1), roww.reshape(-1)), dimension=0, num_keys=1
        )
        flatw = sorted_w[:nw]
        total_words = (jnp.sum(out_len) + 3) >> 2
        flatw = jnp.where(
            jnp.arange(nw, dtype=_I32) < total_words, flatw, jnp.uint32(0)
        )
        fidx = jnp.where(shared_first, starts >> 2, nw)
        flatw = flatw.at[fidx].add(
            jnp.where(shared_first, roww[:, 0], jnp.uint32(0)), mode="drop"
        )

    return jnp.stack(
        [flatw & 0xFF, (flatw >> 8) & 0xFF, (flatw >> 16) & 0xFF, (flatw >> 24) & 0xFF],
        axis=-1,
    ).reshape(b * m).astype(_U8)


@functools.lru_cache(maxsize=32)
def get_encoder(cfg: DeflateEncodeConfig, compact: bool = False):
    """Jitted batched encoder for a static config.

    With ``compact=True`` the result also carries ``flat`` (see
    :func:`compact_outputs`) so the host can fetch exactly
    ``sum(out_len)`` bytes instead of the padded ``[B, out_bytes]``.
    """

    def encode(data_u8, lengths, is_final, halo=None, dict_lens=None):
        res = encode_deflate_blocks(cfg, data_u8, lengths, is_final, halo, dict_lens)
        if compact:
            with jax.named_scope("compact"):
                res["flat"] = compact_outputs(res["out"], res["out_len"])
        return res

    if cfg.dict_size:

        @jax.jit
        def run(data_u8, lengths, is_final, halo, dict_lens):
            return encode(data_u8, lengths, is_final, halo, dict_lens)

    else:

        @jax.jit
        def run(data_u8, lengths, is_final):
            return encode(data_u8, lengths, is_final)

    return run
