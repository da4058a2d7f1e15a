"""On-device per-block dynamic Huffman construction (RFC 1951 §3.2.7).

This replaces the host-side tree building inside zlib/libdeflate with a
fully vectorized, batched construction — no host round trip:

1. **Code lengths**: ``l = min{ l : f * 2^l >= total }`` (the integer form
   of ``ceil(-log2 p)``), clamped to [1, 15]. Un-clamped, this satisfies
   Kraft automatically; a bounded fixup loop then makes the code exactly
   complete (incrementing the biggest-weight symbols while oversubscribed,
   then spending the remaining Kraft budget largest-power-first), because
   zlib's inflate rejects incomplete literal/length codes.
2. **Canonical codes**: per-length counts -> next_code prefix (15 unrolled
   steps), per-symbol rank via a masked cumulative sum, bit-reversed for
   the LSB-first stream.
3. **Header**: a *constant-layout* dynamic header — HLIT=286, HDIST=30,
   HCLEN=15, and all 16 length-value CL symbols assigned 4-bit codes
   (Kraft-exact: 16 * 2^-4 = 1), so every block's table description is
   exactly 3+5+5+4+57+316*4 = 1338 bits with static field offsets. Costs
   ~60 bytes/block vs zlib's RLE-compressed headers but keeps the whole
   thing a fixed-shape vector program; per-block fixed-vs-dynamic
   selection makes it a strict win over fixed Huffman.

The emitter chooses per block between these dynamic tables and the fixed
tables (exactly zlib's per-block static/dynamic decision, minus the
stored case which the host pipeline handles).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gzp_tpu.ops import tables

_U32 = jnp.uint32
_I32 = jnp.int32

NLIT = 286
NDIST = 30
HEADER_BITS = 3 + 5 + 5 + 4 + 19 * 3 + (NLIT + NDIST) * 4  # = 1338
KRAFT_ONE = 1 << 15  # Kraft budget in 2^-15 units
_FIXUP_ITERS = 48

# CL symbols in the header's permuted order (RFC 1951 §3.2.7)
CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)


def position_histograms(
    sym: jax.Array,
    dsym: jax.Array,
    is_tok: jax.Array,
    is_match: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Per-block symbol frequencies from per-position symbol arrays:
    (lit_freq [B,286], dist_freq [B,30]), including the end-of-block
    symbol (freq 1), as one-hot sums in place of scatter-adds."""
    o = jax.nn.one_hot(sym, NLIT, dtype=jnp.float32)
    lit_freq = jnp.sum(
        o * is_tok[:, :, None].astype(jnp.float32), axis=1
    ).astype(_I32)
    lit_freq = lit_freq.at[:, 256].add(1)  # EOB

    od = jax.nn.one_hot(dsym, NDIST, dtype=jnp.float32)
    dist_freq = jnp.sum(
        od * is_match[:, :, None].astype(jnp.float32), axis=1
    ).astype(_I32)
    return lit_freq, dist_freq


_INF = 1 << 26  # weight padding (package sums stay below this; keys fit i32)


def code_lengths(freq: jax.Array, max_len: int = 15) -> tuple[jax.Array, jax.Array]:
    """Optimal length-limited code lengths via vectorized package-merge.

    Batched over blocks; per table: ``max_len`` bottom-up rounds of
    (pairwise package + merge-by-sort), then a top-down active-set count.
    The key structural fact making this vectorizable: within every
    level's merged list the *singles* appear in global weight order, so
    the chosen singles at level k are exactly the ``n_k`` lightest
    symbols — a symbol's code length is just the number of levels whose
    ``n_k`` exceeds its weight rank (Larmore-Hirschberg package-merge in
    its counting form).

    Returns (lens [B,S] int32, ok [B] bool — False for the degenerate
    <2-used-symbols cases the caller special-cases).
    """
    b, s = freq.shape
    used = freq > 0
    nused = jnp.sum(used.astype(_I32), axis=1)

    # ascending weight order of used symbols (stable by symbol id)
    key = jnp.where(used, freq * 512 + jnp.arange(s, dtype=_I32)[None, :], _INF)
    order = jnp.argsort(key, axis=1)  # [B,S]: order[r] = symbol at rank r
    singles = jnp.sort(jnp.where(used, freq, _INF), axis=1)  # [B,S] padded

    m2 = 2 * s
    # bottom-up: list_1 = singles; list_k = merge(singles, packages(list_{k-1}))
    # Rolled into a lax.scan (round 1 unrolled 14 argsort rounds inline,
    # a major compile-time hog); stacked output = per-level cumulative
    # package counts in sorted order.
    vals0 = jnp.concatenate(
        [singles, jnp.full((b, s), _INF, singles.dtype)], axis=1
    )  # level-1 list padded to [B, 2S]
    merged_flags = jnp.concatenate(
        [jnp.zeros((b, s), _I32), jnp.ones((b, s), _I32)], axis=1
    )

    def level(vals, _):
        pairs = jnp.minimum(vals[:, 0::2] + vals[:, 1::2], _INF)  # [B, S]
        merged_vals = jnp.concatenate([singles, pairs], axis=1)
        # stable merge by (value, singles-first)
        mkey = merged_vals * 2 + merged_flags
        idx = jnp.argsort(mkey, axis=1)
        nvals = jnp.take_along_axis(merged_vals, idx, axis=1)
        flags = jnp.take_along_axis(merged_flags, idx, axis=1)
        # don't count INF pads as packages
        flags = jnp.where(nvals >= _INF, 0, flags)
        return nvals, jnp.cumsum(flags, axis=1)

    _, pkg_stack = jax.lax.scan(level, vals0, None, length=max_len - 1)
    # pkg_prefix per level k=0..max_len-1 (level 0 has no packages)
    pkg_all = jnp.concatenate(
        [jnp.zeros((1, b, m2), _I32), pkg_stack], axis=0
    )  # [L, B, 2S]

    # top-down active-set counting: m_L = 2n-2; m_{k-1} = 2 * (#packages
    # among the first m_k items of list_k); singles chosen n_k = m_k - p_k
    m0 = jnp.maximum(2 * nused - 2, 0)  # [B]

    def down(m, prefix):
        p = jnp.where(
            m > 0,
            jnp.take_along_axis(prefix, jnp.maximum(m - 1, 0)[:, None], axis=1)[:, 0],
            0,
        )
        return 2 * p, m - p

    _, n_ks = jax.lax.scan(down, m0, pkg_all, reverse=True)  # [L, B]

    # lens by rank: l_r = #{k : r < n_k}; scatter back through `order`
    ranks = jnp.arange(s, dtype=_I32)[None, :]
    l_by_rank = jnp.sum(
        (ranks[None, :, :] < n_ks[:, :, None]).astype(_I32), axis=0
    )
    rows = jnp.arange(b, dtype=_I32)[:, None]
    lens = jnp.zeros((b, s), _I32).at[rows, order].set(l_by_rank)
    lens = jnp.where(used, lens, 0)

    ok = nused >= 2
    return lens, ok


def canonical_codes(lens: jax.Array) -> jax.Array:
    """Per-symbol bit-reversed canonical codes from code lengths.

    lens: [B, S] int32 (0 = unused). Returns codes [B, S] uint32, already
    bit-reversed for LSB-first emission.
    """
    b, s = lens.shape
    onehot = (lens[:, :, None] == jnp.arange(16, dtype=_I32)[None, None, :]).astype(
        _I32
    )  # [B,S,16]
    cnt = jnp.sum(onehot, axis=1)  # [B,16] codes per length
    # next_code: code = (code + count[l-1]) << 1, unrolled over 15 lengths
    next_code = [jnp.zeros((b,), _U32)]
    code = jnp.zeros((b,), _U32)
    for l in range(1, 16):
        code = (code + cnt[:, l - 1].astype(_U32)) << 1
        next_code.append(code)
    next_code = jnp.stack(next_code, axis=1)  # [B,16]

    rank = jnp.cumsum(onehot, axis=1) - onehot  # exclusive, per length
    my_rank = jnp.take_along_axis(
        rank, jnp.clip(lens, 0, 15)[:, :, None], axis=2
    )[:, :, 0].astype(_U32)
    base = jnp.take_along_axis(next_code, jnp.clip(lens, 0, 15), axis=1)
    code = base + my_rank

    # bit-reverse within `lens` bits: reverse a u32 then shift down
    v = code
    v = ((v & 0x55555555) << 1) | ((v >> 1) & 0x55555555)
    v = ((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)
    v = ((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)
    v = ((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)
    v = (v << 16) | (v >> 16)
    shift = (32 - jnp.clip(lens, 1, 15)).astype(_U32)
    rev = jnp.where(lens > 0, v >> shift, 0)
    return rev


def _rev4(x: jax.Array) -> jax.Array:
    """Reverse 4 bits (CL codes: all 16 symbols at length 4, canonical
    code == symbol value)."""
    x = x.astype(_U32)
    return ((x & 1) << 3) | ((x & 2) << 1) | ((x & 4) >> 1) | ((x & 8) >> 3)


def dynamic_header_fields(
    lit_lens: jax.Array, dist_lens: jax.Array, final: jax.Array, use_dyn: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Per-block header as (bits [B, F], nbits [B, F]) virtual tokens.

    Dynamic blocks get the full constant-layout 1338-bit header; fixed
    blocks get just the 3-bit block header (nbits 0 elsewhere).
    """
    b = lit_lens.shape[0]
    f = 1 + 3 + 19 + NLIT + NDIST
    bits = []
    nbits = []

    hdr3_dyn = jnp.uint32(4) | final.astype(_U32)  # BFINAL | BTYPE=10
    hdr3_fix = jnp.uint32(2) | final.astype(_U32)  # BFINAL | BTYPE=01
    bits.append(jnp.where(use_dyn, hdr3_dyn, hdr3_fix))
    nbits.append(jnp.full((b,), 3, _I32))

    for val, width in ((NLIT - 257, 5), (NDIST - 1, 5), (19 - 4, 4)):
        bits.append(jnp.full((b,), val, _U32))
        nbits.append(jnp.full((b,), width, _I32))

    # 19 CL code lengths, 3 bits each, in permuted order: 4 for value
    # symbols 0..15, 0 for the unused 16/17/18
    for symv in CL_ORDER:
        v = 4 if symv <= 15 else 0
        bits.append(jnp.full((b,), v, _U32))
        nbits.append(jnp.full((b,), 3, _I32))

    # 286 + 30 code lengths, each emitted as the 4-bit CL code rev4(l)
    all_lens = jnp.concatenate([lit_lens, dist_lens], axis=1)  # [B, 316]
    lens_bits = _rev4(jnp.clip(all_lens, 0, 15))
    lens_n = jnp.full_like(all_lens, 4)

    head_bits = jnp.stack(bits, axis=1)
    head_n = jnp.stack(nbits, axis=1)
    bits_all = jnp.concatenate([head_bits, lens_bits.astype(_U32)], axis=1)
    n_all = jnp.concatenate([head_n, lens_n], axis=1)
    # mask the table description away for fixed blocks — both widths AND
    # values (the bit scatter ORs values regardless of declared width)
    keep_first = jnp.arange(bits_all.shape[1], dtype=_I32)[None, :] == 0
    keep = jnp.logical_or(use_dyn[:, None], keep_first)
    n_all = jnp.where(keep, n_all, 0)
    bits_all = jnp.where(keep, bits_all, 0)
    assert bits_all.shape[1] == f
    return bits_all, n_all


def _seg_runs(vals: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-position (offset-in-run, run-length) of maximal equal-value runs
    along axis 1, via cummax/cummin scans (no sequential loop)."""
    b, s = vals.shape
    idx = jnp.broadcast_to(jnp.arange(s, dtype=_I32)[None, :], (b, s))
    start = jnp.concatenate(
        [jnp.ones((b, 1), jnp.bool_), vals[:, 1:] != vals[:, :-1]], axis=1
    )
    rs = jax.lax.cummax(jnp.where(start, idx, 0), axis=1)
    nxt = jnp.concatenate(
        [jnp.where(start, idx, s)[:, 1:], jnp.full((b, 1), s, _I32)], axis=1
    )
    re = jax.lax.cummin(nxt[:, ::-1], axis=1)[:, ::-1]
    return idx - rs, re - rs


def rle_code_length_symbols(
    all_lens: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Per-position RLE encoding of the 316 code lengths (RFC 1951 §3.2.7
    CL symbols 16/17/18 — zlib's compressed table description, the ~60
    B/block the constant-layout header leaves on the table).

    Greedy chunking, fully per-position arithmetic: zero runs become
    138-bit-max sym-18 pieces (then one 17/18 for the 3..137 remainder,
    literal zeros below 3); a nonzero run emits its value once then 16
    pieces of 3..6 repeats. Returns (clsym [B,S] int32 with -1 where the
    position is covered by a piece, extra [B,S], extra_n [B,S], emitted
    [B,S] bool).
    """
    v = all_lens.astype(_I32)
    ii, ln = _seg_runs(v)
    is_zero = v == 0

    # --- zero runs: pieces anchored every 138 positions
    ps = ii - ii % 138
    rem = ln - ps
    size0 = jnp.where(rem >= 11, jnp.minimum(rem, 138), jnp.where(rem >= 3, rem, 0))
    start0 = jnp.logical_and(ii == ps, size0 > 0)
    tail0 = ii >= ps + size0  # beyond the piece (or size0 == 0): literal 0
    sym0 = jnp.where(size0 >= 11, 18, 17)
    extra0 = jnp.where(size0 >= 11, size0 - 11, size0 - 3)
    extran0 = jnp.where(size0 >= 11, 7, 3)

    # --- nonzero runs: literal at run start, then 16-pieces every 6
    jj = ii - 1
    cs = jj - jj % 6
    remn = (ln - 1) - cs
    size1 = jnp.where(remn >= 3, jnp.minimum(remn, 6), 0)
    start1 = jnp.logical_and(jnp.logical_and(ii > 0, jj == cs), size1 > 0)
    tail1 = jnp.logical_and(ii > 0, jj >= cs + size1)

    clsym = jnp.full_like(v, -1)
    extra = jnp.zeros_like(v)
    extran = jnp.zeros_like(v)

    # literals: run head of nonzero runs, and zero-run tail positions
    lit = jnp.where(is_zero, tail0, jnp.logical_or(ii == 0, tail1))
    clsym = jnp.where(lit, v, clsym)
    # pieces
    clsym = jnp.where(jnp.logical_and(is_zero, start0), sym0, clsym)
    extra = jnp.where(jnp.logical_and(is_zero, start0), extra0, extra)
    extran = jnp.where(jnp.logical_and(is_zero, start0), extran0, extran)
    clsym = jnp.where(jnp.logical_and(~is_zero, start1), 16, clsym)
    extra = jnp.where(jnp.logical_and(~is_zero, start1), size1 - 3, extra)
    extran = jnp.where(jnp.logical_and(~is_zero, start1), 2, extran)
    return clsym, extra, extran, clsym >= 0


def dynamic_header_fields_rle(
    lit_lens: jax.Array, dist_lens: jax.Array, final: jax.Array, use_dyn: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """RLE-compressed dynamic header as (bits, nbits) virtual tokens with
    the same [B, 1+3+19+316] layout as :func:`dynamic_header_fields` —
    covered positions are 0-width entries. Falls back per block to the
    constant 4-bit layout when the CL alphabet is degenerate (< 2 used
    symbols, whose 7-bit-capped Huffman code would be incomplete)."""
    b = lit_lens.shape[0]
    all_lens = jnp.concatenate([lit_lens, dist_lens], axis=1)  # [B, 316]
    clsym, extra, extran, emitted = rle_code_length_symbols(all_lens)

    # CL alphabet Huffman, max length 7 (fits HCLEN's 3-bit fields)
    o = jax.nn.one_hot(jnp.where(emitted, clsym, 0), 19, dtype=jnp.float32)
    cl_freq = jnp.sum(
        o * emitted[:, :, None].astype(jnp.float32), axis=1
    ).astype(_I32)
    cl_lens, cl_ok = code_lengths(cl_freq, max_len=7)
    cl_codes = canonical_codes(cl_lens)

    # per-position CL code lookup (one-hot matmul; values <= 127, exact
    # even when the matmul rounds its f32 inputs to bf16 or TF32)
    tbl = jnp.stack(
        [cl_codes.astype(jnp.float32), cl_lens.astype(jnp.float32)], axis=-1
    )
    r = jnp.einsum("bsk,bko->bso", o, tbl)
    pc = r[..., 0].astype(_U32)
    pn = r[..., 1].astype(_I32)

    rle_bits = jnp.where(emitted, pc | (extra.astype(_U32) << pn.astype(_U32)), 0)
    rle_n = jnp.where(emitted, pn + extran, 0)

    # constant-layout fallback (all 16 value symbols at 4 bits)
    const_bits = _rev4(jnp.clip(all_lens, 0, 15))
    const_n = jnp.full_like(all_lens, 4)

    use_rle = cl_ok[:, None]
    lens_bits = jnp.where(use_rle, rle_bits, const_bits.astype(_U32))
    lens_n = jnp.where(use_rle, rle_n, const_n)

    # 19 CL lens in permuted order, 3 bits each
    cl_field = jnp.where(
        use_rle,
        cl_lens[:, CL_ORDER],
        jnp.asarray([4 if s <= 15 else 0 for s in CL_ORDER], _I32)[None, :],
    ).astype(_U32)

    hdr3_dyn = jnp.uint32(4) | final.astype(_U32)
    hdr3_fix = jnp.uint32(2) | final.astype(_U32)
    head_bits = [jnp.where(use_dyn, hdr3_dyn, hdr3_fix)[:, None]]
    head_n = [jnp.full((b, 1), 3, _I32)]
    for val, width in ((NLIT - 257, 5), (NDIST - 1, 5), (19 - 4, 4)):
        head_bits.append(jnp.full((b, 1), val, _U32))
        head_n.append(jnp.full((b, 1), width, _I32))
    head_bits.append(cl_field)
    head_n.append(jnp.full((b, 19), 3, _I32))

    bits_all = jnp.concatenate(head_bits + [lens_bits], axis=1)
    n_all = jnp.concatenate(head_n + [lens_n], axis=1)
    keep_first = jnp.arange(bits_all.shape[1], dtype=_I32)[None, :] == 0
    keep = jnp.logical_or(use_dyn[:, None], keep_first)
    n_all = jnp.where(keep, n_all, 0)
    bits_all = jnp.where(keep, bits_all, 0)
    return bits_all, n_all


def fixed_table_arrays(b: int) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Fixed-Huffman tables broadcast to [B, S] for per-block selection."""
    fc, fn = tables.fixed_litlen_codes()
    dc, dn = tables.fixed_dist_codes()
    lit_c = jnp.broadcast_to(jnp.asarray(fc)[None, :NLIT], (b, NLIT))
    lit_n = jnp.broadcast_to(jnp.asarray(fn)[None, :NLIT], (b, NLIT))
    dist_c = jnp.broadcast_to(jnp.asarray(dc)[None, :], (b, NDIST))
    dist_n = jnp.broadcast_to(jnp.asarray(dn)[None, :], (b, NDIST))
    return lit_c, lit_n, dist_c, dist_n


def choose_tables(
    lit_freq: jax.Array,
    dist_freq: jax.Array,
):
    """Build dynamic tables and the per-block fixed/dynamic decision.

    Returns (lit_codes, lit_lens, dist_codes, dist_lens, use_dyn): table
    arrays already selected per block (fixed where dynamic loses or is
    invalid).
    """
    b = lit_freq.shape[0]
    dlit_lens, lit_ok = code_lengths(lit_freq)
    ddist_lens, dist_ok = code_lengths(dist_freq)

    # distance table edge: no distances at all -> single 1-bit code for
    # symbol 0 (the degenerate incomplete code zlib itself emits)
    no_dist = jnp.sum(dist_freq, axis=1) == 0
    ddist_lens = jnp.where(
        no_dist[:, None],
        jnp.zeros_like(ddist_lens).at[:, 0].set(1),
        ddist_lens,
    )
    dist_ok = jnp.logical_or(dist_ok, no_dist)
    # litlen needs >= 2 used symbols for a complete code (EOB guarantees 1)
    lit_ok = jnp.logical_and(lit_ok, jnp.sum((lit_freq > 0).astype(_I32), axis=1) >= 2)

    fix_lit_c, fix_lit_n, fix_dist_c, fix_dist_n = fixed_table_arrays(b)

    # bit-cost comparison (extra bits cancel):
    cost_dyn = HEADER_BITS + jnp.sum(lit_freq * dlit_lens, axis=1) + jnp.sum(
        dist_freq * ddist_lens, axis=1
    )
    cost_fix = 3 + jnp.sum(lit_freq * fix_lit_n, axis=1) + jnp.sum(
        dist_freq * fix_dist_n, axis=1
    )
    use_dyn = jnp.logical_and(
        jnp.logical_and(lit_ok, dist_ok), cost_dyn < cost_fix
    )

    dlit_codes = canonical_codes(dlit_lens)
    ddist_codes = canonical_codes(ddist_lens)

    lit_codes = jnp.where(use_dyn[:, None], dlit_codes, fix_lit_c.astype(_U32))
    lit_lens = jnp.where(use_dyn[:, None], dlit_lens, fix_lit_n)
    dist_codes = jnp.where(use_dyn[:, None], ddist_codes, fix_dist_c.astype(_U32))
    dist_lens = jnp.where(use_dyn[:, None], ddist_lens, fix_dist_n)
    return lit_codes, lit_lens, dist_codes, dist_lens, use_dyn, dlit_lens, ddist_lens
