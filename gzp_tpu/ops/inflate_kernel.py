"""Batched device inflate: data-parallel DEFLATE decode over independent blocks.

A device-side counterpart of the reference's libdeflate worker-pool
decode (reference src/par/decompress.rs:161-187): B compressed block
payloads (from Mgzip/BGZF members, ISIZE known -> static output shapes)
are decoded as lockstep lanes of one program.

Two phases (the classic parallel-decompression decomposition — see
PAPERS.md, Massively-Parallel Lossless Data Decompression):

* **Phase 1 — symbol decode.** A per-lane register machine steps through
  block headers and symbols in lockstep. Huffman decoding is canonical
  and *table-free*: with per-length counts and canonical first-codes,
  the code length of the next symbol is the first ``l`` whose MSB-aligned
  15-bit lookahead prefix falls inside ``[first_code[l],
  first_code[l]+count[l])`` (15 vectorized comparisons), and the symbol
  is one gather into the (length,symbol)-sorted list. Dynamic headers
  are parsed with the same machinery over the 19-symbol CL alphabet.
  Literals are written to their output positions; match starts record
  their distance.
* **Phase 2 — copy resolution.** Positions covered by matches map to
  ``pos - dist``; chasing to literal roots is pointer doubling (log2(N)
  gather rounds) + one final byte gather. Overlapping (RLE) copies
  resolve naturally because the map is per byte.

Phase 1 is a lockstep while-loop (one symbol per lane per iteration) —
latency-bound under plain XLA. Lanes hitting malformed
data set ``ok=False``; the host pipeline retries those blocks on the
native CPU path for precise errors.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_I32 = jnp.int32

_CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]

_LEN_BASE = np.zeros(288, np.int32)
_LEN_EXTRA = np.zeros(288, np.int32)
for _sym, _eb, _b in [
    (257, 0, 3), (258, 0, 4), (259, 0, 5), (260, 0, 6), (261, 0, 7),
    (262, 0, 8), (263, 0, 9), (264, 0, 10), (265, 1, 11), (266, 1, 13),
    (267, 1, 15), (268, 1, 17), (269, 2, 19), (270, 2, 23), (271, 2, 27),
    (272, 2, 31), (273, 3, 35), (274, 3, 43), (275, 3, 51), (276, 3, 59),
    (277, 4, 67), (278, 4, 83), (279, 4, 99), (280, 4, 115), (281, 5, 131),
    (282, 5, 163), (283, 5, 195), (284, 5, 227), (285, 0, 258),
]:
    _LEN_BASE[_sym] = _b
    _LEN_EXTRA[_sym] = _eb

_DIST_BASE = np.zeros(32, np.int32)
_DIST_EXTRA = np.zeros(32, np.int32)
for _sym, _eb, _b in [
    (0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 0, 4), (4, 1, 5), (5, 1, 7),
    (6, 2, 9), (7, 2, 13), (8, 3, 17), (9, 3, 25), (10, 4, 33), (11, 4, 49),
    (12, 5, 65), (13, 5, 97), (14, 6, 129), (15, 6, 193), (16, 7, 257),
    (17, 7, 385), (18, 8, 513), (19, 8, 769), (20, 9, 1025), (21, 9, 1537),
    (22, 10, 2049), (23, 10, 3073), (24, 11, 4097), (25, 11, 6145),
    (26, 12, 8193), (27, 12, 12289), (28, 13, 16385), (29, 13, 24577),
]:
    _DIST_BASE[_sym] = _b
    _DIST_EXTRA[_sym] = _eb

_FIXED_LIT = np.zeros(288, np.int32)
_FIXED_LIT[:144] = 8
_FIXED_LIT[144:256] = 9
_FIXED_LIT[256:280] = 7
_FIXED_LIT[280:] = 8
_FIXED_DIST = np.full(30, 5, np.int32)


def _rev_bits15(v: jax.Array) -> jax.Array:
    x = (v & np.uint32(0x7FFF)).astype(_U32)
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> np.uint32(1)  # 16-bit reverse -> drop the extra bit


def _canonical_decode_tables(lens: jax.Array):
    """Per-lane canonical decode structures from code lengths [B, S]."""
    b, s = lens.shape
    onehot = (lens[:, :, None] == jnp.arange(16, dtype=_I32)[None, None, :]).astype(_I32)
    cnt = jnp.sum(onehot, axis=1)  # [B,16]
    fcs = [jnp.zeros((b,), _I32)]  # fc for l=1
    for l in range(2, 16):
        fcs.append((fcs[-1] + cnt[:, l - 1]) << 1)
    first_code = jnp.stack(fcs, axis=1)  # [B,15]; index l-1 -> fc[l]
    # offset[l-1] = #symbols with length in [1, l)
    offset = jnp.concatenate(
        [jnp.zeros((b, 1), _I32), jnp.cumsum(cnt[:, 1:15], axis=1)], axis=1
    )[:, :15]
    key = jnp.where(lens > 0, lens * 512 + jnp.arange(s, dtype=_I32)[None, :], 1 << 20)
    symlist = jnp.argsort(key, axis=1).astype(_I32)
    return cnt, first_code, offset, symlist


def _decode_symbol(peek15_msb, tabs):
    """Canonical decode. Returns (sym, code_len_bits, valid), all [B]."""
    cnt, first_code, offset, symlist = tabs
    b = peek15_msb.shape[0]
    sym = jnp.zeros((b,), _I32)
    length = jnp.zeros((b,), _I32)
    found = jnp.zeros((b,), jnp.bool_)
    p15 = peek15_msb.astype(_I32)
    for l in range(1, 16):
        prefix = p15 >> (15 - l)
        lo = first_code[:, l - 1]
        hi = lo + cnt[:, l]
        hit = jnp.logical_and(
            jnp.logical_not(found),
            jnp.logical_and(cnt[:, l] > 0, jnp.logical_and(prefix >= lo, prefix < hi)),
        )
        idx = jnp.clip(offset[:, l - 1] + (prefix - lo), 0, symlist.shape[1] - 1)
        s_l = jnp.take_along_axis(symlist, idx[:, None], axis=1)[:, 0]
        sym = jnp.where(hit, s_l, sym)
        length = jnp.where(hit, l, length)
        found = jnp.logical_or(found, hit)
    return sym, length, found


@dataclass(frozen=True)
class InflateConfig:
    in_cap: int  # padded compressed payload width
    out_cap: int  # padded output width (>= max ISIZE)
    max_blocks: int = 16  # max deflate blocks per stream


def inflate_blocks(cfg: InflateConfig, streams_u8, in_lens, out_lens):
    """Decode B raw-deflate streams -> dict(out [B,out_cap] u8,
    out_count [B] i32, ok [B] bool)."""
    b, s_cap = streams_u8.shape
    assert s_cap == cfg.in_cap
    rows = jnp.arange(b, dtype=_I32)[:, None]
    row = jnp.arange(b, dtype=_I32)

    d = streams_u8.astype(_U32)
    pad = jnp.zeros((b, 3), _U32)
    dp = jnp.concatenate([d, pad], axis=1)
    w32 = (
        dp[:, 0:s_cap]
        | (dp[:, 1 : s_cap + 1] << 8)
        | (dp[:, 2 : s_cap + 2] << 16)
        | (dp[:, 3 : s_cap + 3] << 24)
    )

    def peek(bitpos):
        byte = bitpos >> 3
        shift = (bitpos & 7).astype(_U32)
        w = jnp.take_along_axis(w32, jnp.clip(byte, 0, s_cap - 1)[:, None], axis=1)[:, 0]
        return w >> shift  # >= 25 valid bits

    max_in_bits = in_lens * 8
    len_base = jnp.asarray(_LEN_BASE)
    len_extra = jnp.asarray(_LEN_EXTRA)
    dist_base = jnp.asarray(_DIST_BASE)
    dist_extra = jnp.asarray(_DIST_EXTRA)
    flit = jnp.asarray(_FIXED_LIT)
    fdist = jnp.asarray(_FIXED_DIST)

    def outer_body(carry):
        bitpos, opos, out, marks, done, error, nblocks = carry
        active = jnp.logical_not(jnp.logical_or(done, error))

        # ---------------- block header ----------------
        hdr = peek(bitpos)
        bfinal = (hdr & 1) == 1
        btype = ((hdr >> 1) & 3).astype(_I32)
        bitpos = jnp.where(active, bitpos + 3, bitpos)

        is_stored = jnp.logical_and(active, btype == 0)
        is_fixed = jnp.logical_and(active, btype == 1)
        is_dyn = jnp.logical_and(active, btype == 2)
        error = jnp.logical_or(error, jnp.logical_and(active, btype == 3))

        # ---- stored: byte-align, LEN/NLEN, bulk copy + literal marks ----
        aligned = (bitpos + 7) & ~7
        sbyte = aligned >> 3
        lenw = jnp.take_along_axis(w32, jnp.clip(sbyte, 0, s_cap - 1)[:, None], axis=1)[:, 0]
        st_len = (lenw & 0xFFFF).astype(_I32)
        st_nlen = ((lenw >> 16) & 0xFFFF).astype(_I32)
        error = jnp.logical_or(
            error, jnp.logical_and(is_stored, (st_len ^ 0xFFFF) != st_nlen)
        )
        k_idx = jnp.arange(cfg.out_cap, dtype=_I32)[None, :]
        copy_mask = jnp.logical_and(is_stored[:, None], k_idx < st_len[:, None])
        src_idx = jnp.clip(sbyte[:, None] + 4 + k_idx, 0, s_cap - 1)
        vals = jnp.take_along_axis(streams_u8, src_idx, axis=1)
        dst_idx = jnp.where(copy_mask, opos[:, None] + k_idx, cfg.out_cap)
        out = out.at[rows, dst_idx].set(vals, mode="drop")
        marks = marks.at[rows, dst_idx].set(0, mode="drop")  # literal marks
        opos = jnp.where(is_stored, opos + st_len, opos)
        bitpos = jnp.where(is_stored, (sbyte + 4 + st_len) * 8, bitpos)

        # ---------------- dynamic table parse ----------------
        dh = peek(bitpos)
        hlit = ((dh & 31) + 257).astype(_I32)
        hdist = (((dh >> 5) & 31) + 1).astype(_I32)
        hclen = (((dh >> 10) & 15) + 4).astype(_I32)
        bitpos = jnp.where(is_dyn, bitpos + 14, bitpos)
        error = jnp.logical_or(
            error, jnp.logical_and(is_dyn, jnp.logical_or(hlit > 286, hdist > 30))
        )

        cl_lens = jnp.zeros((b, 19), _I32)
        for i in range(19):
            v = (peek(bitpos) & 7).astype(_I32)
            take = jnp.logical_and(is_dyn, i < hclen)
            col = _CL_ORDER[i]
            cl_lens = cl_lens.at[:, col].set(jnp.where(take, v, cl_lens[:, col]))
            bitpos = jnp.where(take, bitpos + 3, bitpos)

        cl_tabs = _canonical_decode_tables(cl_lens)

        total = jnp.where(is_dyn, hlit + hdist, 0)
        all_lens = jnp.zeros((b, 316), _I32)

        def cl_cond(c):
            bp, n, al, err = c
            return jnp.any(jnp.logical_and(is_dyn, jnp.logical_and(n < total, jnp.logical_not(err))))

        def cl_body(c):
            bp, n, al, err = c
            act = jnp.logical_and(is_dyn, jnp.logical_and(n < total, jnp.logical_not(err)))
            pk = peek(bp)
            sym, clen, okk = _decode_symbol(_rev_bits15(pk), cl_tabs)
            err = jnp.logical_or(err, jnp.logical_and(act, jnp.logical_not(okk)))
            ebits = jnp.where(sym == 16, 2, jnp.where(sym == 17, 3, jnp.where(sym == 18, 7, 0)))
            eval_ = ((pk >> clen.astype(_U32)) & ((1 << ebits.astype(_U32)) - 1)).astype(_I32)
            rep = jnp.where(
                sym < 16, 1,
                jnp.where(sym == 16, 3 + eval_, jnp.where(sym == 17, 3 + eval_, 11 + eval_)),
            )
            prev = jnp.take_along_axis(al, jnp.clip(n - 1, 0, 315)[:, None], axis=1)[:, 0]
            err = jnp.logical_or(err, jnp.logical_and(act, jnp.logical_and(sym == 16, n == 0)))
            val = jnp.where(sym < 16, sym, jnp.where(sym == 16, prev, 0))
            pidx = jnp.arange(316, dtype=_I32)[None, :]
            wmask = jnp.logical_and(
                act[:, None],
                jnp.logical_and(pidx >= n[:, None], pidx < jnp.minimum(n + rep, total)[:, None]),
            )
            al = jnp.where(wmask, val[:, None], al)
            n2 = jnp.where(act, jnp.minimum(n + rep, total), n)
            bp2 = jnp.where(act, bp + clen + ebits, bp)
            err = jnp.logical_or(err, jnp.logical_and(act, bp2 > max_in_bits))
            return bp2, n2, al, err

        bitpos, _, all_lens, error = jax.lax.while_loop(
            cl_cond, cl_body, (bitpos, jnp.zeros((b,), _I32), all_lens, error)
        )

        # per-lane lit/dist code lengths (fixed or parsed)
        lit_idx = jnp.arange(288, dtype=_I32)[None, :]
        dyn_lit = jnp.where(
            lit_idx < hlit[:, None],
            jnp.take_along_axis(
                jnp.concatenate([all_lens, jnp.zeros((b, 2), _I32)], axis=1),
                jnp.minimum(lit_idx, 315), axis=1,
            ),
            0,
        )
        lit_lens = jnp.where(is_dyn[:, None], dyn_lit, flit[None, :])
        didx = jnp.arange(30, dtype=_I32)[None, :]
        dyn_dist = jnp.where(
            didx < hdist[:, None],
            jnp.take_along_axis(all_lens, jnp.clip(hlit[:, None] + didx, 0, 315), axis=1),
            0,
        )
        dist_lens = jnp.where(is_dyn[:, None], dyn_dist, fdist[None, :])

        lit_tabs = _canonical_decode_tables(lit_lens)
        dist_tabs = _canonical_decode_tables(dist_lens)

        # ---------------- symbol decode loop ----------------
        in_block = jnp.logical_and(
            jnp.logical_or(is_fixed, is_dyn), jnp.logical_not(error)
        )

        def sym_cond(c):
            return jnp.any(c[4])

        def sym_body(c):
            bp, op, out_, marks_, act, err = c
            pk = peek(bp)
            sym, clen, okk = _decode_symbol(_rev_bits15(pk), lit_tabs)
            err = jnp.logical_or(err, jnp.logical_and(act, jnp.logical_not(okk)))
            bp1 = bp + clen

            is_lit = jnp.logical_and(act, sym < 256)
            is_eob = jnp.logical_and(act, sym == 256)
            is_match = jnp.logical_and(act, sym > 256)

            lb = jnp.take(len_base, jnp.clip(sym, 0, 287))
            le = jnp.take(len_extra, jnp.clip(sym, 0, 287))
            lext = (peek(bp1) & ((1 << le.astype(_U32)) - 1)).astype(_I32)
            mlen = lb + lext
            bp2 = bp1 + le

            pk2 = peek(bp2)
            dsym, dbits, dok = _decode_symbol(_rev_bits15(pk2), dist_tabs)
            err = jnp.logical_or(err, jnp.logical_and(is_match, jnp.logical_not(dok)))
            bp3 = bp2 + dbits
            db_ = jnp.take(dist_base, jnp.clip(dsym, 0, 31))
            de_ = jnp.take(dist_extra, jnp.clip(dsym, 0, 31))
            dext = (peek(bp3) & ((1 << de_.astype(_U32)) - 1)).astype(_I32)
            dist = db_ + dext
            bp4 = bp3 + de_
            err = jnp.logical_or(err, jnp.logical_and(is_match, dist > op))

            # one scatter records both literal bytes-marks and match starts
            tpos = jnp.where(jnp.logical_or(is_lit, is_match), op, cfg.out_cap)
            tval = jnp.where(is_lit, 0, dist)
            marks_ = marks_.at[row, tpos].set(tval, mode="drop")
            lpos = jnp.where(is_lit, op, cfg.out_cap)
            out_ = out_.at[row, lpos].set(sym.astype(jnp.uint8), mode="drop")

            op2 = jnp.where(is_lit, op + 1, jnp.where(is_match, op + mlen, op))
            bpN = jnp.where(is_lit, bp1, jnp.where(is_match, bp4, jnp.where(is_eob, bp1, bp)))
            err = jnp.logical_or(
                err,
                jnp.logical_and(act, jnp.logical_or(op2 > out_lens, bpN > max_in_bits)),
            )
            act2 = jnp.logical_and(act, jnp.logical_and(jnp.logical_not(is_eob), jnp.logical_not(err)))
            return bpN, op2, out_, marks_, act2, err

        bitpos, opos, out, marks, _, error = jax.lax.while_loop(
            sym_cond, sym_body, (bitpos, opos, out, marks, in_block, error)
        )

        done = jnp.logical_or(done, jnp.logical_and(active, jnp.logical_and(bfinal, jnp.logical_not(error))))
        return bitpos, opos, out, marks, done, error, nblocks + 1

    def outer_cond(carry):
        _, _, _, _, done, error, nblocks = carry
        return jnp.logical_and(
            nblocks < cfg.max_blocks,
            jnp.any(jnp.logical_not(jnp.logical_or(done, error))),
        )

    out0 = jnp.zeros((b, cfg.out_cap), jnp.uint8)
    marks0 = jnp.full((b, cfg.out_cap), -1, _I32)
    init = (
        jnp.zeros((b,), _I32),  # bitpos
        jnp.zeros((b,), _I32),  # opos
        out0,
        marks0,
        out_lens == 0,  # done
        jnp.zeros((b,), jnp.bool_),  # error
        jnp.zeros((), _I32),
    )
    bitpos, opos, out, marks, done, error, _ = jax.lax.while_loop(
        outer_cond, outer_body, init
    )
    error = jnp.logical_or(error, jnp.logical_not(done))
    error = jnp.logical_or(error, opos != out_lens)

    # ---------------- phase 2: copy resolution ----------------
    pos_idx = jnp.broadcast_to(jnp.arange(cfg.out_cap, dtype=_I32)[None, :], (b, cfg.out_cap))
    start_mark = jnp.where(marks >= 0, pos_idx, -1)
    cover_start = jax.lax.cummax(start_mark, axis=1)
    cover_val = jnp.take_along_axis(marks, jnp.clip(cover_start, 0, cfg.out_cap - 1), axis=1)
    covered = jnp.logical_and(cover_start >= 0, cover_val > 0)
    src = jnp.where(covered, pos_idx - cover_val, pos_idx)
    src = jnp.clip(src, 0, cfg.out_cap - 1)
    # function-squaring pointer doubling: after k rounds the map applies
    # 2^k hops; literals are fixed points, so chains of any length
    # (long RLE runs) converge in log2(out_cap) rounds
    root = src
    for _ in range(int(np.ceil(np.log2(max(cfg.out_cap, 2))))):
        root = jnp.take_along_axis(root, root, axis=1)
    final_out = jnp.take_along_axis(out, root, axis=1)
    # zero the tail: copy resolution can smear bytes past out_len, and the
    # device CRC's padding correction needs zero padding
    final_out = jnp.where(pos_idx < out_lens[:, None], final_out, 0)

    return {"out": final_out, "out_count": opos, "ok": jnp.logical_not(error)}


@functools.lru_cache(maxsize=8)
def get_inflater(cfg: InflateConfig):
    """Jitted batch inflater that also returns each block's CRC32 (for
    footer verification without host-side checksum work)."""
    from gzp_tpu.ops.checksum import crc32_device

    @jax.jit
    def run(streams_u8, in_lens, out_lens):
        res = inflate_blocks(cfg, streams_u8, in_lens, out_lens)
        res["crc"] = crc32_device(res["out"], out_lens)
        return res

    return run
