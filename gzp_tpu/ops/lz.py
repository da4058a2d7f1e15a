"""Batched LZ77 match finding and parallel greedy parse.

Data-parallel replacement for the hash-chain match finders inside zlib-ng /
libdeflate (the reference's L0 codec backends, reference Cargo.toml:28-52).
Everything operates on a batch of independent blocks ``[B, N]`` with static
shapes and with no per-element indexed memory ops (gathers, scatters)
beyond two sorts:

* **Candidate discovery**: one multi-operand sort of
  ``(hash(4 bytes) << pos_bits) | position`` keys that *carries 12 bytes
  of suffix context as sort payload*; the nearest (and second-nearest)
  previous occurrence of each hash is the left neighbor in sorted order
  and match verification is a shift-compare of the carried context.
* **Order restoration**: a second 2-operand sort keyed by position
  (inverting a permutation by sorting instead of scattering).
* **Run detection** (distance-1 matches, the RLE workhorse) uses a
  segmented associative scan over byte-equality, exact to 258.
* **Match extension** beyond the carried context chains context-capped
  matches that agree on distance at static shift offsets (pointer
  doubling on shifts, log rounds of contiguous ops).
* **Greedy parse** (`parse_marks`) turns the sequential greedy walk into
  a per-window boolean reachability closure computed by batched int8
  matrix squarings; ``parse_marks_scan`` (the default) composes δ-state
  tables instead.

The result is a per-position token-start mask plus (length, distance)
arrays, ready for per-position format emission.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_I32 = jnp.int32

HASH_MUL = np.uint32(0x9E3779B1)  # Fibonacci hashing constant


def _pos_bits(n: int) -> int:
    """Bits needed to index ``n`` positions (the sort key packs
    ``hash << pos_bits | pos`` into 32 bits; bigger blocks get fewer hash
    bits)."""
    return max((n - 1).bit_length(), 1)


def words4(data_u8: jax.Array) -> jax.Array:
    """[B, N] uint8 -> [B, N] uint32 little-endian 4-byte word starting at
    each position (zero padded past the end)."""
    b, n = data_u8.shape
    d = data_u8.astype(_U32)
    pad = jnp.zeros((b, 3), dtype=_U32)
    dp = jnp.concatenate([d, pad], axis=1)
    return (
        dp[:, 0:n]
        | (dp[:, 1 : n + 1] << 8)
        | (dp[:, 2 : n + 2] << 16)
        | (dp[:, 3 : n + 3] << 24)
    )


def hash_positions(w4: jax.Array, hash_bits: int) -> jax.Array:
    """Multiplicative hash of each 4-byte window -> [B, N] uint32 in
    [0, 2**hash_bits)."""
    return (w4 * HASH_MUL) >> np.uint32(32 - hash_bits)


def _shift_right(a: jax.Array, lag: int, fill) -> jax.Array:
    """``out[i] = a[i-lag]`` along axis 1 (``fill`` for i < lag)."""
    b = a.shape[0]
    pad = jnp.full((b, lag), fill, dtype=a.dtype)
    return jnp.concatenate([pad, a[:, :-lag]], axis=1)


def _shift_left(a: jax.Array, lag: int, fill) -> jax.Array:
    """``out[i] = a[i+lag]`` along axis 1 (``fill`` past the end)."""
    b = a.shape[0]
    pad = jnp.full((b, lag), fill, dtype=a.dtype)
    return jnp.concatenate([a[:, lag:], pad], axis=1)


def _tz_bytes(x: jax.Array) -> jax.Array:
    """Number of trailing zero *bytes* (0..3) of a nonzero uint32 word."""
    return jnp.where(
        (x & 0xFF) != 0,
        0,
        jnp.where((x & 0xFFFF) != 0, 1, jnp.where((x & 0xFFFFFF) != 0, 2, 3)),
    ).astype(_I32)


def run_lengths(data_u8: jax.Array) -> jax.Array:
    """``run[i]`` = number of consecutive positions p >= i with
    ``data[p] == data[p-1]`` — i.e. the match length of the distance-1
    candidate at i. Computed with a reversed segmented-count associative
    scan (no sequential loop)."""
    b, n = data_u8.shape
    d = data_u8.astype(_I32)
    eq = jnp.concatenate(
        [jnp.zeros((b, 1), dtype=jnp.bool_), d[:, 1:] == d[:, :-1]], axis=1
    )
    rev = eq[:, ::-1]
    cnt = rev.astype(_I32)
    reset = jnp.logical_not(rev)

    def op(a, bb):
        c1, r1 = a
        c2, r2 = bb
        return jnp.where(r2, c2, c1 + c2), jnp.logical_or(r1, r2)

    cnt_scan, _ = jax.lax.associative_scan(op, (cnt, reset), axis=1)
    return cnt_scan[:, ::-1]


def _bswap32(x: jax.Array) -> jax.Array:
    """Byte-swap each uint32 so little-endian 4-byte windows compare
    byte-lexicographically as integers."""
    return (
        (x << 24)
        | ((x & jnp.uint32(0xFF00)) << 8)
        | ((x >> 8) & jnp.uint32(0xFF00))
        | (x >> 24)
    )


def _lz_bytes(x: jax.Array) -> jax.Array:
    """Number of leading zero *bytes* (0..4) of a uint32 (big-endian
    byte order, i.e. after :func:`_bswap32`)."""
    return jnp.where(
        x == 0, 4, jax.lax.clz(x.astype(_I32)).astype(_I32) >> 3
    )


def best_matches(
    data_u8: jax.Array,
    lengths: jax.Array,
    *,
    max_dist: int,
    max_match: int,
    min_emit: int,
    max_words: int = 8,
    base: int = 0,
    halo_start: jax.Array | None = None,
    lazy: bool = False,
    payload_words: int = 3,
    lags: int = 2,
    hash3: bool = False,
    suffix: bool = False,
    sample_step: int = 1,
    suffix_keys: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Best match (length, distance) at every position of every block.

    ``data_u8`` is ``[B, base + N]``: an optional ``base``-byte halo (the
    previous block's trailing dictionary, reference
    src/par/compress.rs:417-423) followed by the block payload. Valid
    payload spans ``[base, base + length)``; match *sources* may reach
    back to ``halo_start[b]`` (=``base - dict_len``).

    Returns ``(match_len, match_dist)`` each ``[B, base+N]`` int32 with
    ``match_len == 0`` where the position should be a literal. Lengths are
    clamped to the payload end and ``max_match``; distances respect
    ``max_dist`` (32768 for DEFLATE, 65535 for snappy).

    Design: sorts and contiguous elementwise ops only, no arbitrary
    gathers or scatters:

    * candidates come from ONE multi-operand sort of ``(hash<<bits)|pos``
      keys *carrying 12 bytes of suffix context as payload*, so candidate
      verification is a shift-compare against the sorted neighbor — no
      post-sort gathers;
    * results return to position order through a second 2-operand sort
      (inverting a permutation by sorting instead of scattering);
    * distance-1 runs come exact from a segmented scan;
    * matches longer than the carried context extend by pointer-doubling
      on *static* shifts: if the match at ``i`` is context-capped and
      ``i+cap`` found the same distance, lengths chain — log rounds of
      contiguous ops reach DEFLATE's 258.

    ``lazy=True`` applies zlib's lazy-match heuristic: a match is demoted
    to a literal when the next position holds a strictly longer match.

    ``suffix=True`` (levels >= 6) sorts by the carried CONTENT instead of
    by hash: keys are the byte-swapped context words plus position, so
    sorted order is suffix order truncated at ``payload_bytes`` — each
    position's ``lags`` neighbors in BOTH directions are its best
    candidates *by match length*, the quality a hash-chain matcher only
    reaches by walking thousands of chain entries (zlib level 9 walks up
    to 4096, deflate.c max_chain). Pure 3-byte matches fall out for free
    (no separate hash3 pass).

    ``sample_step=S > 1`` (fast levels) hashes and sorts only every S-th
    position — the dominant match-stage cost is the two sorts and both
    shrink by S. zlib's fast levels analogously skip hash insertions
    (deflate.c fill_window/deflate_fast at low levels). Lost coverage is
    recovered two ways: distance-1 runs stay full-resolution, and after
    extension every unsampled position derives the candidate implied by
    its left sampled neighbor (``len-r`` at distance ``dist`` — exact,
    since a match at ``i`` covers ``i+r`` at the same distance). Only
    matches STARTING at unsampled positions with no sampled cover are
    lost (~1-3% size, measured in benches/ratio.py sweeps).
    """
    del max_words  # v2 carries sort payload context; knob kept for API compat
    b, n_ext = data_u8.shape
    assert sample_step == 1 or (not suffix and not hash3), (
        "candidate sampling is a fast-level knob (hash path only)"
    )
    assert n_ext % sample_step == 0 and base % sample_step == 0
    pos_bits = _pos_bits(n_ext)
    payload_bytes = 4 * payload_words
    assert payload_bytes <= 28, "len field is 5 bits (<= 31 with extension)"
    w4 = words4(data_u8)
    i_idx = jnp.broadcast_to(jnp.arange(n_ext, dtype=_I32)[None, :], (b, n_ext))
    end = base + lengths[:, None]
    len_limit = end - i_idx  # bytes remaining at each position
    if halo_start is None:
        lo = jnp.zeros((b, 1), _I32)
    else:
        lo = halo_start[:, None].astype(_I32)

    pos_u = jnp.arange(n_ext, dtype=_U32)[None, :]

    def better(la, da, ca, lb, db, cb):
        a_wins = jnp.logical_or(la > lb, jnp.logical_and(la == lb, da < db))
        return (
            jnp.where(a_wins, la, lb),
            jnp.where(a_wins, da, db),
            jnp.where(a_wins, ca, cb),
        )

    def to_pos_order(sp, ls, ds, cs):
        """Pack (capped, len, dist) and sort back to position order
        (inverting a permutation by sorting beats a scatter). Invalid
        candidates carry garbage — possibly negative — distances across
        bucket boundaries; zero them so sign bits can't pollute the
        packed fields."""
        ds = jnp.where(ls > 0, ds, 0)
        packed = (
            ds.astype(_U32)
            | (ls.astype(_U32) << 17)
            | (cs.astype(_U32) << 22)
        )
        _, packed_pos = jax.lax.sort(
            (sp.astype(_U32), packed), dimension=1, num_keys=1
        )
        ln = ((packed_pos >> 17) & 0x1F).astype(_I32)
        dist = (packed_pos & 0x1FFFF).astype(_I32)
        capped = (packed_pos >> 22) == 1
        return ln, dist, capped

    if suffix:
        # -- content sort: lexicographic over the first ``suffix_keys``
        # context words (default: all of them), position as tie-break,
        # remaining words carried as payload operands. A comparison
        # sort's cost grows with its key count while payload operands
        # only ride along, so fewer key words are cheaper; candidates within a
        # key-equal bucket then come in RECENCY order (zlib chain order)
        # instead of full suffix order.
        kw = min(suffix_keys, payload_words) if suffix_keys else payload_words
        payload = [_shift_left(w4, 4 * k, jnp.uint32(0)) if k else w4
                   for k in range(payload_words)]
        keys = [jnp.broadcast_to(_bswap32(w), (b, n_ext)) for w in payload]
        sorted_ops = jax.lax.sort(
            (*keys[:kw], jnp.broadcast_to(pos_u, (b, n_ext)), *keys[kw:]),
            dimension=1, num_keys=kw + 1,
        )
        skeys = list(sorted_ops[:kw]) + list(sorted_ops[kw + 1:])
        sp = sorted_ops[kw].astype(_I32)

        # adjacent (lag-1) LCP over the FULL context, then lag-k LCPs by
        # sliding-min composition: for lexicographically sorted strings
        # lcp(s_i, s_{i-k}) = min(adj[i-k+1..i]) — exact at full key
        # width, and with truncated keys still a valid common prefix by
        # the LCP ultrametric inequality lcp(a,c) >= min(lcp(a,b),
        # lcp(b,c)), so every claimed match is genuine (possibly
        # shorter than optimal).
        adj = jnp.full((b, n_ext), payload_bytes, _I32)
        alive = jnp.ones((b, n_ext), jnp.bool_)
        for k, w in enumerate(skeys):
            x = w ^ _shift_right(w, 1, jnp.uint32(0))
            hit = jnp.logical_and(alive, x != 0)
            adj = jnp.where(hit, 4 * k + _lz_bytes(x), adj)
            alive = jnp.logical_and(alive, x == 0)

        def neighbor_dir(lag: int, up: bool, m_up):
            if up:
                cpos = _shift_right(sp, lag, -1)
                lcp = m_up
            else:
                cpos = _shift_left(sp, lag, -1)
                # LCP vs the lag-below neighbor == that neighbor's
                # lag-above LCP, shifted back
                lcp = _shift_left(m_up, lag, 0)
            dist = sp - cpos
            valid = jnp.logical_and(
                cpos >= lo,
                jnp.logical_and(dist >= 1, dist <= max_dist),
            )
            capped = jnp.logical_and(valid, lcp >= payload_bytes)
            lcp = jnp.where(valid, lcp, 0)
            return lcp, dist, capped

        m_up = adj
        ls = ds = cs = None
        for lag in range(1, lags + 1):
            if lag > 1:
                m_up = jnp.minimum(m_up, _shift_right(adj, lag - 1, 0))
            for up in (True, False):
                l2, d2, c2 = neighbor_dir(lag, up, m_up)
                if ls is None:
                    ls, ds, cs = l2, d2, c2
                else:
                    ls, ds, cs = better(ls, ds, cs, l2, d2, c2)
        suffix_ext = to_pos_order(sp, ls, ds, cs)

    # -- hash path: always runs. Content order ranks candidates by match
    # LENGTH but loses distance locality and extension-chain coherence
    # (nearest-previous picks keep dist constant as a long match slides,
    # which the pointer-doubling extension depends on), so the hybrid
    # keeps a shallow recency-ordered pass even at suffix levels —
    # measured: suffix-only was 4% WORSE than hash-only on repetitive
    # corpora while 6% better on the bench corpus; the merge takes both.
    hash_lags = 2 if suffix else lags
    h = hash_positions(w4, 32 - pos_bits)
    key = (h << np.uint32(pos_bits)) | pos_u
    payload = [_shift_left(w4, 4 * k, jnp.uint32(0)) if k else w4
               for k in range(payload_words)]
    key = jnp.broadcast_to(key, (b, n_ext))
    if sample_step > 1:
        key = key[:, ::sample_step]
        payload = [p[:, ::sample_step] for p in payload]
    sorted_ops = jax.lax.sort((key, *payload), dimension=1, num_keys=1)
    sk, spay = sorted_ops[0], sorted_ops[1:]
    sp = (sk & np.uint32((1 << pos_bits) - 1)).astype(_I32)
    sh = sk >> np.uint32(pos_bits)

    def neighbor(lag: int):
        cpos = _shift_right(sp, lag, -1)
        csame = _shift_right(sh, lag, np.uint32(0xFFFFFFFF)) == sh
        dist = sp - cpos
        valid = jnp.logical_and(
            jnp.logical_and(csame, cpos >= lo),
            jnp.logical_and(dist >= 1, dist <= max_dist),
        )
        # word-wise LCP of the carried context vs the lagged neighbor's
        lcp = jnp.full(sp.shape, payload_bytes, _I32)
        alive = jnp.ones(sp.shape, jnp.bool_)
        for k, w in enumerate(spay):
            x = w ^ _shift_right(w, lag, jnp.uint32(0))
            hit = jnp.logical_and(alive, x != 0)
            lcp = jnp.where(hit, 4 * k + _tz_bytes(x), lcp)
            alive = jnp.logical_and(alive, x == 0)
        capped = jnp.logical_and(valid, lcp >= payload_bytes)
        lcp = jnp.where(valid, lcp, 0)
        return lcp, dist, capped

    ls, ds, cs = neighbor(1)
    for lag in range(2, hash_lags + 1):
        l2, d2, c2 = neighbor(lag)
        ls, ds, cs = better(ls, ds, cs, l2, d2, c2)

    ln, dist, capped = to_pos_order(sp, ls, ds, cs)
    if sample_step > 1:
        # upsample sampled slots back to full resolution by interleaving
        # zero columns (a reshape, not a scatter); unsampled positions
        # are filled by the run scan below and by left-neighbor
        # derivation after extension
        def interleave(x):
            cols = [x] + [jnp.zeros_like(x) for _ in range(sample_step - 1)]
            return jnp.stack(cols, axis=2).reshape(b, n_ext)

        ln, dist = interleave(ln), interleave(dist)
        capped = interleave(capped.astype(_I32)) == 1

    if hash3:
        # second candidate source keyed on a 3-byte hash: finds the pure
        # 3-byte matches a 4-byte hash can never see (zlib hashes
        # MIN_MATCH=3 bytes). Lengths are capped at 4 — anything longer
        # shares its first 4 bytes and lands in the hash4 bucket above.
        h3 = ((w4 & np.uint32(0xFFFFFF)) * HASH_MUL) >> np.uint32(pos_bits)
        key3 = (h3 << np.uint32(pos_bits)) | pos_u
        sk3, sw3 = jax.lax.sort(
            (jnp.broadcast_to(key3, (b, n_ext)), w4), dimension=1, num_keys=1
        )
        sp3 = (sk3 & np.uint32((1 << pos_bits) - 1)).astype(_I32)
        sh3 = sk3 >> np.uint32(pos_bits)

        l3s = jnp.zeros((b, n_ext), _I32)
        d3s = jnp.zeros((b, n_ext), _I32)
        for lag in (1, 2):
            cpos = _shift_right(sp3, lag, -1)
            csame = _shift_right(sh3, lag, np.uint32(0xFFFFFFFF)) == sh3
            dist3 = sp3 - cpos
            valid = jnp.logical_and(
                jnp.logical_and(csame, cpos >= lo),
                jnp.logical_and(dist3 >= 1, dist3 <= max_dist),
            )
            x = sw3 ^ _shift_right(sw3, lag, jnp.uint32(0))
            lcp = jnp.where(x == 0, 4, _tz_bytes(x))
            lcp = jnp.where(valid, lcp, 0)
            win3 = jnp.logical_or(
                lcp > l3s, jnp.logical_and(lcp == l3s, dist3 < d3s)
            )
            l3s = jnp.where(win3, lcp, l3s)
            d3s = jnp.where(win3, dist3, d3s)
        d3s = jnp.where(l3s > 0, d3s, 0)
        packed3 = d3s.astype(_U32) | (l3s.astype(_U32) << 17)
        _, packed3_pos = jax.lax.sort(
            (sp3.astype(_U32), packed3), dimension=1, num_keys=1
        )
        ln3 = ((packed3_pos >> 17) & 0x1F).astype(_I32)
        dist3 = (packed3_pos & 0x1FFFF).astype(_I32)
        ln, dist, capped = better(
            ln, dist, capped, ln3, dist3, jnp.zeros_like(capped)
        )

    # -- distance-1 runs, exact to any length (the RLE workhorse)
    l3 = run_lengths(data_u8)
    l3 = jnp.where((i_idx - 1) >= lo, l3, 0)
    run_wins = jnp.logical_or(
        l3 > ln, jnp.logical_and(l3 == ln, 1 < dist)
    )
    dist = jnp.where(run_wins, 1, dist)
    capped = jnp.where(run_wins, False, capped)
    ln = jnp.where(run_wins, l3, ln)

    def extend(ln, dist, capped):
        """Extension doubling for context-capped matches: chains require
        the SAME distance to reappear ``cap`` ahead, so it must run on a
        coherent single-source candidate field — merging sources first
        would break chains (the suffix matcher's repetitive-corpus
        regression)."""
        cap = payload_bytes
        while cap < max_match:
            ln_next = _shift_left(ln, cap, 0)
            dist_next = _shift_left(dist, cap, 0)
            cap_next = _shift_left(capped, cap, False)
            chain = jnp.logical_and(capped, dist_next == dist)
            ln = jnp.where(chain, cap + jnp.where(ln_next > 0, ln_next, 0), ln)
            capped = jnp.logical_and(chain, cap_next)
            cap *= 2
        return ln, dist, capped

    ln, dist, capped = extend(ln, dist, capped)
    if suffix:
        ln_s, dist_s, capped_s = extend(*suffix_ext)
        wins = jnp.logical_or(
            ln_s > ln, jnp.logical_and(ln_s == ln, dist_s < dist)
        )
        ln = jnp.where(wins, ln_s, ln)
        dist = jnp.where(wins, dist_s, dist)
    if sample_step > 1:
        # unsampled positions inherit their left sampled neighbor's match
        # minus the offset (exact: a match at i covers i+r at the same
        # distance); done after extension so full 258-length chains carry
        for r in range(1, sample_step):
            ln_d = _shift_right(ln, r, 0) - r
            dist_d = _shift_right(dist, r, 0)
            win_d = ln_d > ln
            ln = jnp.where(win_d, ln_d, ln)
            dist = jnp.where(win_d, dist_d, dist)

    ln = jnp.minimum(ln, jnp.minimum(len_limit, max_match))
    ln = jnp.where(ln >= min_emit, ln, 0)
    # zlib's TOO_FAR heuristic: a length-3 match beyond 4096 costs more
    # bits than 3 literals more often than not (deflate.c TOO_FAR)
    ln = jnp.where(jnp.logical_and(ln == 3, dist > 4096), 0, ln)
    valid_pos = jnp.logical_and(i_idx >= base, i_idx < end)
    ln = jnp.where(valid_pos, ln, 0)

    if lazy:
        ln_next = jnp.concatenate([ln[:, 1:], jnp.zeros((b, 1), _I32)], axis=1)
        demote = jnp.logical_and(ln > 0, jnp.logical_and(ln < 32, ln_next > ln))
        ln = jnp.where(demote, 0, ln)
    return ln, dist


def parse_marks_scan(
    match_len: jax.Array,
    lengths: jax.Array,
    *,
    min_emit: int,
    base: int = 0,
    max_step: int = 255,
) -> tuple[jax.Array, jax.Array]:
    """Windowless greedy parse via δ-state function composition.

    The greedy walk ``next(i) = i + max(1, l_i)`` carries one scalar of
    state past position ``i``: δ = (next visited position) − i, with
    δ ∈ [0, max_step]. Each position is the map ``f_i(δ) = (δ == 0 ?
    step_i : δ) − 1``; a contiguous range is the composition of its
    maps, which for a range of length L is a table over entry-δ < L
    (≥ L passes through as δ − L). Tables cap at 256 entries because
    steps are capped at ``max_step`` = 255 (matches ≥ 256 emit 255 and
    re-match — sub-0.1% size cost) — exactly one byte, so the one-hot
    compositions stay exact even when a matmul rounds its f32 inputs to
    bf16 or TF32.

    Upward pass: log2(N) levels of pairwise table composition (one-hot
    matmuls, ~500 int8 MACs/element total vs the windowed closure's
    ~2000). Downward pass: evaluate each node's entry-δ from the root
    (δ=0); a leaf with entry-δ 0 is a token start. Unlike
    :func:`parse_marks` there is NO window clamp — matches keep their
    full length, which both removes the per-256-boundary truncation
    loss and the [B·NW, 257, 257] closure memory.

    Returns ``(marked, l)`` like :func:`parse_marks`.
    """
    b, m_in = match_len.shape
    w = max_step + 1  # δ-domain size (256)
    # pad to a power of two >= w so every level's tables are regular
    m = max(w, 1 << (m_in - 1).bit_length())
    pad = m - m_in
    if pad:
        match_len = jnp.concatenate(
            [match_len, jnp.zeros((b, pad), _I32)], axis=1
        )

    i_idx = jnp.broadcast_to(jnp.arange(m, dtype=_I32)[None, :], (b, m))
    end = base + lengths[:, None]
    l = jnp.minimum(match_len, max_step)
    l = jnp.minimum(l, jnp.maximum(end - i_idx, 0))
    l = jnp.where(l >= min_emit, l, 0)
    step = jnp.where(l > 0, l, 1)

    # leaf tables: width-1 (only entry δ=0 is non-pass-through)
    tables = (step - 1)[:, :, None].astype(jnp.float32)  # [B, M, 1]
    seg = 1

    def compose(f, g, seg_len):
        """Pairwise composition: parent[δ] = apply(g, f[δ]) for δ<width_f,
        then entries δ in [seg_len, parent_width) come straight from g."""
        wf = f.shape[-1]
        wg = g.shape[-1]
        wp = min(2 * seg_len, w)
        fv = f.astype(_I32)
        # v = f[δ] is relative to the midpoint; v < wg uses g's table,
        # else passes through as v - seg_len
        oh = jax.nn.one_hot(jnp.where(fv < wg, fv, wg), wg + 1, dtype=jnp.float32)
        thr = jnp.einsum("bnvk,bnk->bnv", oh[..., :wg], g)
        out_lo = jnp.where(fv < wg, thr.astype(_I32), fv - seg_len)
        if wp > wf:
            # entries δ ∈ [seg_len, wp): skip f entirely (δ' = δ - seg_len
            # entering g): g[δ - seg_len] for δ - seg_len < wg else δ - 2*seg_len
            d = jnp.arange(wf, wp, dtype=_I32) - seg_len  # [wp - wf]
            gpart = g[:, :, :]  # [B, P, wg]
            idx = jnp.clip(d, 0, wg - 1)
            taken = gpart[:, :, idx]  # static indices: plain slice-gather
            out_hi = jnp.where(
                (d >= 0)[None, None, :] & (d < wg)[None, None, :],
                taken.astype(_I32),
                (jnp.arange(wf, wp, dtype=_I32) - 2 * seg_len)[None, None, :],
            )
            out = jnp.concatenate([out_lo, out_hi], axis=-1)
        else:
            out = out_lo[..., :wp]
        return out.astype(jnp.float32)

    # upward: tables[level] kept for the downward pass
    ups = []
    t = tables
    while t.shape[1] > 1:
        f = t[:, 0::2]
        g = t[:, 1::2]
        ups.append((t, seg))
        t = compose(f, g, seg)
        seg *= 2
    ups.append((t, seg))

    # downward: entry-δ per node; root enters with δ = 0
    entry = jnp.zeros((b, 1), _I32)
    for t_lvl, seg_l in reversed(ups[:-1]):
        f = t_lvl[:, 0::2]  # [B, P, wf]
        wf = f.shape[-1]
        # left child entry = parent entry; right child entry = f_left(entry)
        oh = jax.nn.one_hot(jnp.minimum(entry, wf), wf + 1, dtype=jnp.float32)
        fe = jnp.einsum("bpk,bpk->bp", oh[..., :wf], f).astype(_I32)
        right = jnp.where(entry < wf, fe, entry - seg_l)
        entry = jnp.stack([entry, right], axis=2).reshape(b, -1)

    marked = entry == 0
    valid = jnp.logical_and(i_idx >= base, i_idx < end)
    marked = jnp.logical_and(marked, valid)
    return marked[:, :m_in], l[:, :m_in]


def parse_marks(
    match_len: jax.Array,
    lengths: jax.Array,
    *,
    window: int,
    min_emit: int,
    base: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Windowed greedy parse as a boolean-matmul reachability closure.

    The greedy walk ``next(i) = i + max(1, len(i))`` restarts at every
    ``window`` boundary (matches are clamped there, exactly like the
    round-1 pointer-doubling parse), so each window parses independently:
    build the one-step transition matrix of every window (one-hot of the
    local jump target, with an absorbing exit state) and square ``I + T``
    log2(window) times as batched int8 matmuls. Token starts = states
    reachable from local position 0. This replaces per-element
    gather/scatter pointer doubling.

    Returns ``(marked [B, M] bool, l [B, M] int32)`` — token-start mask
    and the window-clamped match length the parse actually used (callers
    must emit exactly these lengths).
    """
    b, m_in = match_len.shape
    assert window & (window - 1) == 0, "window must be a power of two"
    assert base % window == 0, "halo must be window-aligned"
    # pad to a whole number of windows (arbitrary user buffer sizes);
    # padded positions carry no matches and are masked out at the end
    m = -(-m_in // window) * window
    if m != m_in:
        match_len = jnp.concatenate(
            [match_len, jnp.zeros((b, m - m_in), _I32)], axis=1
        )
    nw = m // window
    s = window + 1  # + absorbing exit state

    i_idx = jnp.broadcast_to(jnp.arange(m, dtype=_I32)[None, :], (b, m))
    w_end = (i_idx // window + 1) * window
    end = base + lengths[:, None]
    l = jnp.minimum(match_len, w_end - i_idx)
    l = jnp.where(l >= min_emit, l, 0)
    step = jnp.where(l > 0, l, 1)
    nxt_local = (i_idx % window) + step  # in [1, window]

    t = jax.nn.one_hot(
        nxt_local.reshape(b * nw, window), s, dtype=jnp.int8
    )  # [NW, window, S]
    absorb = jax.nn.one_hot(
        jnp.full((b * nw, 1), window, _I32), s, dtype=jnp.int8
    )
    t = jnp.concatenate([t, absorb], axis=1)  # [NW, S, S]
    reach = jnp.minimum(t + jnp.eye(s, dtype=jnp.int8)[None, :, :], 1)

    def squaring(_, r):
        rr = jax.lax.dot_general(
            r, r,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )
        return jnp.minimum(rr, 1).astype(jnp.int8)

    reach = jax.lax.fori_loop(0, window.bit_length() - 1, squaring, reach)
    marked = reach[:, 0, :window].reshape(b, m) == 1

    valid = jnp.logical_and(i_idx >= base, i_idx < end)
    marked = jnp.logical_and(marked, valid)
    return marked[:, :m_in], l[:, :m_in]


