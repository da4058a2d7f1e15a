"""Batched device checksums: CRC32 / CRC32C / Adler32 over ``[B, N]`` blocks.

This is the device-side replacement for the reference's per-block checksum
work done on worker threads (reference src/par/compress.rs:288-289,
src/check.rs): every block in the device batch gets its checksum computed
on-device, in parallel, with no byte-serial loop:

* CRC: each ``seg_len``-byte segment's raw (linear) CRC is the XOR of one
  table lookup per byte, using a position-keyed table (the linear
  contribution of byte value ``v`` at in-segment offset ``q``); segments
  are then folded pairwise through precomputed zero-shift operator tables
  (a log-depth pigz-COMB tree, reference src/check.rs:123-128 scaled onto
  the device).
* Adler32 is plain modular arithmetic over segment sums — directly
  vectorizable.

All kernels assume full ``N``-byte blocks (the host pipeline recomputes the
single ragged tail block with the host Check classes — cheaper than masking
every lane).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gzp_tpu import check as _check
from gzp_tpu.ops import tables as _tables

_U32 = jnp.uint32

DEFAULT_SEG_LEN = 128


def _pick_seg_len(n: int) -> int:
    """Largest power-of-two segment length <= DEFAULT_SEG_LEN dividing n."""
    seg = DEFAULT_SEG_LEN
    while seg > 1 and n % seg != 0:
        seg //= 2
    return seg


def crc_device(data_u8: jax.Array, poly: int) -> jax.Array:
    """Batched CRC over full blocks as two GF(2) int8 matmuls.

    Args:
      data_u8: ``[B, N]`` uint8, every block exactly N real bytes.
      poly: reflected CRC polynomial (CRC32 or CRC32C).

    Returns:
      ``[B]`` uint32 of standard (pre/post-conditioned) CRC values.

    CRC is linear over GF(2), so the raw register of each ``seg``-byte
    segment is ``bits @ M`` (mod 2) for a constant basis matrix, and the
    pigz-COMB fold across segments is a second constant matmul — both in
    int8 with exact int32 accumulation. They stand in for a per-byte
    table gather + log-depth fold.
    """
    b, n = data_u8.shape
    seg = _pick_seg_len(n)
    nseg = n // seg

    bit_m = jnp.asarray(_tables.crc_bit_matrix(seg, poly))  # [seg*8, 32]
    fold_m = jnp.asarray(_tables.crc_seg_fold_matrix(nseg, seg, poly))

    d = data_u8.reshape(b * nseg, seg)
    bits = (
        (d[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)[None, None, :]) & 1
    ).astype(jnp.int8).reshape(b * nseg, seg * 8)
    seg_bits = (
        jax.lax.dot_general(
            bits, bit_m, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        & 1
    )  # [b*nseg, 32] parity bits of each segment's raw CRC
    x = seg_bits.astype(jnp.int8).reshape(b, nseg * 32)
    raw_bits = (
        jax.lax.dot_general(
            x, fold_m, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        & 1
    )  # [b, 32]
    raw = jnp.sum(
        raw_bits.astype(_U32) << jnp.arange(32, dtype=_U32)[None, :], axis=1,
        dtype=_U32,
    )
    init = np.uint32(_tables.crc_init_constant(n, poly))
    return (raw ^ init) ^ np.uint32(0xFFFFFFFF)


def crc_device_gather(data_u8: jax.Array, poly: int) -> jax.Array:
    """Gather-based CRC (round-1 path, kept for A/B measurement).

    Args:
      data_u8: ``[B, N]`` uint8, every block exactly N real bytes.
      poly: reflected CRC polynomial (CRC32 or CRC32C).

    Returns:
      ``[B]`` uint32 of standard (pre/post-conditioned) CRC values.
    """
    b, n = data_u8.shape
    seg = _pick_seg_len(n)
    nseg = n // seg
    # Round the segment count up to a power of two by *prepending* zero
    # segments: a zero segment's raw register is 0 and prefixing zero bytes
    # does not change the linear CRC, so the fold tree stays uniform.
    nseg_pad = 1 << max(nseg - 1, 0).bit_length()
    levels = (nseg_pad - 1).bit_length()

    pos_table = jnp.asarray(_tables.crc_position_table(seg, poly))
    data = data_u8.reshape(b, nseg, seg).astype(jnp.int32)
    # one lookup per byte: index = q*256 + byte  -> [B, S, L] uint32
    q_idx = (np.arange(seg, dtype=np.int32) * 256)[None, None, :]
    contrib = jnp.take(pos_table, data + q_idx, axis=0)

    # XOR-reduce within segment (log steps over the L axis).
    seg_crc = contrib
    width = seg
    while width > 1:
        half = width // 2
        seg_crc = seg_crc[..., :half] ^ seg_crc[..., half:width]
        width = half
    seg_crc = seg_crc[..., 0]  # [B, S]
    if nseg_pad != nseg:
        pad = jnp.zeros((b, nseg_pad - nseg), dtype=seg_crc.dtype)
        seg_crc = jnp.concatenate([pad, seg_crc], axis=1)

    # Pairwise fold across segments; level k shifts past seg*2^k zero bytes.
    if levels:
        fold = jnp.asarray(_tables.crc_fold_tables(seg, levels, poly))
        cur = seg_crc
        for k in range(levels):
            left = cur[:, 0::2]
            right = cur[:, 1::2]
            t = fold[k]
            shifted = (
                jnp.take(t[0], left & 0xFF, axis=0)
                ^ jnp.take(t[1], (left >> 8) & 0xFF, axis=0)
                ^ jnp.take(t[2], (left >> 16) & 0xFF, axis=0)
                ^ jnp.take(t[3], (left >> 24) & 0xFF, axis=0)
            )
            cur = shifted ^ right
        raw = cur[:, 0]
    else:
        raw = seg_crc[:, 0]

    init = np.uint32(_tables.crc_init_constant(n, poly))
    return (raw ^ init) ^ np.uint32(0xFFFFFFFF)


def _apply_tables(t: jax.Array, reg: jax.Array) -> jax.Array:
    """Apply a [4,256] operator-table set to uint32 registers."""
    return (
        jnp.take(t[0], (reg & 0xFF).astype(jnp.int32), axis=0)
        ^ jnp.take(t[1], ((reg >> 8) & 0xFF).astype(jnp.int32), axis=0)
        ^ jnp.take(t[2], ((reg >> 16) & 0xFF).astype(jnp.int32), axis=0)
        ^ jnp.take(t[3], ((reg >> 24) & 0xFF).astype(jnp.int32), axis=0)
    )


def crc_device_exact(data_u8: jax.Array, lengths: jax.Array, poly: int) -> jax.Array:
    """CRC over ``data[:, :length]`` for zero-padded ``[B, N]`` blocks.

    The full-block raw CRC is computed by the parallel fold, then the
    ``N - length`` trailing (zero) pad bytes are *removed* by walking the
    bits of the pad amount through a ladder of precomputed inverse shift
    operators; conditioning for the true length is applied with the forward
    ladder on the ~0 init register. Cost beyond the padded CRC: ~2*log2(N)
    four-gather table applications on [B] registers — negligible.
    """
    b, n = data_u8.shape
    # raw linear register of the padded block: undo the fold's conditioning
    init_n = np.uint32(_tables.crc_init_constant(n, poly))
    padded = crc_device(data_u8, poly)
    raw_full = (padded ^ np.uint32(0xFFFFFFFF)) ^ init_n

    max_log = max(n.bit_length(), 1)
    unshift = jnp.asarray(_tables.crc_unshift_ladder(max_log, poly))
    shift = jnp.asarray(_tables.crc_shift_ladder(max_log, poly))

    pad = (jnp.asarray(n, jnp.int32) - lengths).astype(jnp.int32)
    raw = raw_full
    init_reg = jnp.full((b,), np.uint32(0xFFFFFFFF), dtype=_U32)
    for k in range(max_log):
        bit = ((pad >> k) & 1).astype(jnp.bool_)
        raw = jnp.where(bit, _apply_tables(unshift[k], raw), raw)
    ln = lengths.astype(jnp.int32)
    for k in range(max_log):
        bit = ((ln >> k) & 1).astype(jnp.bool_)
        init_reg = jnp.where(bit, _apply_tables(shift[k], init_reg), init_reg)
    return (raw ^ init_reg) ^ np.uint32(0xFFFFFFFF)


def crc32_device(data_u8: jax.Array, lengths: jax.Array | None = None) -> jax.Array:
    """Batched CRC32 (gzip/mgzip/bgzf member checksum). With ``lengths``,
    computes the exact CRC of each block's first ``length`` bytes."""
    if lengths is None:
        return crc_device(data_u8, _check.CRC32_POLY)
    return crc_device_exact(data_u8, lengths, _check.CRC32_POLY)


def crc32c_masked_device(
    data_u8: jax.Array, lengths: jax.Array | None = None
) -> jax.Array:
    """Batched snappy-frame checksum: CRC32C then snappy masking."""
    if lengths is None:
        crc = crc_device(data_u8, _check.CRC32C_POLY)
    else:
        crc = crc_device_exact(data_u8, lengths, _check.CRC32C_POLY)
    masked = ((crc >> 15) | (crc << 17)) + np.uint32(0xA282EAD8)
    return masked


ADLER_MOD = np.int32(65521)
_ADLER_SEG = 128  # keeps q*b sums < 2^24 and exact in int32 comfortably


def adler32_device(data_u8: jax.Array, lengths: jax.Array | None = None) -> jax.Array:
    """Batched Adler32 -> ``[B]`` uint32; exact for zero-padded blocks when
    ``lengths`` is given.

    Per segment s of length L: S1_s = sum(b_q), Q_s = sum(q * b_q); then
      A = 1 + sum_s S1_s                               (mod 65521)
      B = len + sum_s ((N - s*L) * S1_s - Q_s)
             - (N - len) * sum_s S1_s                  (mod 65521)
    (zero pad bytes contribute nothing to any byte sum, so only the
    position weights need the length correction). Products are done in
    uint32 (< 2^32) after reducing factors mod 65521.
    """
    b, n = data_u8.shape
    seg = _ADLER_SEG
    while n % seg != 0:
        seg //= 2
    nseg = n // seg
    data = data_u8.reshape(b, nseg, seg).astype(jnp.int32)
    q = np.arange(seg, dtype=np.int32)[None, None, :]
    s1 = jnp.sum(data, axis=-1)  # [B, S] <= 255*seg
    qsum = jnp.sum(data * q, axis=-1)  # [B, S] < 2^24 for seg<=256

    s1_mod = (s1 % ADLER_MOD).astype(_U32)
    q_mod = (qsum % ADLER_MOD).astype(_U32)
    weight = ((n - np.arange(nseg, dtype=np.int64) * seg) % 65521).astype(np.uint32)[None, :]
    term = (weight * s1_mod) % jnp.uint32(65521)
    term = (term + jnp.uint32(65521) - q_mod) % jnp.uint32(65521)

    s1_total = jnp.sum(s1_mod, axis=-1) % jnp.uint32(65521)
    a = (jnp.uint32(1) + s1_total) % jnp.uint32(65521)
    bsum = jnp.sum(term, axis=-1) % jnp.uint32(65521)
    if lengths is None:
        ln_mod = jnp.full((b,), np.uint32(n % 65521), dtype=_U32)
        pad_mod = jnp.zeros((b,), dtype=_U32)
    else:
        ln = lengths.astype(jnp.int32)
        ln_mod = (ln % 65521).astype(_U32)
        pad_mod = ((jnp.asarray(n, jnp.int32) - ln) % 65521).astype(_U32)
    corr = (pad_mod * s1_total) % jnp.uint32(65521)
    bsum = (bsum + ln_mod + jnp.uint32(65521) - corr) % jnp.uint32(65521)
    return (bsum << 16) | a


@functools.partial(jax.jit, static_argnames=("poly",))
def _crc_jit(data_u8: jax.Array, poly: int) -> jax.Array:
    return crc_device(data_u8, poly)


def crc32_blocks_host(arr: np.ndarray) -> np.ndarray:
    """Convenience host entry: batched crc32 of an ``[B, N]`` uint8 array."""
    return np.asarray(_crc_jit(jnp.asarray(arr), _check.CRC32_POLY))
