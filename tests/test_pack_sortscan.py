"""The sortscan bit packer and the jitted encoder: bit-exactness vs the
grouped packer, oracle decode, compaction, and edge shapes.

The packer contract (gzp_tpu/ops/deflate_kernel.py:pack_entries_sortscan)
mirrors the reference's bit-writer inside zlib-ng/libdeflate (reference
Cargo.toml:28-52) but is scatter-free; these tests pin the equivalence so
either packer can back any format.
"""

import dataclasses
import gzip
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from gzp_tpu.ops.deflate_kernel import (
    DeflateEncodeConfig,
    encode_deflate_blocks,
    get_encoder,
    pack_entries_grouped,
    pack_entries_sortscan,
)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("base", [0, 144, 160])
def test_packer_equivalence_random(seed, base):
    rng = np.random.default_rng(seed)
    b, e = int(rng.integers(1, 5)), int(rng.integers(1, 500))
    nb = rng.integers(0, 32, (b, e)).astype(np.int32)
    nb = np.where(rng.random((b, e)) < 0.6, 0, nb)  # sparse like real emission
    bits = rng.integers(0, 1 << 31, (b, e)).astype(np.uint32) & (
        (np.uint32(1) << nb.astype(np.uint32)) - 1
    )
    out_words = (base + 31 * e + 31) // 32 + 12
    w1, t1 = pack_entries_grouped(jnp.asarray(bits), jnp.asarray(nb), base, out_words)
    w2, t2 = pack_entries_sortscan(jnp.asarray(bits), jnp.asarray(nb), base, out_words)
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))


@pytest.mark.parametrize(
    "nb_case",
    [
        np.zeros((2, 5), np.int32),  # all zero-width
        np.full((1, 1), 31, np.int32),  # single max-width entry
        np.array([[16, 16, 16, 16]], np.int32),  # exact word boundaries
        np.array([[31, 31, 31, 31, 2]], np.int32),  # every entry crosses
    ],
)
def test_packer_equivalence_edges(nb_case):
    bits = ((np.uint32(1) << nb_case.astype(np.uint32)) - 1) & np.uint32(0x5A5A5A5A)
    e = nb_case.shape[1]
    ow = (31 * e + 64) // 32 + 12
    w1, t1 = pack_entries_grouped(jnp.asarray(bits), jnp.asarray(nb_case), 0, ow)
    w2, t2 = pack_entries_sortscan(jnp.asarray(bits), jnp.asarray(nb_case), 0, ow)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))


def _text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"some deflate test text ", b"with repeated repeated phrases\n",
             b"abcabcabcabc", b"\x00\x01\x02\x03 binary bits "]
    out = b""
    while len(out) < n:
        out += words[rng.integers(0, len(words))]
    return out[:n]


@pytest.mark.parametrize("mode", ["mgzip", "bgzf", "stream"])
def test_full_encoder_sortscan_oracle(mode):
    n = 16384 if mode != "bgzf" else 32640
    b = 3
    data = np.frombuffer(_text(b * n, 3), np.uint8).reshape(b, n).copy()
    lengths = np.full((b,), n, np.int32)
    lengths[-1] = n - 11
    data[-1, lengths[-1]:] = 0
    finals = np.zeros((b,), bool)
    finals[-1] = True
    cfg = dataclasses.replace(
        DeflateEncodeConfig.for_level(n, mode, "crc32", 3), pack="sortscan"
    )
    r = encode_deflate_blocks(
        cfg, jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(finals)
    )
    out, ol = np.asarray(r["out"]), np.asarray(r["out_len"])
    if mode == "stream":
        stream = b"".join(out[i, : ol[i]].tobytes() for i in range(b))
        dec = zlib.decompressobj(-15).decompress(stream)
        assert dec == b"".join(data[i, : lengths[i]].tobytes() for i in range(b))
    else:
        for i in range(b):
            assert gzip.decompress(out[i, : ol[i]].tobytes()) == data[i, : lengths[i]].tobytes()


def test_encoder_compact_flat_matches_rows():
    """``get_encoder(compact=True)``'s ``flat`` is the rows' valid bytes
    back to back, and the rows equal the un-jitted encoder's."""
    n, b = 8192, 2
    data = np.frombuffer(_text(b * n, 7), np.uint8).reshape(b, n)
    lengths = np.full((b,), n, np.int32)
    finals = np.zeros((b,), bool)
    cfg = DeflateEncodeConfig.for_level(n, "mgzip", "none", 3)
    args = (jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(finals))
    r1 = encode_deflate_blocks(cfg, *args)
    r2 = get_encoder(cfg, compact=True)(*args)
    out, ol = np.asarray(r2["out"]), np.asarray(r2["out_len"])
    np.testing.assert_array_equal(np.asarray(r1["out"]), out)
    np.testing.assert_array_equal(np.asarray(r1["out_len"]), ol)
    rows = b"".join(out[i, : ol[i]].tobytes() for i in range(b))
    assert np.asarray(r2["flat"])[: len(rows)].tobytes() == rows


def test_encoder_dict_carry():
    """Halo path through the jitted encoder: distances reaching into the
    previous block's tail decode (reference src/par/compress.rs:417-423)."""
    n, b = 4096, 2
    blob = _text(2 * n, 9)
    data = np.frombuffer(blob, np.uint8).reshape(b, n)
    lengths = np.full((b,), n, np.int32)
    finals = np.array([False, True])
    dict_size = 1024
    halo = np.zeros((b, dict_size), np.uint8)
    halo[1] = data[0, -dict_size:]
    dict_lens = np.array([0, dict_size], np.int32)
    cfg = DeflateEncodeConfig.for_level(n, "stream", "crc32", 3, dict_size=dict_size)
    r = get_encoder(cfg)(
        jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(finals),
        jnp.asarray(halo), jnp.asarray(dict_lens),
    )
    out, ol = np.asarray(r["out"]), np.asarray(r["out_len"])
    stream = b"".join(out[i, : ol[i]].tobytes() for i in range(b))
    assert zlib.decompressobj(-15).decompress(stream) == blob


@pytest.mark.parametrize("seed", [0, 3])
def test_compact_sort_matches_scatter(seed):
    from gzp_tpu.ops.deflate_kernel import compact_outputs

    rng = np.random.default_rng(seed)
    b, m = 5, 64
    out = rng.integers(0, 256, (b, m)).astype(np.uint8)
    out_len = rng.integers(0, m + 1, b).astype(np.int32)
    out_len[1] = 0  # empty block chains the boundary word across rows
    f1 = np.asarray(compact_outputs(jnp.asarray(out), jnp.asarray(out_len), "scatter"))
    f2 = np.asarray(compact_outputs(jnp.asarray(out), jnp.asarray(out_len), "sort"))
    np.testing.assert_array_equal(f1, f2)
    want = b"".join(out[i, : out_len[i]].tobytes() for i in range(b))
    assert f2[: len(want)].tobytes() == want


@pytest.mark.parametrize("level", [6, 9])
def test_suffix_matcher_oracle(level):
    """Levels >= 6 use the suffix-order matcher (content-sorted
    candidates); output must stay a valid gzip member and not exceed the
    hash matcher's size."""
    n, b = 16384, 2
    data = np.frombuffer(_text(b * n, 21), np.uint8).reshape(b, n)
    lengths = np.full((b,), n, np.int32)
    finals = np.zeros((b,), bool)
    cfg = DeflateEncodeConfig.for_level(n, "mgzip", "none", level)
    assert cfg.matcher == "suffix"
    r = encode_deflate_blocks(
        cfg, jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(finals)
    )
    out, ol = np.asarray(r["out"]), np.asarray(r["out_len"])
    for i in range(b):
        assert gzip.decompress(out[i, : ol[i]].tobytes()) == data[i].tobytes()
    # vs the hash matcher: on REPETITIVE corpora recency-first candidate
    # order can win slightly (nearer distances = fewer bits), so allow a
    # small margin here; the quality win that matters is on the bench
    # corpus (benches/ratio.py: x1.095 -> x1.026 at level 6)
    cfg_h = dataclasses.replace(cfg, matcher="hash")
    rh = encode_deflate_blocks(
        cfg_h, jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(finals)
    )
    assert int(ol.sum()) <= int(np.asarray(rh["out_len"]).sum()) * 1.02


def test_subblock_tables_oracle():
    """subblocks > 1 emits one deflate block (own Huffman tables) per
    sub-block; matches crossing sub-block boundaries must survive."""
    n, b = 16384, 2
    blob = _text(b * n, 31)
    data = np.frombuffer(blob, np.uint8).reshape(b, n)
    lengths = np.full((b,), n, np.int32)
    finals = np.zeros((b,), bool)
    cfg = dataclasses.replace(
        DeflateEncodeConfig.for_level(n, "mgzip", "crc32", 6), subblocks=4
    )
    r = encode_deflate_blocks(
        cfg, jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(finals)
    )
    out, ol = np.asarray(r["out"]), np.asarray(r["out_len"])
    for i in range(b):
        assert gzip.decompress(out[i, : ol[i]].tobytes()) == data[i].tobytes()


def test_parcompress_verify_happy_and_repair():
    """The verify knob oracle-decodes every block; a corrupted blob is
    re-emitted as a stored encoding with a host-recomputed checksum."""
    import io

    from gzp_tpu import Mgzip
    from gzp_tpu.parallel.compress import ParCompress

    data = _text(100000, 5)
    buf = io.BytesIO()
    w = ParCompress(Mgzip, buf, num_threads=2, buffer_size=32768, verify=True)
    w.write(data)
    w.finish()
    assert gzip.decompress(buf.getvalue()) == data
    assert w.verify_stats["checked"] >= 4
    assert w.verify_stats["repaired"] == 0

    # repair path: hand a corrupted member to the verifier directly
    member = gzip.compress(b"x" * 1000)  # not even mgzip-framed: must repair
    blob, chk = w._verify_or_repair(member, b"y" * 1000, 1000, True, 123)
    assert w.verify_stats["repaired"] == 1
    assert gzip.decompress(blob) == b"y" * 1000


@pytest.mark.parametrize("verify", [None, False])
def test_parcompress_verify_off_by_default(verify):
    """Without an explicit verify=True no block is oracle-decoded, on any
    backend (the reference trusts its codecs, src/par/compress.rs:288-289)."""
    import io

    from gzp_tpu import Mgzip
    from gzp_tpu.parallel.compress import ParCompress

    data = _text(70000, 6)
    buf = io.BytesIO()
    kw = {} if verify is None else {"verify": verify}
    w = ParCompress(Mgzip, buf, num_threads=2, buffer_size=32768, **kw)
    w.write(data)
    w.finish()
    assert gzip.decompress(buf.getvalue()) == data
    assert w.verify_stats == {"checked": 0, "repaired": 0}


def test_dict_carry_with_subblocks_and_suffix():
    """The three round-4 features together: 32 KiB-style halo carry,
    content-ordered candidates, and per-sub-block Huffman tables. The
    distance stash crosses sub-block rows at full-block scope and halo
    offsets must survive the payload slice."""
    n, b, dict_size = 8192, 2, 1024
    blob = _text(2 * n, 11)
    data = np.frombuffer(blob, np.uint8).reshape(b, n)
    lengths = np.full((b,), n, np.int32)
    finals = np.array([False, True])
    halo = np.zeros((b, dict_size), np.uint8)
    halo[1] = data[0, -dict_size:]
    dict_lens = np.array([0, dict_size], np.int32)
    cfg = dataclasses.replace(
        DeflateEncodeConfig.for_level(n, "stream", "crc32", 6, dict_size=dict_size),
        subblocks=2,
    )
    assert cfg.matcher == "suffix"
    r = encode_deflate_blocks(
        cfg, jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(finals),
        jnp.asarray(halo), jnp.asarray(dict_lens),
    )
    out, ol = np.asarray(r["out"]), np.asarray(r["out_len"])
    stream = b"".join(out[i, : ol[i]].tobytes() for i in range(b))
    assert zlib.decompressobj(-15).decompress(stream) == blob


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"the quick brown fox ", b"jumps over the lazy dog ",
             b"pack my box with five dozen liquor jugs "]
    out, total = [], 0
    while total < n:
        w = words[rng.integers(0, len(words))]
        out.append(w)
        total += len(w)
    return b"".join(out)[:n]


def test_int8_lookup_byte_identical():
    """lookup='int8' (nibble-split int8 matmul) must produce the same
    stream as the f32 one-hot path."""
    B, N = 2, 32768
    data = np.frombuffer(_corpus(B * N, seed=31), np.uint8).reshape(B, N)
    lengths = jnp.full((B,), N, jnp.int32)
    finals = jnp.zeros((B,), bool)
    base = DeflateEncodeConfig.for_level(N, "mgzip", "none", 3)
    r1 = encode_deflate_blocks(base, jnp.asarray(data), lengths, finals)
    c8 = dataclasses.replace(base, lookup="int8")
    r2 = encode_deflate_blocks(c8, jnp.asarray(data), lengths, finals)
    assert np.array_equal(np.asarray(r1["out_len"]), np.asarray(r2["out_len"]))
    assert np.array_equal(np.asarray(r1["out"]), np.asarray(r2["out"]))
    ol = np.asarray(r2["out_len"])
    for i in range(B):
        assert gzip.decompress(
            np.asarray(r2["out"])[i, : ol[i]].tobytes()
        ) == data[i].tobytes()
