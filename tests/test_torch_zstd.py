"""``data/zstd.py`` (RFC 8878 decompression without the ``zstandard``
package) against ``zstandard``'s compressor, frame by frame: raw, RLE and
compressed blocks; raw, RLE, Huffman (one and four streams, direct and
FSE-coded weights) and treeless literals; predefined, RLE, FSE and repeated
sequence tables with the repeat offsets; several frames, skippable frames
and content checksums. The block and literal kinds each case is meant to
reach are read back from the frames, so a compressor that stops writing
them fails the test rather than passing it vacuously."""

import struct

import numpy as np
import pytest

zs = pytest.importorskip("zstandard")

from reranking_multimodal_retrievers_tpu_torch.data import zstd  # noqa: E402


def _blocks(frame: bytes):
    """(block type, literals type or None) of each block of one frame."""
    fhd = frame[4]
    pos = 5 + (0 if fhd & 0x20 else 1)
    pos += (0, 1, 2, 4)[fhd & 3]
    pos += (1 if fhd & 0x20 else 0, 2, 4, 8)[fhd >> 6]
    out = []
    while True:
        h = int.from_bytes(frame[pos:pos + 3], "little")
        pos += 3
        kind, size = (h >> 1) & 3, h >> 3
        out.append((kind, frame[pos] & 3 if kind == 2 else None))
        pos += 1 if kind == 1 else size
        if h & 1:
            return out


def _text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy", b"dog"]
    return b" ".join(words[int(i)] + (b"%d" % j if j % 7 == 0 else b"")
                     for j, i in enumerate(rng.integers(0, len(words), n)))


CASES = {
    "empty": b"",
    "one_byte": b"a",
    "incompressible": bytes(np.random.default_rng(1).integers(0, 256, 5000).astype(np.uint8)),
    "zeros_over_blocks": bytes(300000),
    "text": _text(60000),
    "int64_ramp": np.arange(200000, dtype=np.int64).tobytes(),
    "float32_noise": np.random.default_rng(2).normal(size=50000).astype(np.float32).tobytes(),
    "small_alphabet": (np.random.default_rng(3).integers(0, 3, 140000) + 97).astype(np.uint8)
    .tobytes(),
    "short_repeats": b"".join(bytes([65 + int(k % 3)]) * int(k) for k in
                              np.random.default_rng(4).integers(3, 9, 60000)),
}


@pytest.mark.parametrize("level", [1, 3, 19, -5])
@pytest.mark.parametrize("name", sorted(CASES))
def test_frames_equal_zstandard(name, level):
    raw = CASES[name]
    for checksum in (False, True):
        frame = zs.ZstdCompressor(level=level, write_checksum=checksum).compress(raw)
        assert zstd.decompress(frame) == raw


def test_block_and_literal_kinds_are_reached():
    """Raw blocks (incompressible data), RLE blocks (a long run), compressed
    blocks with raw, Huffman, treeless and (hand-made) RLE literals."""
    seen = set()
    for raw in (CASES["incompressible"], CASES["zeros_over_blocks"], CASES["text"],
                _text(200000, seed=7)):
        for level in (1, 19):
            frame = zs.ZstdCompressor(level=level).compress(raw)
            seen.update(_blocks(frame))
            assert zstd.decompress(frame) == raw
    assert (0, None) in seen and (1, None) in seen  # raw, RLE blocks
    assert {(2, 0), (2, 2), (2, 3)} <= seen  # raw, Huffman, treeless literals
    # a compressed block of RLE literals and no sequences
    block = bytes([1 | (0 << 2) | (20 << 3), ord("q"), 0])
    frame = struct.pack("<I", zstd.MAGIC) + bytes([0x20, 20]) + \
        (1 | (2 << 1) | (len(block) << 3)).to_bytes(3, "little") + block
    assert zs.ZstdDecompressor().decompress(frame) == b"q" * 20
    assert zstd.decompress(frame) == b"q" * 20


def test_sequence_tables_and_repeat_offsets():
    """Many short matches at small offsets (min match 3): FSE and repeated
    tables and every repeat-offset case, through the levels' strategies."""
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(0, 256, 3).astype(np.uint8)) for _ in range(16)]
    raw = b"".join(words[int(i)] + bytes([int(j)]) for i, j in
                   zip(rng.integers(0, 16, 60000), rng.integers(0, 4, 60000)))
    for level in (1, 9, 19):
        params = zs.ZstdCompressionParameters.from_level(level, min_match=3)
        frame = zs.ZstdCompressor(compression_params=params).compress(raw)
        assert zstd.decompress(frame) == raw


def test_several_and_skippable_frames():
    a, b = b"hello " * 100, _text(3000)
    data = (zs.ZstdCompressor().compress(a)
            + struct.pack("<II", 0x184D2A53, 4) + b"skip"
            + zs.ZstdCompressor(write_checksum=True, level=19).compress(b)
            + zs.ZstdCompressor(write_content_size=False).compress(a))
    assert zstd.decompress(data) == a + b + a


def test_corrupt_and_unsupported_frames_raise():
    raw = _text(2000)
    frame = bytearray(zs.ZstdCompressor(write_checksum=True).compress(raw))
    frame[-1] ^= 0xFF
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"\x00" * 8)
    dict_data = zs.train_dictionary(4096, [_text(200, seed=s) for s in range(64)])
    framed = zs.ZstdCompressor(dict_data=dict_data).compress(raw)
    with pytest.raises(NotImplementedError, match="dictionary"):
        zstd.decompress(framed)


def test_xxh64_known_values():
    """XXH64 of the empty string and of "a" with seed 0 (the reference
    implementation's test vectors)."""
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
