"""``data/brotli.py`` (RFC 7932) against pyarrow's Brotli codec and the
Brotli C library, and the parquet and Arrow readers' BROTLI pages, INT96
columns and DATE/TIME/TIMESTAMP types against ``pyarrow`` and
``datasets``, on the CPU.

Values are compared under ``data/temporal.py``'s rule: where pyarrow gives
a ``pandas.Timestamp`` (nanosecond timestamps, INT96), the port gives a
``datetime.datetime`` whose ``nanosecond`` attribute carries what the
microseconds do not; every other value is equal and of the same type, and
zoned values carry the same zone."""

import ctypes
import ctypes.util
import datetime
import json
import os
import pickle
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")
datasets = pytest.importorskip("datasets")

from reranking_multimodal_retrievers_tpu_torch.data import (  # noqa: E402
    arrow_io, brotli, parquet_io, temporal)

HERE = os.path.dirname(os.path.abspath(__file__))
VARIANTS = os.path.join(HERE, "fixtures", "parquet_variants")
sys.path.insert(0, os.path.join(HERE, "fixtures"))
try:
    import make_m2kr_parquet as fixtures  # noqa: E402
finally:
    sys.path.pop(0)


def same(want, got) -> bool:
    """``got`` (the port's value) equals ``want`` (pyarrow's) under the rule."""
    if isinstance(want, list):
        return isinstance(got, list) and len(want) == len(got) and all(
            same(w, g) for w, g in zip(want, got))
    if isinstance(want, dict):
        return isinstance(got, dict) and want.keys() == got.keys() and all(
            same(want[k], got[k]) for k in want)
    if hasattr(want, "nanosecond"):  # pandas.Timestamp
        py = want.to_pydatetime(warn=False)
        return (isinstance(got, temporal.Timestamp) and got == py
                and got.nanosecond == want.nanosecond and got.utcoffset() == py.utcoffset()
                and str(got.tzinfo) == str(py.tzinfo))
    return (type(got) is type(want) and got == want
            and str(getattr(got, "tzinfo", None)) == str(getattr(want, "tzinfo", None)))


def _rows(table):
    return [table[i] for i in range(len(table))]


# ------------------------------------------------------------------ Brotli
TEXT = (" ".join(fixtures._ENGLISH) + ". The World of the People. ") * 40


def _payloads():
    rng = np.random.default_rng(3)
    return {"text": TEXT.encode(), "random": bytes(rng.integers(0, 256, 30000, dtype=np.uint8)),
            "small_alphabet": bytes(rng.integers(0, 3, 60000, dtype=np.uint8)),
            "utf8": ("Ünïcödé — ∑ 東京 가각 " * 400).encode(), "empty": b"", "one": b"x",
            "runs": b"a" * 70000 + b"b" * 3 + b"ab" * 5000}


@pytest.mark.parametrize("level", range(12))
def test_decompress_equals_pyarrow_brotli(level):
    """Every quality pyarrow's Brotli writes (0-11: its block splits,
    context modes and maps, distance codes and dictionary references) on
    text, random bytes, UTF-8 and long runs."""
    codec = pa.Codec("brotli", compression_level=level)
    for name, data in _payloads().items():
        assert brotli.decompress(codec.compress(data, asbytes=True)) == data, (level, name)


def test_uncompressed_and_metadata_meta_blocks():
    """A hand-made stream: a metadata block, an uncompressed meta-block,
    then an empty last one (RFC 7932 9.2)."""
    bits = []

    def put(v, n):
        bits.extend((v >> i) & 1 for i in range(n))

    put(0, 1)  # WBITS 16
    put(0, 1)  # ISLAST 0
    put(3, 2)  # MNIBBLES 0: metadata
    put(0, 1)  # reserved
    put(1, 2)  # MSKIPBYTES 1
    put(2, 8)  # MSKIPLEN - 1 = 2: three bytes
    payload = b"hello brotli"
    head = bytearray()
    while len(bits) % 8:
        bits.append(0)
    head += bytes(int("".join(map(str, bits[i:i + 8][::-1])), 2) for i in range(0, len(bits), 8))
    head += b"abc"
    bits.clear()
    put(0, 1)  # ISLAST 0
    put(0, 2)  # MNIBBLES 4
    put(len(payload) - 1, 16)
    put(1, 1)  # ISUNCOMPRESSED
    while len(bits) % 8:
        bits.append(0)
    head += bytes(int("".join(map(str, bits[i:i + 8][::-1])), 2) for i in range(0, len(bits), 8))
    head += payload + bytes([0b11])  # ISLAST, ISLASTEMPTY
    assert brotli.decompress(bytes(head)) == payload


def test_dictionary_and_transforms_equal_the_c_library():
    """The committed dictionary and the 121 transforms written out in
    ``brotli.py`` equal what the Brotli C library hands out
    (``BrotliGetDictionary``, ``BrotliGetTransforms``)."""
    name = ctypes.util.find_library("brotlicommon")
    if name is None:
        pytest.skip("no libbrotlicommon on this machine")
    lib = ctypes.CDLL(name)
    sys.path.insert(0, os.path.join(HERE, "fixtures"))
    try:
        import make_brotli_dictionary
    finally:
        sys.path.pop(0)
    assert make_brotli_dictionary.extract(name) == brotli.dictionary()

    class Transforms(ctypes.Structure):
        _fields_ = [("prefix_suffix_size", ctypes.c_uint16),
                    ("prefix_suffix", ctypes.POINTER(ctypes.c_uint8)),
                    ("prefix_suffix_map", ctypes.POINTER(ctypes.c_uint16)),
                    ("num_transforms", ctypes.c_uint32),
                    ("transforms", ctypes.POINTER(ctypes.c_uint8)),
                    ("params", ctypes.POINTER(ctypes.c_uint8))]

    lib.BrotliGetTransforms.restype = ctypes.POINTER(Transforms)
    t = lib.BrotliGetTransforms().contents

    def text(i):
        at = t.prefix_suffix_map[i]
        return bytes(t.prefix_suffix[at + 1:at + 1 + t.prefix_suffix[at]])

    got = [(text(t.transforms[3 * i]), t.transforms[3 * i + 1], text(t.transforms[3 * i + 2]))
           for i in range(t.num_transforms)]
    assert got == brotli.TRANSFORMS


def test_a_damaged_dictionary_is_refused(tmp_path, monkeypatch):
    import zlib

    bad = tmp_path / "d.bin.z"
    bad.write_bytes(zlib.compress(b"x" * brotli.DICTIONARY_SIZE))
    monkeypatch.setattr(brotli, "DICTIONARY_FILE", bad)
    monkeypatch.setattr(brotli, "_DICTIONARY", None)
    with pytest.raises(brotli.BrotliError, match="not RFC 7932"):
        brotli.dictionary()


@pytest.mark.parametrize("level,version,dictionary", [(1, "1.0", True), (11, "2.0", False),
                                                      (5, "1.0", False), (11, "1.0", True)])
def test_brotli_parquet_equals_pyarrow(tmp_path, level, version, dictionary):
    table = fixtures.variant_table()
    path = str(tmp_path / "b.parquet")
    pq.write_table(table, path, compression="brotli", compression_level=level,
                   use_dictionary=dictionary, data_page_version=version, row_group_size=50,
                   data_page_size=1024)
    assert _rows(parquet_io.read_parquet(path)) == pq.read_table(path).to_pylist()


def test_committed_brotli_text_uses_the_static_dictionary(monkeypatch):
    """The level-11 text fixture's pages refer to the static dictionary:
    its words pass through the transforms."""
    words = []
    real = brotli._transform
    monkeypatch.setattr(brotli, "_transform", lambda w, t: words.append(t) or real(w, t))
    path = os.path.join(VARIANTS, "brotli_11_text.parquet")
    assert _rows(parquet_io.read_parquet(path)) == pq.read_table(path).to_pylist()
    assert len(words) > 10 and len(set(words)) > 1


# ---------------------------------------------------------------- temporal
@pytest.mark.parametrize("name", ["temporal_v1_dict.parquet", "temporal_v2_plain.parquet",
                                  "int96_dict.parquet", "int96_plain.parquet"])
def test_committed_temporal_files_equal_pyarrow(name):
    path = os.path.join(VARIANTS, name)
    want = pq.read_table(path).to_pylist()
    got = _rows(parquet_io.read_parquet(path))
    assert same(want, got)
    if name.startswith("int96"):  # INT96 reads as naive nanoseconds, whatever was written
        assert all(isinstance(r["ts_s"], (temporal.Timestamp, type(None))) for r in got)
        assert any(r["ts_ns"] is not None and r["ts_ns"].nanosecond for r in got)


@pytest.mark.parametrize("int96", [False, True])
def test_temporal_parquet_equals_datasets(tmp_path, int96, monkeypatch):
    """The rows ``datasets.load_dataset("parquet")`` gives (the JAX
    package's path), with its offline flags, under the rule."""
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", str(tmp_path / "cache"))
    path = str(tmp_path / "t.parquet")
    pq.write_table(fixtures.temporal_table(), path, use_deprecated_int96_timestamps=int96)
    want = [dict(r) for r in datasets.load_dataset("parquet", data_files=path, split="train")]
    assert same(want, _rows(parquet_io.read_parquet(path)))


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
def test_temporal_arrow_directory_equals_datasets(tmp_path, unit):
    """A ``save_to_disk`` directory with date32/date64, time32/time64 and
    timestamp columns (naive and zoned) read by ``arrow_io`` as
    ``datasets.load_from_disk`` gives it."""
    rng = np.random.default_rng(len(unit))
    n = 50
    span = 2 ** {"s": 33, "ms": 43, "us": 50, "ns": 60}[unit]  # within datetime's years
    ticks = [None if i % 7 == 3 else int(x) for i, x in enumerate(rng.integers(-span, span, n))]
    time_unit = "ms" if unit in ("s", "ms") else unit
    day = {"ms": 86400 * 10 ** 3, "us": 86400 * 10 ** 6, "ns": 86400 * 10 ** 9}[time_unit]
    table = pa.table({
        "ts": pa.array(ticks, pa.timestamp(unit)),
        "ts_zoned": pa.array(ticks[::-1], pa.timestamp(unit, "America/New_York")),
        "d32": pa.array([int(x) for x in rng.integers(-10000, 30000, n)], pa.date32()),
        "d64": pa.array([int(x) * 86400000 for x in rng.integers(-10000, 30000, n)],
                        pa.date64()),
        "t": pa.array([int(x) for x in rng.integers(0, day, n)],
                      pa.time32(time_unit) if time_unit == "ms" else pa.time64(time_unit)),
        "nested": pa.array([[v] if v is not None else None for v in ticks],
                           pa.list_(pa.timestamp(unit, "UTC")))})
    ds = datasets.Dataset(table)
    ds.save_to_disk(str(tmp_path / "ds"))
    want = [dict(r) for r in datasets.load_from_disk(str(tmp_path / "ds"))]
    assert same(want, _rows(arrow_io.load_from_disk(str(tmp_path / "ds"))))


def test_timestamp_keeps_its_nanoseconds():
    ts = temporal.timestamps([1_234_567_891_234_567_891, -1], "ns", "+05:30")
    assert [t.nanosecond for t in ts] == [891, 999]
    for t in ts:
        back = pickle.loads(pickle.dumps(t))
        assert back == t and back.nanosecond == t.nanosecond and back.tzinfo == t.tzinfo
    assert temporal.int96_nanoseconds(np.frombuffer(
        (5).to_bytes(8, "little") + (2_440_589).to_bytes(4, "little"), np.uint8)).tolist() == \
        [86_400_000_000_005]
    assert temporal.times([86399999999999], "ns") == [datetime.time(23, 59, 59, 999999)]
    assert json.dumps(fixtures._bytes_as_hex(ts[0]))  # digestible


def test_decimal_and_float16_stay_refused(tmp_path):
    import decimal

    path = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"x": pa.array([decimal.Decimal("1.50")], pa.decimal128(5, 2))}),
                   path)
    with pytest.raises(NotImplementedError, match="DECIMAL"):
        parquet_io.read_parquet(path)
