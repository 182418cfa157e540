"""Read parquet files and HF hub snapshots of them without ``pyarrow``,
``datasets`` or PyYAML (the card's machine has none).

:func:`read_parquet` reads one file into a :class:`~.table.Table` with the
values ``pyarrow.parquet.read_table(path).to_pylist()`` gives: Python ints,
floats (a FLOAT column gives the Python floats of its float32 values),
bools, strings, bytes, lists, dicts (structs) and ``None`` for a null.

- The footer (``FileMetaData``) and the page headers are Thrift
  compact-protocol structs, parsed generically into ``{field id: value}``.
- Codecs: UNCOMPRESSED, SNAPPY (the raw block format, decoded here), GZIP
  (``zlib``), ZSTD (``zstd.py``), BROTLI (``brotli.py``), LZ4_RAW (the LZ4
  block format, decoded here) and LZ4 (read as parquet-cpp reads it:
  Hadoop's framing of LZ4 blocks, else one raw block). LZO, which
  ``pyarrow`` cannot read either, raises ``NotImplementedError`` naming the
  codec and the file.
- Pages: data page v1 (levels inside the compressed body, each behind a
  4-byte length), data page v2 (levels before the compressed part;
  ``is_compressed`` honoured) and dictionary pages.
- Encodings: PLAIN (every physical type), PLAIN_DICTIONARY and
  RLE_DICTIONARY, RLE for levels and booleans, DELTA_BINARY_PACKED (INT32,
  INT64), DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY (BYTE_ARRAY and
  FIXED_LEN_BYTE_ARRAY) and BYTE_STREAM_SPLIT (FLOAT, DOUBLE, INT32, INT64,
  FIXED_LEN_BYTE_ARRAY).
- Dates, times and timestamps (the DATE, TIME and TIMESTAMP logical types,
  their legacy converted types, and INT96, read as ``pyarrow`` reads it:
  naive ``timestamp[ns]``) become the values of ``temporal.py``: ``date``,
  ``time``, ``datetime`` in the time zone the footer's ``ARROW:schema``
  names (UTC where it names none and the column is adjusted to UTC), and
  for nanoseconds a ``datetime`` carrying them (``temporal.Timestamp``)
  where ``pyarrow`` gives a ``pandas.Timestamp``. DECIMAL, INTERVAL,
  FLOAT16 and the geometry types raise, naming the column.
- Records are assembled from the definition and repetition levels
  (Dremel): optional values, the 3-level ``LIST`` form and the legacy
  2-level forms, structs, lists of structs. Levels, dictionary gathers and
  the nullable columns' placement run in numpy; a PLAIN byte array's
  offsets come from one Python pass over its length prefixes.
- The ``huggingface`` key of the footer's key-value metadata carries the
  ``datasets`` features; a column whose feature is an ``Image`` is decoded
  as ``arrow_io`` decodes it (RGB arrays), and an ``Audio``, ``Video`` or
  ``Pdf`` raises as ``arrow_io`` raises.

:func:`load_parquet_snapshot` reads a directory laid out as a dataset repo
of the HF hub (M2KR's): the ``configs:`` list of its ``README.md`` YAML
front matter names each config's ``data_files`` (a string, a list of
globs, or a list of ``{split, path}``); without one, the config is a
sub-directory whose parquet files are named into splits by ``datasets``'
rule. Each split's shards are concatenated in sorted order.
"""

from __future__ import annotations

import json
import os
import re
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import brotli, temporal, zstd
from .arrow_io import _unreadable, arrow_schema_zones, decode_columns
from .table import Table, concatenate_tables

PAR1 = b"PAR1"
CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4",
          6: "ZSTD", 7: "LZ4_RAW"}
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
             8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
REQUIRED, OPTIONAL, REPEATED = range(3)
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
# ConvertedType values
_UTF8, _MAP, _MAP_KEY_VALUE, _LIST, _ENUM, _JSON = 0, 1, 2, 3, 4, 19
_UNSIGNED = {11: 8, 12: 16, 13: 32, 14: 64}  # UINT_8..UINT_64
_UNREAD_CONVERTED = {5: "DECIMAL", 21: "INTERVAL"}
# legacy converted types of dates, times and timestamps: (kind, unit); a
# converted timestamp is adjusted to UTC
_CONVERTED_TEMPORAL = {6: ("date", None), 7: ("time", "ms"), 8: ("time", "us"),
                       9: ("timestamp", "ms"), 10: ("timestamp", "us")}
# LogicalType union members that change a value's Python type and are not read
_LOGICAL_OTHER = {5: "DECIMAL", 15: "FLOAT16", 16: "VARIANT", 17: "GEOMETRY",
                  18: "GEOGRAPHY"}
_LOGICAL_DATE, _LOGICAL_TIME, _LOGICAL_TIMESTAMP = 6, 7, 8
_TIME_UNITS = {1: "ms", 2: "us", 3: "ns"}  # TimeUnit union members


# ------------------------------------------------------------------ thrift
class _Compact:
    """A reader of Thrift's compact protocol: a struct becomes ``{field id:
    value}``, a list a list, a binary ``bytes``."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf, self.pos = buf, pos

    def varint(self) -> int:
        out, shift, buf = 0, 0, self.buf
        while True:
            b = buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, t: int):
        if t in (1, 2):  # a bool as a list element: one byte
            self.pos += 1
            return self.buf[self.pos - 1] == 1
        if t == 3:
            self.pos += 1
            return struct.unpack_from("<b", self.buf, self.pos - 1)[0]
        if t in (4, 5, 6):
            return self.zigzag()
        if t == 7:
            self.pos += 8
            return struct.unpack_from("<d", self.buf, self.pos - 8)[0]
        if t == 8:
            n = self.varint()
            self.pos += n
            return self.buf[self.pos - n:self.pos]
        if t in (9, 10):
            head = self.buf[self.pos]
            self.pos += 1
            n = head >> 4 if head >> 4 != 15 else self.varint()
            return [self.value(head & 15) for _ in range(n)]
        if t == 11:
            n = self.varint()
            if not n:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            return {self.value(kv >> 4): self.value(kv & 15) for _ in range(n)}
        if t == 12:
            return self.struct()
        raise ValueError(f"thrift compact type {t} at byte {self.pos}")

    def struct(self) -> Dict[int, Any]:
        out, fid = {}, 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == 0:
                return out
            t, delta = head & 15, head >> 4
            fid = fid + delta if delta else self.zigzag()
            out[fid] = (t == 1) if t in (1, 2) else self.value(t)  # bools ride in the type


# ------------------------------------------------------------------ snappy
def snappy_decompress(data: bytes) -> bytes:
    """The raw snappy block format: a varint length, then literals and
    back-references (which may overlap their output)."""
    reader = _Compact(data)
    n = reader.varint()
    pos, end, o = reader.pos, len(data), 0
    out = bytearray()
    while pos < end:
        tag = data[pos]
        kind = tag & 3
        if kind == 0:
            ln = tag >> 2
            if ln < 60:
                pos += 1
            else:
                extra = ln - 59
                ln = int.from_bytes(data[pos + 1:pos + 1 + extra], "little")
                pos += 1 + extra
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
            o += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | data[pos + 1]
            pos += 2
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = data[pos + 1] | data[pos + 2] << 8
            pos += 3
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos + 1:pos + 5], "little")
            pos += 5
        if off == 0 or off > o:
            raise ValueError(f"snappy: a copy from offset {off} at output byte {o}")
        start = o - off
        if ln <= off:
            out += out[start:start + ln]
        else:
            out += (bytes(out[start:]) * (ln // off + 1))[:ln]
        o += ln
    if o != n:
        raise ValueError(f"snappy: {o} bytes decoded, the header says {n}")
    return bytes(out)


# ------------------------------------------------------------------ LZ4
def lz4_block(data: bytes) -> bytes:
    """The LZ4 block format: sequences of a token, literals and a 2-byte
    back-reference (which may overlap its output); the last sequence has
    literals only."""
    out = bytearray()
    pos, end = 0, len(data)
    while pos < end:
        token = data[pos]
        pos += 1
        ln = token >> 4
        if ln == 15:
            while True:
                b = data[pos]
                pos += 1
                ln += b
                if b != 255:
                    break
        if pos + ln > end:
            raise ValueError("lz4: literals run past the block")
        out += data[pos:pos + ln]
        pos += ln
        if pos == end:
            break
        if pos + 2 > end:
            raise ValueError("lz4: a block cut inside a match offset")
        off = data[pos] | data[pos + 1] << 8
        pos += 2
        ml = token & 15
        if ml == 15:
            while True:
                b = data[pos]
                pos += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        if off == 0 or off > len(out):
            raise ValueError(f"lz4: a match from offset {off} at output byte {len(out)}")
        start = len(out) - off
        if ml <= off:
            out += out[start:start + ml]
        else:
            out += (bytes(out[start:]) * (ml // off + 1))[:ml]
    return bytes(out)


def lz4_hadoop(data: bytes, size: int) -> bytes:
    """Parquet's LZ4 codec as parquet-cpp reads it: Hadoop's framing (blocks
    of a big-endian decompressed size, a big-endian compressed size and one
    LZ4 block) where the whole page parses so into ``size`` bytes; else the
    page is one raw LZ4 block (files of older parquet-cpp)."""
    out, pos = [], 0
    try:
        while len(data) - pos >= 8:
            n, c = struct.unpack_from(">II", data, pos)
            pos += 8
            if c > len(data) - pos or n > size - sum(map(len, out)):
                raise ValueError("not Hadoop's framing")
            block = lz4_block(data[pos:pos + c])
            if len(block) != n:
                raise ValueError("not Hadoop's framing")
            out.append(block)
            pos += c
        if pos == len(data):
            return b"".join(out)
    except (ValueError, IndexError):
        pass
    return lz4_block(data)


_READ_CODECS = (0, 1, 2, 4, 5, 6, 7)


def _check_codec(codec: int, path: str) -> None:
    if codec not in _READ_CODECS:
        raise NotImplementedError(
            f"{path}: the {CODECS.get(codec, codec)} codec is not read by this reader "
            f"({', '.join(CODECS[c] for c in _READ_CODECS)} are)")


def _decompress(codec: int, data: bytes, size: int) -> bytes:
    """A page's ``data`` in ``codec``, to its ``size`` uncompressed bytes."""
    if codec == 0 or not data:
        return data
    if codec == 1:
        return snappy_decompress(data)
    if codec == 2:
        return zlib.decompress(data, 47)
    if codec == 6:
        return zstd.decompress(data)
    if codec == 4:
        return brotli.decompress(data)
    if codec == 7:
        return lz4_block(data)
    return lz4_hadoop(data, size)


# ------------------------------------------------------------------ schema
class _Node:
    def __init__(self, el: Dict[int, Any], parent: Optional["_Node"]):
        self.name = el[4].decode("utf-8")
        self.ptype = el.get(1)
        self.type_length = el.get(2, 0)
        self.repetition = el.get(3, REQUIRED)
        self.converted = el.get(6)
        self.logical = el.get(10) or {}
        self.children: List[_Node] = []
        # the root holds no level; each optional or repeated field below it adds one
        self.path = parent.path + [self.name] if parent is not None else []
        self.max_def = parent.max_def + (self.repetition != REQUIRED) if parent is not None else 0
        self.max_rep = parent.max_rep + (self.repetition == REPEATED) if parent is not None else 0
        self.leaves: List[int] = []  # indices of the leaf columns under this node
        # the field's path in the Arrow schema, which names no list level
        self.in_list_group = parent is not None and parent.is_list
        skip = parent is not None and (parent.is_list or parent.in_list_group)
        self.arrow_key = (parent.arrow_key + (() if skip else (self.name,))
                          if parent is not None else ())
        self.tz: Optional[str] = None  # a timestamp's zone, from the ARROW:schema

    @property
    def is_list(self) -> bool:
        return self.converted == _LIST or 3 in self.logical

    @property
    def is_map(self) -> bool:
        return self.converted in (_MAP, _MAP_KEY_VALUE) or 2 in self.logical


def _schema(elements: List[Dict[int, Any]]) -> Tuple[_Node, List[_Node]]:
    """The schema tree (root first, depth first in the footer) and its
    leaves in column order."""
    leaves: List[_Node] = []
    pos = 0

    def build(parent):
        nonlocal pos
        el = elements[pos]
        pos += 1
        node = _Node(el, parent)
        for _ in range(el.get(5, 0) or 0):
            node.children.append(build(node))
        if not node.children and parent is not None:
            node.leaves = [len(leaves)]
            leaves.append(node)
        else:
            node.leaves = [i for c in node.children for i in c.leaves]
        return node

    return build(None), leaves


# --------------------------------------------------------------- encodings
def _unpack_bits(chunk: np.ndarray, width: int) -> np.ndarray:
    bits = np.unpackbits(chunk, bitorder="little")
    bits = bits[:len(bits) // width * width].reshape(-1, width).astype(np.int64)
    return bits @ (np.int64(1) << np.arange(width, dtype=np.int64))


def _hybrid(buf: bytes, pos: int, end: int, width: int, count: int) -> np.ndarray:
    """``count`` values of the RLE / bit-packed hybrid in ``buf[pos:end]``."""
    out = np.zeros(count, np.int64)
    if width == 0 or count == 0:
        return out
    reader, filled, nbytes = _Compact(buf, pos), 0, (width + 7) // 8
    while filled < count and reader.pos < end:
        header = reader.varint()
        if header & 1:
            size = (header >> 1) * width
            chunk = np.frombuffer(buf, np.uint8, size, reader.pos)
            reader.pos += size
            vals = _unpack_bits(chunk, width)
            take = min(len(vals), count - filled)
            out[filled:filled + take] = vals[:take]
        else:
            v = int.from_bytes(buf[reader.pos:reader.pos + nbytes], "little")
            reader.pos += nbytes
            take = min(header >> 1, count - filled)
            out[filled:filled + take] = v
        filled += take
    if filled < count:
        raise ValueError(f"RLE/bit-packed run ends after {filled} of {count} values")
    return out


def _levels(buf: bytes, pos: int, max_level: int, count: int) -> Tuple[np.ndarray, int]:
    """v1 levels: a 4-byte length, then the hybrid. Returns (levels, end)."""
    (n,) = struct.unpack_from("<I", buf, pos)
    width = int(max_level).bit_length()
    return _hybrid(buf, pos + 4, pos + 4 + n, width, count), pos + 4 + n


def _plain(leaf: _Node, buf: bytes, pos: int, n: int, where: str):
    """``n`` PLAIN values from ``buf[pos:]``: a numpy array for the fixed-width
    types, a list of ``bytes`` for the byte arrays."""
    t = leaf.ptype
    if t == BOOLEAN:
        return np.unpackbits(np.frombuffer(buf, np.uint8, (n + 7) // 8, pos),
                             bitorder="little")[:n].astype(bool)
    if t in (INT32, INT64, FLOAT, DOUBLE):
        dtype = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[t]
        return np.frombuffer(buf, dtype, n, pos)
    if t == BYTE_ARRAY:
        out, unpack = [], struct.unpack_from
        for _ in range(n):
            (ln,) = unpack("<I", buf, pos)
            out.append(buf[pos + 4:pos + 4 + ln])
            pos += 4 + ln
        return out
    if t == FIXED_LEN_BYTE_ARRAY:
        w = leaf.type_length
        return [buf[pos + i * w:pos + (i + 1) * w] for i in range(n)]
    return temporal.int96_nanoseconds(np.frombuffer(buf, np.uint8, 12 * n, pos))


def _temporal_kind(leaf: _Node) -> Optional[Tuple[str, Optional[str], Optional[str]]]:
    """(kind, unit, time zone) of a date, time or timestamp column, else None."""
    logical = leaf.logical
    if leaf.ptype == INT96:
        return "timestamp", "ns", None
    if _LOGICAL_DATE in logical:
        return "date", None, None
    for k, kind in ((_LOGICAL_TIME, "time"), (_LOGICAL_TIMESTAMP, "timestamp")):
        if k in logical:
            spec = logical[k]
            unit = _TIME_UNITS[next(iter(spec.get(2) or {1: {}}))]
            utc = kind == "timestamp" and spec.get(1, False)
            return kind, unit, (leaf.tz or "UTC") if utc else None
    if leaf.converted in _CONVERTED_TEMPORAL:
        kind, unit = _CONVERTED_TEMPORAL[leaf.converted]
        return kind, unit, (leaf.tz or "UTC") if kind == "timestamp" else None
    return None


def _python_values(leaf: _Node, vals, where: str) -> List[Any]:
    """PLAIN values as the Python values ``to_pylist`` gives for the
    column's logical type (dates, times and timestamps by the rule of
    ``temporal.py``)."""
    logical, conv = leaf.logical, leaf.converted
    other = [name for k, name in _LOGICAL_OTHER.items() if k in logical]
    if other or conv in _UNREAD_CONVERTED:
        raise NotImplementedError(f"{where}: logical type "
                                  f"{(other or [_UNREAD_CONVERTED.get(conv)])[0]}, which this "
                                  "reader does not take")
    kind = _temporal_kind(leaf)
    if kind is not None:
        what, unit, tz = kind
        if what == "date":
            return temporal.dates(vals.tolist())
        if what == "time":
            return temporal.times(vals.tolist(), unit)
        return temporal.timestamps(vals.tolist(), unit, tz)
    if leaf.ptype in (INT32, INT64):
        bits = _UNSIGNED.get(conv)
        if 10 in logical and logical[10].get(2) is False:
            bits = logical[10].get(1, 64)
        if bits:
            vals = vals.view("<u4" if leaf.ptype == INT32 else "<u8")
        return vals.tolist()
    if leaf.ptype == BYTE_ARRAY and (conv in (_UTF8, _ENUM, _JSON)
                                      or any(k in logical for k in (1, 4, 12))):
        return [v.decode("utf-8") for v in vals]
    if isinstance(vals, np.ndarray):
        return vals.tolist()
    return list(vals)


def _delta_binary_packed(buf: bytes, pos: int) -> Tuple[np.ndarray, int]:
    """DELTA_BINARY_PACKED values at ``pos`` as int64 (an INT32 column's
    wrap in 32 bits when cast) and the position after them: a header (block
    size, miniblocks a block, value count, first value), then blocks of a
    minimum delta, one bit width a miniblock and the bit-packed miniblocks
    (none past the last value)."""
    r = _Compact(buf, pos)
    block, minis, total, first = r.varint(), r.varint(), r.varint(), r.zigzag()
    per = block // minis if minis else 0
    if total and (block % 128 or not minis or per % 8):
        raise ValueError(f"DELTA_BINARY_PACKED: blocks of {block} values in {minis} miniblocks")
    deltas, left = [], max(total - 1, 0)
    while left > 0:
        min_delta = r.zigzag()
        widths = buf[r.pos:r.pos + minis]
        r.pos += minis
        for w in widths:
            if left <= 0:
                break
            size = per * w // 8
            d = (_unpack_bits(np.frombuffer(buf, np.uint8, size, r.pos), w) if w
                 else np.zeros(per, np.int64))
            r.pos += size
            take = min(per, left)
            deltas.append(d[:take] + np.int64(min_delta))
            left -= take
    out = np.empty(total, np.int64)
    if total:
        out[0] = first
        if deltas:
            np.cumsum(np.concatenate(deltas), out=out[1:])
            out[1:] += np.int64(first)
    return out, r.pos


def _delta_lengths(buf: bytes, pos: int, n: int) -> Tuple[List[bytes], int]:
    """DELTA_LENGTH_BYTE_ARRAY: the lengths, then the bytes one after the
    other."""
    lengths, pos = _delta_binary_packed(buf, pos)
    if len(lengths) < n:
        raise ValueError(f"DELTA_LENGTH_BYTE_ARRAY: {len(lengths)} lengths for {n} values")
    ends = (pos + np.cumsum(lengths[:n])).tolist()
    starts = [pos] + ends[:-1]
    return [buf[a:b] for a, b in zip(starts, ends)], (ends[-1] if n else pos)


def _dec_delta_int(leaf: _Node, buf: bytes, pos: int, n: int) -> np.ndarray:
    vals, _ = _delta_binary_packed(buf, pos)
    if len(vals) < n:
        raise ValueError(f"DELTA_BINARY_PACKED: {len(vals)} values for {n}")
    return vals[:n].astype("<i4" if leaf.ptype == INT32 else "<i8")


def _dec_delta_length(leaf: _Node, buf: bytes, pos: int, n: int) -> List[bytes]:
    return _delta_lengths(buf, pos, n)[0]


def _dec_delta_bytes(leaf: _Node, buf: bytes, pos: int, n: int) -> List[bytes]:
    """DELTA_BYTE_ARRAY: the prefix lengths, then the suffixes as
    DELTA_LENGTH_BYTE_ARRAY; each value is the previous one's prefix and its
    suffix."""
    prefixes, pos = _delta_binary_packed(buf, pos)
    suffixes, _ = _delta_lengths(buf, pos, n)
    out, prev = [], b""
    for k, suffix in zip(prefixes[:n].tolist(), suffixes):
        prev = prev[:k] + suffix
        out.append(prev)
    return out


def _dec_byte_stream_split(leaf: _Node, buf: bytes, pos: int, n: int):
    """BYTE_STREAM_SPLIT: byte k of every value in stream k."""
    w = {INT32: 4, INT64: 8, FLOAT: 4, DOUBLE: 8}.get(leaf.ptype, leaf.type_length)
    vals = np.frombuffer(buf, np.uint8, n * w, pos).reshape(w, n).T.copy()
    if leaf.ptype == FIXED_LEN_BYTE_ARRAY:
        return [v.tobytes() for v in vals]
    return vals.view({INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[leaf.ptype])[:, 0]


# encoding -> (decoder of n values at a position, the physical types it takes)
_DECODERS = {
    5: (_dec_delta_int, (INT32, INT64)),
    6: (_dec_delta_length, (BYTE_ARRAY,)),
    7: (_dec_delta_bytes, (BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY)),
    9: (_dec_byte_stream_split, (INT32, INT64, FLOAT, DOUBLE, FIXED_LEN_BYTE_ARRAY)),
}


# -------------------------------------------------------------------- pages
def _column_chunk(data: bytes, leaf: _Node, meta: Dict[int, Any], path: str):
    """(repetition levels, definition levels, Python values of the non-null
    entries) of one column chunk."""
    where = f"{path}: column {'.'.join(leaf.path)!r}"
    codec = meta[4]
    _check_codec(codec, path)
    start = meta[9]
    if meta.get(11) and 0 < meta[11] < start:
        start = meta[11]
    end = start + meta[7]
    total = meta[5]
    reps, defs, parts = [], [], []
    dictionary: Optional[np.ndarray] = None
    seen, pos = 0, start
    while seen < total and pos < end:
        reader = _Compact(data, pos)
        header = reader.struct()
        body_at, size = reader.pos, header[3]
        body = data[body_at:body_at + size]
        pos = body_at + size
        kind = header[1]
        if kind == DICTIONARY_PAGE:
            dh = header[7]
            raw = _decompress(codec, body, header[2])
            dictionary = np.empty(dh[1], object)
            dictionary[:] = _python_values(leaf, _plain(leaf, raw, 0, dh[1], where), where)
            continue
        if kind == DATA_PAGE:
            dh = header[5]
            n, encoding = dh[1], dh[2]
            raw = _decompress(codec, body, header[2])
            at = 0
            for level, max_level, store in ((dh.get(4), leaf.max_rep, reps),
                                            (dh.get(3), leaf.max_def, defs)):
                if max_level:
                    if level not in (None, 3):
                        raise NotImplementedError(f"{where}: {ENCODINGS.get(level, level)} "
                                                  "levels")
                    lv, at = _levels(raw, at, max_level, n)
                    store.append(lv)
                else:
                    store.append(np.zeros(n, np.int64))
        elif kind == DATA_PAGE_V2:
            dh = header[8]
            n, encoding = dh[1], dh[4]
            rl, dl = dh[6], dh[5]
            for off, ln, max_level, store in ((0, rl, leaf.max_rep, reps),
                                              (rl, dl, leaf.max_def, defs)):
                store.append(_hybrid(body, off, off + ln, int(max_level).bit_length(), n)
                             if max_level else np.zeros(n, np.int64))
            rest = body[rl + dl:]
            raw = _decompress(codec, rest, header[2] - rl - dl) if dh.get(7, True) else rest
            at = 0
        else:
            continue  # an index page
        seen += n
        present = int((defs[-1] == leaf.max_def).sum())
        if encoding in (2, 8):
            if dictionary is None:
                raise ValueError(f"{where}: a dictionary-encoded page before the dictionary")
            idx = _hybrid(raw, at + 1, len(raw), raw[at], present) if present else \
                np.zeros(0, np.int64)
            parts.append(dictionary[idx])
        elif encoding == 0:
            parts.append(_python_values(leaf, _plain(leaf, raw, at, present, where), where))
        elif encoding == 3 and leaf.ptype == BOOLEAN:
            (ln,) = struct.unpack_from("<I", raw, at)
            vals = _hybrid(raw, at + 4, at + 4 + ln, 1, present).astype(bool)
            parts.append(vals.tolist())
        elif encoding in _DECODERS and leaf.ptype in _DECODERS[encoding][1]:
            vals = _DECODERS[encoding][0](leaf, raw, at, present)
            parts.append(_python_values(leaf, vals, where))
        else:
            raise NotImplementedError(f"{where}: the {ENCODINGS.get(encoding, encoding)} "
                                      "encoding, which this reader does not take")
    values: List[Any] = []
    for p in parts:
        values += p.tolist() if isinstance(p, np.ndarray) else p
    cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64))
    return cat(reps), cat(defs), values


# ----------------------------------------------------------------- records
class _Leaf:
    def __init__(self, rep: np.ndarray, dfn: np.ndarray, values: List[Any], max_def: int):
        self.rep, self.dfn = rep.tolist(), dfn.tolist()
        self.values = values
        self.vpos = (np.cumsum(dfn == max_def) - 1).tolist()


def _elements(rep: _Node, ranges: Dict[int, Tuple[int, int]], cols: List[_Leaf]):
    """The entry ranges of each element of the repeated node ``rep`` within
    one instance of its parent."""
    first = rep.leaves[0]
    s0, _ = ranges[first]
    if cols[first].dfn[s0] < rep.max_def:
        return []
    split = {}
    for i in rep.leaves:
        s, e = ranges[i]
        r = cols[i].rep
        starts = [s] + [t for t in range(s + 1, e) if r[t] == rep.max_rep]
        split[i] = list(zip(starts, starts[1:] + [e]))
    return [{i: split[i][k] for i in rep.leaves} for k in range(len(split[first]))]


def _field(node: _Node, ranges, cols: List[_Leaf]):
    if node.repetition == REPEATED:
        return [_inner(node, er, cols) for er in _elements(node, ranges, cols)]
    if node.repetition == OPTIONAL:
        first = node.leaves[0]
        if cols[first].dfn[ranges[first][0]] < node.max_def:
            return None
    return _inner(node, ranges, cols)


def _inner(node: _Node, ranges, cols: List[_Leaf]):
    if not node.children:
        (i,) = node.leaves
        col = cols[i]
        return col.values[col.vpos[ranges[i][0]]]
    if node.is_map:
        raise NotImplementedError(f"column {'.'.join(node.path)!r} is a MAP, which this reader "
                                  "does not take")
    if node.is_list and len(node.children) == 1 and node.children[0].repetition == REPEATED:
        rep = node.children[0]
        elems = _elements(rep, ranges, cols)
        two_level = (not rep.children or len(rep.children) > 1 or rep.name == "array"
                     or rep.name == f"{node.name}_tuple")
        if two_level:
            return [_inner(rep, er, cols) for er in elems]
        return [_field(rep.children[0], er, cols) for er in elems]
    return {c.name: _field(c, {i: ranges[i] for i in c.leaves}, cols) for c in node.children}


def _flat_column(col: _Leaf, n: int, max_def: int) -> List[Any]:
    if max_def == 0:
        return col.values
    out = np.full(n, None, object)
    vals = np.empty(len(col.values), object)
    vals[:] = col.values
    out[np.asarray(col.dfn) == max_def] = vals
    return out.tolist()


def _assemble(root: _Node, cols: List[_Leaf]) -> Dict[str, List[Any]]:
    columns = {}
    for node in root.children:
        if not node.children and node.repetition != REPEATED:
            (i,) = node.leaves
            columns[node.name] = _flat_column(cols[i], len(cols[i].dfn), node.max_def)
            continue
        starts = {i: [t for t, r in enumerate(cols[i].rep) if r == 0] for i in node.leaves}
        bounds = {i: list(zip(s, s[1:] + [len(cols[i].rep)])) for i, s in starts.items()}
        first = node.leaves[0]
        columns[node.name] = [_field(node, {i: bounds[i][k] for i in node.leaves}, cols)
                              for k in range(len(bounds[first]))]
    return columns


# -------------------------------------------------------------------- files
def _footer(data: bytes, path: str) -> Dict[int, Any]:
    if len(data) < 12 or data[:4] != PAR1 or data[-4:] != PAR1:
        raise ValueError(f"{path}: not a parquet file (no PAR1 at both ends; an encrypted "
                         "footer is not read)")
    (n,) = struct.unpack_from("<I", data, len(data) - 8)
    return _Compact(data, len(data) - 8 - n).struct()


def read_parquet(path: str) -> Table:
    """One parquet file as a table; its row groups concatenated in order."""
    with open(path, "rb") as f:
        data = f.read()
    meta = _footer(data, path)
    kv = {e[1].decode("utf-8"): (e.get(2) or b"").decode("utf-8") for e in meta.get(5) or []}
    feats = {}
    if "huggingface" in kv:
        feats = json.loads(kv["huggingface"]).get("info", {}).get("features", {}) or {}
        for name, feat in feats.items():
            _unreadable(feat, name)
    root, leaves = _schema(meta[2])
    if "ARROW:schema" in kv:
        zones = arrow_schema_zones(kv["ARROW:schema"])
        for leaf in leaves:
            leaf.tz = zones.get(leaf.arrow_key)
    groups = []
    for rg in meta.get(4) or []:
        cols = []
        for leaf, chunk in zip(leaves, rg[1]):
            if chunk.get(1):
                raise NotImplementedError(f"{path}: a column chunk in another file "
                                          f"({chunk[1].decode()!r})")
            rep, dfn, values = _column_chunk(data, leaf, chunk[3], path)
            cols.append(_Leaf(rep, dfn, values, leaf.max_def))
        columns = _assemble(root, cols)
        decode_columns(columns, feats)
        groups.append(Table(columns))
    if not groups:
        return Table({c.name: [] for c in root.children})
    return groups[0] if len(groups) == 1 else concatenate_tables(groups)


# -------------------------------------------------------------------- YAML
def _scalar(text: str):
    t = text.strip()
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t[0] == t[-1] == '"' and len(t) > 1:
        return json.loads(t)
    if t[0] == t[-1] == "'" and len(t) > 1:
        return t[1:-1].replace("''", "'")
    if t[0] == "[" and t[-1] == "]":
        inner = t[1:-1].strip()
        return [_scalar(x) for x in _split_flow(inner)] if inner else []
    if t[0] == "{" and t[-1] == "}":
        inner = t[1:-1].strip()
        out = {}
        for item in (_split_flow(inner) if inner else []):
            k, _, v = item.partition(":")
            out[_scalar(k)] = _scalar(v)
        return out
    # YAML 1.1's resolvers, as PyYAML's safe loader applies them
    if t in ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"):
        return True
    if t in ("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"):
        return False
    if re.fullmatch(r"[-+]?(0|[1-9][0-9_]*)", t):
        return int(t.replace("_", ""))
    if re.fullmatch(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?", t) and t.strip("+-.") != "":
        return float(t.replace("_", ""))
    return t


def _split_flow(text: str) -> List[str]:
    out, depth, quote, cur = [], 0, None, ""
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(cur)
            cur = ""
            continue
        cur += ch
    out.append(cur)
    return [x.strip() for x in out]


def _key_value(text: str) -> Tuple[Optional[str], str]:
    """(key, rest) of a ``key: value`` line, or (None, text)."""
    m = re.match(r"""^("(?:[^"\\]|\\.)*"|'(?:[^']|'')*'|[^'"\s#][^:#]*?)\s*:(\s+|$)(.*)$""", text)
    if not m:
        return None, text
    return _scalar(m.group(1)), m.group(3)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def parse_yaml(text: str):
    """The block YAML that the hub writes in a README's front matter:
    nested mappings and sequences by indentation, plain, quoted and flow
    scalars. Anchors, tags and multi-line scalars are not taken."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    pos = 0

    def block(indent: int):
        nonlocal pos
        if pos >= len(lines):
            return None
        if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
            return sequence(lines[pos][0])
        return mapping(lines[pos][0])

    def sequence(indent: int):
        nonlocal pos
        out = []
        while pos < len(lines) and lines[pos][0] == indent and (
                lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
            rest = lines[pos][1][1:].strip()
            if not rest:
                pos += 1
                out.append(block(indent + 1) if pos < len(lines) and lines[pos][0] > indent
                           else None)
                continue
            nested = rest.startswith("- ") or rest == "-"
            key, value = (None, rest) if nested else _key_value(rest)
            if key is None and not nested:
                out.append(_scalar(rest))
                pos += 1
                continue
            # a mapping or sequence that starts on the dash's line, at its column
            inner = indent + len(lines[pos][1]) - len(rest)
            lines[pos] = (inner, rest)
            out.append(sequence(inner) if nested else mapping(inner))
        return out

    def mapping(indent: int):
        nonlocal pos
        out = {}
        while pos < len(lines) and lines[pos][0] == indent:
            key, value = _key_value(lines[pos][1])
            if key is None:
                raise ValueError(f"YAML: expected 'key: value', got {lines[pos][1]!r}")
            pos += 1
            if value.strip():
                out[key] = _scalar(value)
            elif pos < len(lines) and (lines[pos][0] > indent or (
                    lines[pos][0] == indent and lines[pos][1].startswith("-"))):
                out[key] = block(lines[pos][0])
            else:
                out[key] = None
        return out

    return block(0)


def front_matter(readme: str) -> dict:
    """The YAML front matter of a README (between the leading ``---``
    lines), parsed; ``{}`` if there is none."""
    m = re.match(r"^---[ \t]*\r?\n(.*?)\r?\n---[ \t]*(\r?\n|$)", readme, re.S)
    return (parse_yaml(m.group(1)) or {}) if m else {}


# ---------------------------------------------------------------- snapshots
_SPLIT_KEYWORDS = (("train", ("train", "training")),
                   ("validation", ("validation", "valid", "dev", "val")),
                   ("test", ("test", "testing", "eval", "evaluation")))
_SEP = "-._ 0123456789"
_SHARDED = re.compile(r"^data/([^/]+?)-[0-9]{5}-of-[0-9]{5}[^/]*\.[^/]*$")


def _parquet_files(base: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith((".", "__")))
        out += [os.path.relpath(os.path.join(dirpath, f), base).replace(os.sep, "/")
                for f in filenames if f.endswith(".parquet") and not f.startswith(".")]
    return sorted(out)


def _has_keyword(name: str, keyword: str, whole: bool) -> bool:
    """``name`` is ``keyword`` (``whole``), starts with it followed by a
    separator, or holds it between a separator and a separator or (for a
    directory) its end."""
    if whole and name == keyword:
        return True
    for m in re.finditer(re.escape(keyword), name):
        a, b = m.start(), m.end()
        before = a == 0 or name[a - 1] in _SEP
        after = (b < len(name) and name[b] in _SEP) or (whole and b == len(name) and a > 0)
        if before and after:
            return True
    return False


def infer_splits(files: Sequence[str]) -> Dict[str, List[str]]:
    """``datasets``' default naming of splits from file paths (relative,
    ``/``-separated): ``data/{split}-NNNNN-of-NNNNN.*`` shards; else the
    train/validation/test keywords in a directory name, then in a file name;
    else everything is ``train``."""
    sharded: Dict[str, List[str]] = {}
    for f in files:
        m = _SHARDED.match(f)
        if m:
            sharded.setdefault(m.group(1), []).append(f)
    if sharded:
        return sharded
    for in_dir in (True, False):
        found = {}
        for split, keywords in _SPLIT_KEYWORDS:
            hit = [f for f in files if any(
                _has_keyword(part, kw, in_dir)
                for part in (f.split("/")[:-1] if in_dir else f.split("/")[-1:])
                for kw in keywords)]
            if hit:
                found[split] = hit
        if found:
            return found
    return {"train": list(files)} if files else {}


def _glob(base: str, pattern: str) -> List[str]:
    """Files under ``base`` matching a hub ``data_files`` glob (``*`` within
    a path component, ``**`` across them)."""
    parts = []
    for piece in re.split(r"(\*\*/?|\*|\?|\[[^]]*\])", pattern.lstrip("/")):
        if piece.startswith("**"):
            parts.append("(?:.*/)?" if piece.endswith("/") else ".*")
        elif piece == "*":
            parts.append("[^/]*")
        elif piece == "?":
            parts.append("[^/]")
        elif piece.startswith("[") and piece.endswith("]") and len(piece) > 2:
            inner = piece[1:-1]
            parts.append("[" + ("^" + re.escape(inner[1:]) if inner[0] == "!" else
                                re.escape(inner)).replace("\\-", "-") + "]")
        else:
            parts.append(re.escape(piece))
    rx = re.compile("".join(parts) + r"\Z")
    return [f for f in _all_files(base) if rx.match(f)]


def _all_files(base: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("."))
        out += [os.path.relpath(os.path.join(dirpath, f), base).replace(os.sep, "/")
                for f in filenames if not f.startswith(".")]
    return sorted(out)


def _config_files(base: str, data_files) -> Dict[str, List[str]]:
    if isinstance(data_files, str):
        data_files = [data_files]
    if isinstance(data_files, dict):
        data_files = [{"split": k, "path": v} for k, v in data_files.items()]
    splits: Dict[str, List[str]] = {}
    for entry in data_files:
        split, paths = ("train", entry) if isinstance(entry, str) else (entry["split"],
                                                                          entry["path"])
        for pattern in [paths] if isinstance(paths, str) else paths:
            hits = _glob(base, pattern)
            if not hits:
                raise FileNotFoundError(f"{base}: no file matches {pattern!r} (split {split!r})")
            splits.setdefault(split, [])
            splits[split] += [h for h in hits if h not in splits[split]]
    return {k: sorted(v) for k, v in splits.items()}


def is_parquet_snapshot(path: str, config_name: Optional[str] = None) -> bool:
    """Whether ``path`` is a directory :func:`load_parquet_snapshot` reads:
    a README that declares ``configs``, or parquet files (under the
    ``config_name`` sub-directory, if one is given)."""
    if not os.path.isdir(path):
        return False
    readme = os.path.join(path, "README.md")
    if os.path.exists(readme):
        with open(readme, encoding="utf-8") as f:
            if front_matter(f.read()).get("configs"):
                return True
    base = os.path.join(path, config_name) if config_name else path
    return os.path.isdir(base) and bool(_parquet_files(base))


def load_parquet_snapshot(directory: str, config_name: Optional[str] = None) -> Dict[str, Table]:
    """A hub dataset repo on disk as ``{split: Table}`` for one config, as
    ``datasets.load_dataset(directory, config_name)`` gives it."""
    readme = os.path.join(directory, "README.md")
    configs = []
    if os.path.exists(readme):
        with open(readme, encoding="utf-8") as f:
            configs = front_matter(f.read()).get("configs") or []
    if configs:
        names = [c.get("config_name", "default") for c in configs]
        if config_name is None:
            pick = [c for c in configs if c.get("default")] or (
                configs if len(configs) == 1 else [c for c in configs
                                                   if c.get("config_name") == "default"])
            if len(pick) != 1:
                raise ValueError(f"{directory}: choose a config of {names}")
            config = pick[0]
        else:
            if config_name not in names:
                raise ValueError(f"{directory}: config {config_name!r} not found; the README "
                                 f"names {names}")
            config = configs[names.index(config_name)]
        base = os.path.join(directory, config.get("data_dir") or "")
        files = _config_files(base, config.get("data_files") or "**/*.parquet")
    else:
        base = os.path.join(directory, config_name) if config_name else directory
        if not os.path.isdir(base):
            raise FileNotFoundError(f"{directory}: no README configs and no sub-directory "
                                    f"{config_name!r}")
        files = infer_splits(_parquet_files(base))
    if not files:
        raise FileNotFoundError(f"{base}: no parquet files")
    return {split: concatenate_tables([read_parquet(os.path.join(base, f)) for f in fs])
            for split, fs in files.items()}
