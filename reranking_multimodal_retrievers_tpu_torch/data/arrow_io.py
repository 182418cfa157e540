"""Read and write HF ``datasets`` ``save_to_disk`` directories without
``datasets`` or ``pyarrow`` (the card's machine has neither).

A saved ``DatasetDict`` is a directory holding ``dataset_dict.json``
(``{"splits": [...]}``) and one subdirectory per split; a saved ``Dataset``
is one such subdirectory. A split holds ``state.json`` (its
``_data_files``, the shards in order), ``dataset_info.json`` (its
``features``) and the shards ``data-0000i-of-0000N.arrow``, each an Arrow
IPC *stream*: encapsulated messages (the continuation marker
``0xFFFFFFFF``, an int32 metadata length, a flatbuffer ``Message``, then
the message body), first a ``Schema``, then ``RecordBatch``es, then an
end-of-stream marker (``0xFFFFFFFF 0x00000000``).

:func:`load_from_disk` parses the flatbuffers itself and returns a dict
of :class:`~.table.Table` per split (or one table), with values as
``datasets`` gives them: Python ints, floats (a float32 column gives the
Python floats of its float32 values), bools, strings, bytes, lists,
dicts (structs) and ``None`` for a null. It takes null, bool, int8-64,
uint8-64, float16/32/64, string, large_string, binary, large_binary,
list and large_list (nested), struct and fixed_size_list columns,
date32/date64, time32/time64 and timestamp columns (as
``data/temporal.py`` gives them: ``pyarrow``'s values, a ``datetime``
carrying the nanoseconds where it gives a ``pandas.Timestamp``), several
record batches and several shards. A column whose feature is an
``Image`` (a ``{bytes, path}`` struct) gives RGB ``uint8 [H, W, 3]``
arrays, decoded by ``data/image_io.py`` from the bytes or, where they
are null, the path: what the JAX package gets from ``datasets`` after
``convert("RGB")``. It raises, naming the column, on a compressed body,
a dictionary-encoded column, any other Arrow type, and a column whose
feature is an ``Audio``, ``Video`` or ``Pdf``.

:func:`save_to_disk` writes tables in the same layout, with the Arrow types
``datasets.Dataset.from_dict`` infers for Python values (int64, double,
bool, string, binary, null, list, struct), so that
``datasets.load_from_disk`` reads them back equal.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from . import temporal
from .table import Table

CONTINUATION = b"\xff\xff\xff\xff"
METADATA_V5 = 4
SCHEMA, RECORD_BATCH = 1, 3  # MessageHeader union tags
# Type union tags of Schema.fbs
T_NULL, T_INT, T_FLOAT, T_BINARY, T_UTF8, T_BOOL = 1, 2, 3, 4, 5, 6
T_DATE, T_TIME, T_TIMESTAMP = 8, 9, 10
T_LIST, T_STRUCT, T_FIXED_SIZE_LIST = 12, 13, 16
T_LARGE_BINARY, T_LARGE_UTF8, T_LARGE_LIST = 19, 20, 21
_TYPE_NAMES = {7: "decimal", 11: "interval", 14: "union", 15: "fixed_size_binary", 17: "map",
               18: "duration", 22: "run_end_encoded", 23: "binary_view", 24: "utf8_view",
               25: "list_view", 26: "large_list_view"}
_FLOATS = {0: np.float16, 1: np.float32, 2: np.float64}
_UNREADABLE_FEATURES = ("Audio", "Video", "Pdf")
BATCH_ROWS = 1000  # rows a record batch, as datasets writes them


# ------------------------------------------------------------ flatbuffers
class _Table:
    """A view of one flatbuffer table: its fields by index, as the schema
    numbers them (a union takes two: its type tag, then its value)."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _field(self, i: int) -> int:
        o = 4 + 2 * i
        return struct.unpack_from("<H", self.buf, self.vt + o)[0] if o < self.vt_len else 0

    def scalar(self, i: int, fmt: str, default=0):
        o = self._field(i)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + o)[0] if o else default

    def _target(self, i: int) -> Optional[int]:
        o = self._field(i)
        if not o:
            return None
        at = self.pos + o
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, i: int) -> Optional["_Table"]:
        at = self._target(i)
        return None if at is None else _Table(self.buf, at)

    def string(self, i: int) -> Optional[str]:
        at = self._target(i)
        if at is None:
            return None
        (n,) = struct.unpack_from("<I", self.buf, at)
        return self.buf[at + 4:at + 4 + n].decode("utf-8")

    def _vector(self, i: int) -> Tuple[int, int]:
        at = self._target(i)
        if at is None:
            return 0, 0
        return at + 4, struct.unpack_from("<I", self.buf, at)[0]

    def tables(self, i: int) -> Optional[List["_Table"]]:
        if not self._field(i):
            return None
        start, n = self._vector(i)
        return [_Table(self.buf, start + 4 * k + struct.unpack_from("<I", self.buf, start + 4 * k)[0])
                for k in range(n)]

    def structs(self, i: int, fmt: str) -> List[tuple]:
        start, n = self._vector(i)
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, start + size * k) for k in range(n)]


def _root(buf: bytes) -> _Table:
    return _Table(buf, struct.unpack_from("<I", buf, 0)[0])


class _Builder:
    """Writes a flatbuffer front to back: a table's vtable, then the table,
    then (recursively) the objects its offsets point at, whose positions are
    patched in; every offset points forward, as the format requires.
    Scalars, tables and struct vectors are aligned to their own size in the
    buffer."""

    def __init__(self):
        self.buf = bytearray()

    def _pad(self, align: int, after: int = 0) -> None:
        while (len(self.buf) + after) % align:
            self.buf.append(0)

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def finish(self, root) -> bytes:
        self.buf += b"\0\0\0\0"
        self._patch(0, self.write(root))
        self._pad(8)
        return bytes(self.buf)

    def write(self, obj) -> int:
        kind = obj[0]
        if kind == "table":
            return self._table(obj[1])
        if kind == "string":
            data = obj[1].encode("utf-8")
            self._pad(4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
            return at
        if kind == "structs":  # ("structs", fmt, [tuples]) with 8-byte members
            fmt, rows = obj[1], obj[2]
            self._pad(8, after=4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(rows))
            for r in rows:
                self.buf += struct.pack("<" + fmt, *r)
            return at
        if kind == "vector":  # of tables or strings
            items = obj[1]
            self._pad(4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(items)) + b"\0\0\0\0" * len(items)
            for k, item in enumerate(items):
                self._patch(at + 4 + 4 * k, self.write(item))
            return at
        raise ValueError(kind)

    def _table(self, fields: Mapping[int, tuple]) -> int:
        """``fields``: {index: (fmt, value)} for scalars, {index: obj} for
        offsets."""
        objects = ("table", "string", "structs", "vector")
        scalars = [(i, v) for i, v in fields.items() if v[0] not in objects]
        offsets = [(i, v) for i, v in fields.items() if v[0] in objects]
        # inline layout after the 4-byte vtable offset: largest first
        layout = sorted(scalars, key=lambda iv: -struct.calcsize(iv[1][0]))
        pos, where = 4, {}
        for i, (fmt, _) in layout:
            size = struct.calcsize(fmt)
            pos += (-pos) % size
            where[i] = pos
            pos += size
        for i, _ in offsets:
            pos += (-pos) % 4
            where[i] = pos
            pos += 4
        align = max([4] + [struct.calcsize(v[0]) for _, v in scalars])
        size = pos + (-pos) % align
        n = max(fields) + 1 if fields else 0
        vtable = struct.pack(f"<HH{n}H", 4 + 2 * n, size, *[where.get(i, 0) for i in range(n)])
        self._pad(2)
        vt_at = len(self.buf)
        self.buf += vtable
        self._pad(align)
        at = len(self.buf)
        body = bytearray(size)
        struct.pack_into("<i", body, 0, at - vt_at)
        for i, (fmt, value) in scalars:
            struct.pack_into("<" + fmt, body, where[i], value)
        self.buf += body
        for i, obj in offsets:
            self._patch(at + where[i], self.write(obj))
        return at


# ---------------------------------------------------------------- schema
class Field:
    """An Arrow field: ``kind`` is one of null, bool, int, uint, float,
    utf8, large_utf8, binary, large_binary, list, large_list, struct,
    fixed_size_list, date, time, timestamp; ``width`` the bits of an
    int/float/date/time, or a fixed list's size; ``unit`` a time or
    timestamp's unit (s, ms, us, ns) and ``tz`` a timestamp's zone."""

    def __init__(self, name: str, kind: str, width: int = 0,
                 children: Sequence["Field"] = (), unit: str = "", tz: Optional[str] = None):
        self.name, self.kind, self.width, self.children = name, kind, width, list(children)
        self.unit, self.tz = unit, tz


def _parse_field(t: _Table, where: str) -> Field:
    name = t.string(0) or ""
    path = f"{where}.{name}" if where else name
    if t.table(4) is not None:
        raise NotImplementedError(f"column {path!r} is dictionary-encoded, which this reader "
                                  "does not take")
    tag, ty = t.scalar(2, "B"), t.table(3)
    children = [_parse_field(c, path) for c in (t.tables(5) or [])]
    simple = {T_NULL: "null", T_BOOL: "bool", T_UTF8: "utf8", T_LARGE_UTF8: "large_utf8",
              T_BINARY: "binary", T_LARGE_BINARY: "large_binary", T_LIST: "list",
              T_LARGE_LIST: "large_list", T_STRUCT: "struct"}
    if tag in simple:
        return Field(name, simple[tag], 0, children)
    if tag == T_INT:
        return Field(name, "int" if ty.scalar(1, "?", False) else "uint", ty.scalar(0, "i"))
    if tag == T_FLOAT:
        return Field(name, "float", {0: 16, 1: 32, 2: 64}[ty.scalar(0, "h")])
    if tag == T_FIXED_SIZE_LIST:
        return Field(name, "fixed_size_list", ty.scalar(0, "i"), children)
    if tag == T_DATE:  # DateUnit: DAY (date32) = 0, MILLISECOND (date64) = 1
        return Field(name, "date", 64 if ty.scalar(0, "h", 1) else 32)
    if tag == T_TIME:
        return Field(name, "time", ty.scalar(1, "i", 32),
                     unit=temporal.UNITS[ty.scalar(0, "h", 1)])
    if tag == T_TIMESTAMP:
        return Field(name, "timestamp", 64, unit=temporal.UNITS[ty.scalar(0, "h")],
                     tz=ty.string(1))
    raise NotImplementedError(f"column {path!r} has Arrow type "
                              f"{_TYPE_NAMES.get(tag, tag)!r}, which this reader does not take")


def arrow_schema_zones(encoded: str) -> Dict[Tuple[str, ...], str]:
    """The time zone of each zoned timestamp field of an ``ARROW:schema``
    (the base64 IPC schema message ``pyarrow`` writes into a parquet
    footer), by its path of field names (a list's element adds none)."""
    import base64

    raw = base64.b64decode(encoded)
    if raw[:4] == CONTINUATION:
        raw = raw[8:]
    msg = _root(raw)
    zones: Dict[Tuple[str, ...], str] = {}

    def walk(fields, key, named=True):
        for f in fields or []:
            tag = f.scalar(2, "B")
            here = key + (f.string(0) or "",) if named else key
            if tag == T_TIMESTAMP and f.table(3).string(1):
                zones[here] = f.table(3).string(1)
            walk(f.tables(5), here, tag not in (T_LIST, T_LARGE_LIST, T_FIXED_SIZE_LIST))

    if msg.scalar(1, "B") == SCHEMA:
        walk(msg.table(2).tables(1), ())
    return zones


def _parse_schema(t: _Table) -> Tuple[List[Field], Dict[str, str]]:
    fields = [_parse_field(f, "") for f in (t.tables(1) or [])]
    meta = {kv.string(0): kv.string(1) for kv in (t.tables(2) or [])}
    return fields, meta


# ---------------------------------------------------------------- reading
def _messages(data: bytes):
    """(message table, body bytes) of each message of an IPC stream."""
    pos = 0
    while pos + 8 <= len(data):
        if data[pos:pos + 4] != CONTINUATION:
            raise ValueError(f"no Arrow IPC message at byte {pos} (a pre-1.0 stream?)")
        (size,) = struct.unpack_from("<i", data, pos + 4)
        pos += 8
        if size == 0:
            return
        meta = data[pos:pos + size]
        pos += size
        msg = _root(meta)
        body_len = msg.scalar(3, "q")
        yield msg, data[pos:pos + body_len]
        pos += body_len


class _Batch:
    def __init__(self, body: bytes, nodes, buffers):
        self.body, self.nodes, self.buffers = body, iter(nodes), iter(buffers)

    def buffer(self) -> memoryview:
        off, n = next(self.buffers)
        return memoryview(self.body)[off:off + n]


def _validity(buf: memoryview, length: int, null_count: int) -> Optional[np.ndarray]:
    if null_count == 0 or len(buf) == 0:
        return None
    return np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")[:length].astype(bool)


def _with_nulls(values: List[Any], valid: Optional[np.ndarray]) -> List[Any]:
    if valid is None:
        return values
    return [v if ok else None for v, ok in zip(values, valid.tolist())]


def _read_array(f: Field, batch: _Batch) -> List[Any]:
    length, null_count = next(batch.nodes)
    if f.kind == "null":
        return [None] * length
    valid = _validity(batch.buffer(), length, null_count)
    if f.kind == "bool":
        bits = np.unpackbits(np.frombuffer(batch.buffer(), np.uint8), bitorder="little")
        return _with_nulls(bits[:length].astype(bool).tolist(), valid)
    if f.kind in ("int", "uint", "float"):
        dtype = (_FLOATS[{16: 0, 32: 1, 64: 2}[f.width]] if f.kind == "float"
                 else np.dtype(f"<{'i' if f.kind == 'int' else 'u'}{f.width // 8}"))
        return _with_nulls(np.frombuffer(batch.buffer(), dtype, length).tolist(), valid)
    if f.kind in ("utf8", "large_utf8", "binary", "large_binary", "list", "large_list"):
        wide = f.kind.startswith("large")
        offsets = np.frombuffer(batch.buffer(), "<i8" if wide else "<i4", length + 1).tolist()
        if f.kind.endswith("list"):
            child = _read_array(f.children[0], batch)
            values = [child[a:b] for a, b in zip(offsets[:-1], offsets[1:])]
        else:
            data = bytes(batch.buffer())
            values = [data[a:b] for a, b in zip(offsets[:-1], offsets[1:])]
            if f.kind.endswith("utf8"):
                values = [v.decode("utf-8") for v in values]
        return _with_nulls(values, valid)
    if f.kind in ("date", "time", "timestamp"):
        raw = np.frombuffer(batch.buffer(), f"<i{f.width // 8}", length)
        raw = (raw if valid is None else np.where(valid, raw, 0)).tolist()  # nulls hold anything
        if f.kind == "date":
            values = temporal.dates(raw) if f.width == 32 else temporal.dates_ms(raw)
        elif f.kind == "time":
            values = temporal.times(raw, f.unit)
        else:
            values = temporal.timestamps(raw, f.unit, f.tz)
        return _with_nulls(values, valid)
    if f.kind == "fixed_size_list":
        child, n = _read_array(f.children[0], batch), f.width
        return _with_nulls([child[i * n:(i + 1) * n] for i in range(length)], valid)
    if f.kind == "struct":
        cols = [(c.name, _read_array(c, batch)) for c in f.children]
        rows = [{name: col[i] for name, col in cols} for i in range(length)]
        return _with_nulls(rows, valid)
    raise AssertionError(f.kind)


def _unreadable(feature, path: str) -> None:
    """Raise on an ``Audio``/``Video``/``Pdf`` feature anywhere in ``feature``."""
    if isinstance(feature, dict):
        if feature.get("_type") in _UNREADABLE_FEATURES:
            raise NotImplementedError(
                f"column {path!r} is a datasets {feature['_type']} feature, which this reader "
                "does not decode")
        for k, v in feature.items():
            if k != "_type":
                _unreadable(v, path if k == "feature" else f"{path}.{k}")
    elif isinstance(feature, list):
        for v in feature:
            _unreadable(v, path)


def _has_image(feature) -> bool:
    if isinstance(feature, dict):
        return feature.get("_type") == "Image" or any(
            _has_image(v) for k, v in feature.items() if k != "_type")
    return isinstance(feature, list) and any(_has_image(v) for v in feature)


def _image_value(value: dict, path: str):
    """A stored ``Image`` (``{bytes, path}``) as RGB ``uint8 [H, W, 3]``:
    the bytes decoded, else the file at the path, as ``datasets`` reads it
    (then ``convert("RGB")``, as the JAX package's loaders do)."""
    from .image_io import decode_image, read_image

    if value.get("bytes") is not None:
        return decode_image(bytes(value["bytes"]), value.get("path") or path)
    where = value.get("path")
    if where is None:
        raise ValueError(f"column {path!r}: an image with neither bytes nor a path")
    if "://" in where:
        raise NotImplementedError(f"column {path!r}: image {where!r} needs the network")
    return read_image(where)


def decode_feature(feature, value, path: str):
    """``value`` as ``datasets`` gives a column of ``feature``: an ``Image``
    (``decode`` on) decoded, anywhere inside lists, sequences and structs;
    everything else as stored."""
    if value is None:
        return None
    if isinstance(feature, list):
        return [decode_feature(feature[0], v, path) for v in value]
    if not isinstance(feature, dict):
        return value
    kind = feature.get("_type")
    if kind == "Image":
        return _image_value(value, path) if feature.get("decode", True) else value
    if kind in ("Sequence", "List", "LargeList"):
        sub = feature.get("feature")
        if kind == "Sequence" and isinstance(sub, dict) and "_type" not in sub:
            # a Sequence of a struct is stored as a struct of lists
            return {k: decode_feature({"_type": "Sequence", "feature": f}, value.get(k),
                                      f"{path}.{k}") for k, f in sub.items()}
        return [decode_feature(sub, v, path) for v in value]
    if kind is None:  # a struct
        return {k: decode_feature(feature.get(k), v, f"{path}.{k}") for k, v in value.items()}
    return value


def decode_columns(columns: Dict[str, List[Any]], features: Mapping[str, Any]) -> None:
    """Decode in place every column whose feature holds an ``Image``."""
    for name, feat in features.items():
        if name in columns and _has_image(feat):
            columns[name] = [decode_feature(feat, v, name) for v in columns[name]]


def read_arrow_stream(path: str) -> Dict[str, List[Any]]:
    """The columns of one Arrow IPC stream file."""
    with open(path, "rb") as f:
        data = f.read()
    fields: Optional[List[Field]] = None
    meta: Dict[str, str] = {}
    columns: Dict[str, List[Any]] = {}
    for msg, body in _messages(data):
        tag, header = msg.scalar(1, "B"), msg.table(2)
        if tag == SCHEMA:
            fields, meta = _parse_schema(header)
            if "huggingface" in meta:
                feats = json.loads(meta["huggingface"]).get("info", {}).get("features", {})
                for name, feat in (feats or {}).items():
                    _unreadable(feat, name)
            columns = {f.name: [] for f in fields}
        elif tag == RECORD_BATCH:
            if fields is None:
                raise ValueError(f"{path}: a record batch before the schema")
            if header.table(3) is not None:
                raise NotImplementedError(f"{path}: the record batches are compressed, which "
                                          "this reader does not take")
            batch = _Batch(body, header.structs(1, "qq"), header.structs(2, "qq"))
            for f in fields:
                columns[f.name] += _read_array(f, batch)
        else:
            raise NotImplementedError(f"{path}: message type {tag} (a dictionary batch or a "
                                      "tensor), which this reader does not take")
    if fields is None:
        raise ValueError(f"{path}: no schema message")
    return columns


def _load_split(path: str) -> Table:
    with open(os.path.join(path, "state.json")) as f:
        state = json.load(f)
    info_path = os.path.join(path, "dataset_info.json")
    features: Dict[str, Any] = {}
    if os.path.exists(info_path):
        with open(info_path) as f:
            features = json.load(f).get("features") or {}
        for name, feat in features.items():
            _unreadable(feat, name)
    columns: Dict[str, List[Any]] = {}
    for entry in state["_data_files"]:
        cols = read_arrow_stream(os.path.join(path, entry["filename"]))
        if not columns:
            columns = cols
        elif list(cols) != list(columns):
            raise ValueError(f"{path}: shard {entry['filename']} has columns {list(cols)}, "
                             f"the first shard {list(columns)}")
        else:
            for k in columns:
                columns[k] += cols[k]
    decode_columns(columns, features)
    return Table(columns)


def is_saved_dataset(path: str) -> bool:
    """Whether ``path`` is a ``save_to_disk`` directory (of a DatasetDict or
    of one Dataset)."""
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "dataset_dict.json"))
        or os.path.exists(os.path.join(path, "state.json")))


def load_from_disk(path: str) -> Union[Dict[str, Table], Table]:
    """A ``save_to_disk`` directory: a dict of tables, one per split, for a
    ``DatasetDict``; a table for a ``Dataset``."""
    dd = os.path.join(path, "dataset_dict.json")
    if os.path.exists(dd):
        with open(dd) as f:
            splits = json.load(f)["splits"]
        return {s: _load_split(os.path.join(path, s)) for s in splits}
    if os.path.exists(os.path.join(path, "state.json")):
        return _load_split(path)
    raise FileNotFoundError(f"{path} holds neither dataset_dict.json nor state.json: not a "
                            "save_to_disk directory")


# ---------------------------------------------------------------- writing
def _infer(name: str, values: Sequence[Any]) -> Field:
    """The Arrow field ``datasets.Dataset.from_dict`` infers for Python
    values (pyarrow's inference)."""
    present = [v for v in values if v is not None]
    if not present:
        return Field(name, "null")
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        return Field(name, "bool")
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
           for v in present):
        return Field(name, "int", 64)
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in present):
        return Field(name, "float", 64)
    if all(isinstance(v, str) for v in present):
        return Field(name, "utf8")
    if all(isinstance(v, bytes) for v in present):
        return Field(name, "binary")
    if all(isinstance(v, (list, tuple)) for v in present):
        return Field(name, "list", 0, [_infer("item", [x for v in present for x in v])])
    if all(isinstance(v, dict) for v in present):
        keys = list(dict.fromkeys(k for v in present for k in v))
        return Field(name, "struct", 0, [_infer(k, [v.get(k) for v in present]) for k in keys])
    raise TypeError(f"column {name!r}: cannot store values of types "
                    f"{sorted({type(v).__name__ for v in present})} in one Arrow column")


def _type_object(f: Field) -> Tuple[int, tuple]:
    kinds = {"null": T_NULL, "bool": T_BOOL, "utf8": T_UTF8, "large_utf8": T_LARGE_UTF8,
             "binary": T_BINARY, "large_binary": T_LARGE_BINARY, "list": T_LIST,
             "large_list": T_LARGE_LIST, "struct": T_STRUCT}
    if f.kind in kinds:
        return kinds[f.kind], ("table", {})
    if f.kind in ("int", "uint"):
        return T_INT, ("table", {0: ("i", f.width), 1: ("?", f.kind == "int")})
    if f.kind == "float":
        return T_FLOAT, ("table", {0: ("h", {16: 0, 32: 1, 64: 2}[f.width])})
    if f.kind == "fixed_size_list":
        return T_FIXED_SIZE_LIST, ("table", {0: ("i", f.width)})
    raise ValueError(f.kind)


def _field_object(f: Field) -> tuple:
    tag, ty = _type_object(f)
    return ("table", {0: ("string", f.name), 1: ("?", True), 2: ("B", tag), 3: ty,
                      5: ("vector", [_field_object(c) for c in f.children])})


_VALUE_DTYPES = {("int", 8): "int8", ("int", 16): "int16", ("int", 32): "int32",
                 ("int", 64): "int64", ("uint", 8): "uint8", ("uint", 16): "uint16",
                 ("uint", 32): "uint32", ("uint", 64): "uint64", ("float", 16): "float16",
                 ("float", 32): "float32", ("float", 64): "float64"}


def feature_json(f: Field) -> dict:
    """The ``datasets`` feature of a field, as ``dataset_info.json`` holds it."""
    if f.kind in ("list", "large_list", "fixed_size_list"):
        out = {"feature": feature_json(f.children[0]), "_type": "List"}
        if f.kind == "fixed_size_list":
            out["length"] = f.width
        return out
    if f.kind == "struct":
        return {c.name: feature_json(c) for c in f.children}
    dtype = _VALUE_DTYPES.get((f.kind, f.width)) or {
        "null": "null", "bool": "bool", "utf8": "string", "large_utf8": "large_string",
        "binary": "binary", "large_binary": "large_binary"}[f.kind]
    return {"dtype": dtype, "_type": "Value"}


class _BodyWriter:
    def __init__(self):
        self.body = bytearray()
        self.nodes: List[Tuple[int, int]] = []
        self.buffers: List[Tuple[int, int]] = []

    def add(self, data: bytes) -> None:
        self.buffers.append((len(self.body), len(data)))
        self.body += data
        self.body += b"\0" * ((-len(self.body)) % 8)

    def validity(self, values: Sequence[Any]) -> None:
        nulls = sum(v is None for v in values)
        self.nodes.append((len(values), nulls))
        if nulls:
            bits = np.array([v is not None for v in values], bool)
            self.add(np.packbits(bits, bitorder="little").tobytes())
        else:
            self.add(b"")

    def array(self, f: Field, values: Sequence[Any]) -> None:
        if f.kind == "null":
            self.nodes.append((len(values), len(values)))
            return
        self.validity(values)
        if f.kind == "bool":
            self.add(np.packbits(np.array([bool(v) for v in values], bool),
                                 bitorder="little").tobytes())
        elif f.kind in ("int", "uint", "float"):
            dtype = (_FLOATS[{16: 0, 32: 1, 64: 2}[f.width]] if f.kind == "float"
                     else np.dtype(f"<{'i' if f.kind == 'int' else 'u'}{f.width // 8}"))
            self.add(np.array([0 if v is None else v for v in values], dtype).tobytes())
        elif f.kind in ("utf8", "large_utf8", "binary", "large_binary"):
            parts = [b"" if v is None else (v.encode("utf-8") if isinstance(v, str) else bytes(v))
                     for v in values]
            off = np.zeros(len(parts) + 1, np.int64)
            np.cumsum([len(p) for p in parts], out=off[1:])
            self.add(off.astype("<i8" if f.kind.startswith("large") else "<i4").tobytes())
            self.add(b"".join(parts))
        elif f.kind in ("list", "large_list"):
            items = [[] if v is None else list(v) for v in values]
            off = np.zeros(len(items) + 1, np.int64)
            np.cumsum([len(v) for v in items], out=off[1:])
            self.add(off.astype("<i8" if f.kind == "large_list" else "<i4").tobytes())
            self.array(f.children[0], [x for v in items for x in v])
        elif f.kind == "fixed_size_list":
            items = [[None] * f.width if v is None else list(v) for v in values]
            self.array(f.children[0], [x for v in items for x in v])
        elif f.kind == "struct":
            for c in f.children:
                self.array(c, [None if v is None else v.get(c.name) for v in values])
        else:
            raise ValueError(f.kind)


def _message(tag: int, header: tuple, body: bytes) -> bytes:
    meta = _Builder().finish(("table", {0: ("h", METADATA_V5), 1: ("B", tag), 2: header,
                                        3: ("q", len(body))}))
    return CONTINUATION + struct.pack("<i", len(meta)) + meta + body


def write_arrow_stream(path: str, table: Table, fields: Sequence[Field]) -> None:
    """``table`` as one Arrow IPC stream file of record batches of
    ``BATCH_ROWS`` rows, with the ``huggingface`` features in the schema's
    metadata, as ``datasets`` writes a shard."""
    features = {f.name: feature_json(f) for f in fields}
    hf_meta = json.dumps({"info": {"features": features}})
    schema = ("table", {1: ("vector", [_field_object(f) for f in fields]),
                        2: ("vector", [("table", {0: ("string", "huggingface"),
                                                  1: ("string", hf_meta)})])})
    cols = [table[f.name] for f in fields]
    tmp = path + ".tmp"
    with open(tmp, "wb") as out:
        out.write(_message(SCHEMA, schema, b""))
        for start in range(0, len(table), BATCH_ROWS):
            w = _BodyWriter()
            for f, col in zip(fields, cols):
                w.array(f, col[start:start + BATCH_ROWS])
            n = min(BATCH_ROWS, len(table) - start)
            header = ("table", {0: ("q", n), 1: ("structs", "qq", w.nodes),
                                2: ("structs", "qq", w.buffers)})
            out.write(_message(RECORD_BATCH, header, bytes(w.body)))
        out.write(CONTINUATION + b"\0\0\0\0")
    os.replace(tmp, path)


def _save_split(table: Table, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    fields = [_infer(name, table[name]) for name in table.column_names]
    name = "data-00000-of-00001.arrow"
    write_arrow_stream(os.path.join(path, name), table, fields)
    with open(os.path.join(path, name), "rb") as f:
        fingerprint = hashlib.sha256(f.read()).hexdigest()[:16]
    state = {"_data_files": [{"filename": name}], "_fingerprint": fingerprint,
             "_format_columns": None, "_format_kwargs": {}, "_format_type": None,
             "_output_all_columns": False, "_split": None}
    info = {"citation": "", "description": "",
            "features": {f.name: feature_json(f) for f in fields}, "homepage": "", "license": ""}
    for fname, obj in (("state.json", state), ("dataset_info.json", info)):
        with open(os.path.join(path, fname), "w") as f:
            json.dump(obj, f, indent=2)


def save_to_disk(data: Union[Mapping[str, Table], Table], path: str) -> None:
    """Write a dict of tables (a ``DatasetDict``) or one table (a
    ``Dataset``) as ``datasets.save_to_disk`` lays it out, each split in
    one shard."""
    os.makedirs(path, exist_ok=True)
    if isinstance(data, Table):
        _save_split(data, path)
        return
    for split, table in data.items():
        _save_split(table, os.path.join(path, split))
    with open(os.path.join(path, "dataset_dict.json"), "w") as f:
        json.dump({"splits": list(data)}, f)
