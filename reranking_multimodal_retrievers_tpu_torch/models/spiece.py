"""SentencePiece's ``spiece.model`` read and written without ``protobuf`` or
``sentencepiece``, and the Flan-T5 tokenizer built from it.

A ``spiece.model`` is a serialized ``sentencepiece.ModelProto`` (proto2).
:func:`read_spiece_model` walks its wire format by hand (varints, 32-bit
and length-delimited fields) and keeps what a Unigram tokenizer needs:

- ``pieces`` (field 1): each piece's text (1), score (2, a float) and type
  (3: 1 normal, 2 unknown, 3 control, 4 user defined, 5 unused, 6 byte);
- ``trainer_spec`` (2): ``model_type`` (3; 1 is Unigram), ``unk_id`` (40),
  ``byte_fallback`` (35);
- ``normalizer_spec`` (3): ``precompiled_charsmap`` (2),
  ``add_dummy_prefix`` (3), ``remove_extra_whitespaces`` (4).

Absent fields take proto2's declared defaults (``unk_id`` 0, the two
booleans true, ``model_type`` Unigram). Unknown fields are skipped.

:func:`tokenizer_from_spiece` builds the :class:`~.unigram.UnigramTokenizer`
that ``transformers``' ``T5Converter`` builds from the file (which is what
``AutoTokenizer`` gives for a T5 directory without ``tokenizer.json``): the
pieces and scores, then ``<extra_id_{n-1}>`` .. ``<extra_id_0>`` at score 0;
control and user-defined pieces as added tokens (control ones special); the
normalizer ``Precompiled`` (where the file has a charsmap), ``Strip`` on the
right, runs of two or more spaces replaced by ``▁``; ``Metaspace`` ``▁`` as
pre-tokenizer and decoder, the dummy prefix on every word (``always``;
``first`` where the tokenizer config sets ``legacy`` false, ``never`` where
it or the file turns the prefix off); ``</s>`` appended. The converter
ignores ``byte_fallback`` and ``remove_extra_whitespaces``, so does this.

:func:`write_spiece_model` writes such a file (the fields above only).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM = 1
T5_CLASSES = ("T5Tokenizer", "T5TokenizerFast")
SPIECE_UNDERLINE = "▁"


@dataclass
class SpieceModel:
    """What :func:`read_spiece_model` keeps of a ``ModelProto``."""
    pieces: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    model_type: int = UNIGRAM
    unk_id: int = 0
    byte_fallback: bool = False
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("spiece.model: truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("spiece.model: varint longer than 10 bytes")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a message: an int
    for varints, bytes for the rest."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"spiece.model: wire type {wire} (field {num}) is not read")
        if pos > len(buf):
            raise ValueError("spiece.model: truncated field")
        yield num, wire, value


def _int32(v: int) -> int:
    """A proto int32 from its varint (negatives are 10-byte two's complement)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def read_spiece_model(data: bytes) -> SpieceModel:
    """Parse a ``spiece.model``'s bytes (see the module docstring)."""
    m = SpieceModel()
    for num, wire, value in _fields(data):
        if num == 1 and wire == 2:
            text, score, kind = "", 0.0, NORMAL
            for n, w, v in _fields(value):
                if n == 1 and w == 2:
                    text = v.decode("utf-8")
                elif n == 2 and w == 5:
                    score = struct.unpack("<f", v)[0]
                elif n == 3 and w == 0:
                    kind = v
            m.pieces.append(text)
            m.scores.append(score)
            m.types.append(kind)
        elif num == 2 and wire == 2:
            for n, w, v in _fields(value):
                if w != 0:
                    continue
                if n == 3:
                    m.model_type = v
                elif n == 40:
                    m.unk_id = _int32(v)
                elif n == 35:
                    m.byte_fallback = bool(v)
        elif num == 3 and wire == 2:
            for n, w, v in _fields(value):
                if n == 2 and w == 2:
                    m.precompiled_charsmap = bytes(v)
                elif n == 3 and w == 0:
                    m.add_dummy_prefix = bool(v)
                elif n == 4 and w == 0:
                    m.remove_extra_whitespaces = bool(v)
    return m


def _put_varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _put(out: bytearray, num: int, value) -> None:
    """One field: an int as a varint, a float as 32 bits, bytes or str
    length-delimited."""
    if isinstance(value, bool) or isinstance(value, int):
        _put_varint(out, num << 3)
        _put_varint(out, int(value))
    elif isinstance(value, float):
        _put_varint(out, num << 3 | 5)
        out += struct.pack("<f", value)
    else:
        raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        _put_varint(out, num << 3 | 2)
        _put_varint(out, len(raw))
        out += raw


def write_spiece_model(path: str, pieces: Sequence[str], scores: Sequence[float],
                       types: Sequence[int], *, unk_id: int = 0,
                       precompiled_charsmap: Optional[bytes] = None,
                       add_dummy_prefix: bool = True, remove_extra_whitespaces: bool = True,
                       byte_fallback: bool = False) -> str:
    """Write a Unigram ``spiece.model`` with these pieces, scores and types
    and the ``trainer_spec``/``normalizer_spec`` fields this module reads.
    Returns ``path``."""
    if not len(pieces) == len(scores) == len(types):
        raise ValueError("one score and one type a piece")
    out = bytearray()
    for text, score, kind in zip(pieces, scores, types):
        piece = bytearray()
        _put(piece, 1, text)
        _put(piece, 2, float(score))
        if kind != NORMAL:
            _put(piece, 3, int(kind))
        _put(out, 1, piece)
    trainer = bytearray()
    _put(trainer, 3, UNIGRAM)
    _put(trainer, 4, len(pieces))
    if byte_fallback:
        _put(trainer, 35, True)
    _put(trainer, 40, unk_id)
    _put(out, 2, trainer)
    norm = bytearray()
    _put(norm, 1, "nmt_nfkc")
    if precompiled_charsmap:
        _put(norm, 2, precompiled_charsmap)
    _put(norm, 3, add_dummy_prefix)
    _put(norm, 4, remove_extra_whitespaces)
    _put(out, 3, norm)
    with open(path, "wb") as f:
        f.write(bytes(out))
    return path


def spiece_from_tokenizer_json(spec: dict, path: str) -> str:
    """Write the ``spiece.model`` a T5 ``tokenizer.json`` (a Unigram model,
    as :func:`~.unigram.write_unigram_tokenizer` writes one) was converted
    from: its vocabulary without the ``<extra_id_*>`` pieces the converter
    appends, ``<pad>`` and ``</s>`` as control pieces, the ``unk_id`` piece
    unknown, and the ``Precompiled`` normalizer's charsmap. Returns
    ``path``."""
    model = spec["model"]
    if model.get("type") != "Unigram":
        raise ValueError(f"model {model.get('type')!r}: a Unigram model is written")
    vocab = [(p, s) for p, s in model["vocab"] if not p.startswith("<extra_id_")]
    unk_id = model.get("unk_id", 0)
    types = [UNKNOWN if i == unk_id else CONTROL if p in ("<pad>", "</s>") else NORMAL
             for i, (p, _) in enumerate(vocab)]
    charsmap = None
    stack = [spec.get("normalizer") or {}]
    while stack:
        node = stack.pop()
        if node.get("type") == "Precompiled" and node.get("precompiled_charsmap"):
            charsmap = base64.b64decode(node["precompiled_charsmap"])
        stack.extend(node.get("normalizers") or [])
    return write_spiece_model(path, [p for p, _ in vocab], [s for _, s in vocab], types,
                              unk_id=unk_id, precompiled_charsmap=charsmap,
                              byte_fallback=bool(model.get("byte_fallback", False)))


def t5_spec_from_spiece(m: SpieceModel, config: Optional[dict] = None) -> dict:
    """The ``tokenizer.json`` spec ``T5Converter`` builds from ``m`` (see
    the module docstring); ``config`` is the directory's tokenizer config."""
    config = config or {}
    if m.model_type != UNIGRAM:
        raise NotImplementedError(f"spiece.model of model_type {m.model_type}: the port reads "
                                  "Unigram models (1)")
    extra = int(config.get("extra_ids", 100))
    vocab = [[p, s] for p, s in zip(m.pieces, m.scores)]
    vocab += [[f"<extra_id_{i}>", 0.0] for i in range(extra - 1, -1, -1)]
    added = [{"id": i, "content": p, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": t == CONTROL}
             for i, (p, t) in enumerate(zip(m.pieces, m.types)) if t in (CONTROL, USER_DEFINED)]
    norms = []
    if m.precompiled_charsmap:
        norms.append({"type": "Precompiled", "precompiled_charsmap":
                      base64.b64encode(m.precompiled_charsmap).decode("ascii")})
    norms += [{"type": "Strip", "strip_left": False, "strip_right": True},
              {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": SPIECE_UNDERLINE}]
    if not (m.add_dummy_prefix and config.get("add_prefix_space", True)):
        scheme = "never"
    else:
        scheme = "first" if config.get("legacy", True) is False else "always"
    metaspace = {"type": "Metaspace", "replacement": SPIECE_UNDERLINE,
                 "prepend_scheme": scheme, "split": True}
    eos = config.get("eos_token", "</s>")
    eos = eos.get("content") if isinstance(eos, dict) else eos
    ids = [i for i, p in enumerate(m.pieces) if p == eos]
    return {
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": norms},
        "pre_tokenizer": metaspace, "decoder": dict(metaspace),
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": eos, "type_id": 0}}],
            "special_tokens": {eos: {"id": eos, "ids": ids[:1], "tokens": [eos]}}},
        "model": {"type": "Unigram", "unk_id": m.unk_id, "vocab": vocab, "byte_fallback": False},
    }


def tokenizer_from_spiece(path: str):
    """The :class:`~.unigram.UnigramTokenizer` of a T5 tokenizer directory
    that holds ``spiece.model`` (and ``tokenizer_config.json`` and
    ``special_tokens_map.json`` where present; without them, T5's defaults:
    100 extra ids, ``</s>``, ``<unk>``, ``<pad>``). A config naming another
    tokenizer class raises ``NotImplementedError``."""
    from .unigram import UnigramTokenizer

    config: dict = {}
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            with open(p, encoding="utf-8") as f:
                config.update(json.load(f))
    cls = config.setdefault("tokenizer_class", "T5Tokenizer")
    if cls not in T5_CLASSES:
        raise NotImplementedError(f"tokenizer {path!r}: spiece.model with tokenizer_class "
                                  f"{cls!r}; the port builds T5's tokenizer from it")
    with open(os.path.join(path, "spiece.model"), "rb") as f:
        m = read_spiece_model(f.read())
    return UnigramTokenizer(t5_spec_from_spiece(m, config), config)
