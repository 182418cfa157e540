"""A Unigram (SentencePiece-model) tokenizer read from a Hugging Face
``tokenizer.json``, in pure Python: the tokenizer of T5 and Flan-T5, which
the BLIP-2 captioner needs, where the JAX package calls
``transformers.AutoTokenizer`` (and so the ``tokenizers`` library).

:class:`UnigramTokenizer` reproduces what ``AutoTokenizer`` gives for a
directory holding ``tokenizer.json`` (plus ``tokenizer_config.json`` and
``special_tokens_map.json`` where present): the same ids, attention masks
and decoded strings. It implements the components a T5-family file holds,
each as ``tokenizers`` 0.22 runs it:

- model ``Unigram``: a Viterbi pass over the lattice of vocabulary pieces
  that start at each character (shortest first; a later candidate replaces
  an earlier one only with a strictly higher score), an unknown character
  scoring the minimum score less 10 where no one-character piece exists,
  consecutive unknowns fused into one ``unk_id``; ``byte_fallback`` spells
  an unknown run as ``<0xXX>`` pieces where the vocabulary has them all.
- normalizers ``Precompiled`` (SentencePiece's charsmap, walked as
  ``tokenizers`` walks it: by extended grapheme cluster, a cluster under 6
  bytes looked up whole by its shortest matching prefix, else character by
  character), ``Replace`` (String or Regex), ``NFC``/``NFD``/``NFKC``/
  ``NFKD``, ``Lowercase``, ``Strip``, ``Sequence``.
- pre-tokenizers ``WhitespaceSplit``, ``Metaspace`` (``prepend_scheme``
  ``always``/``first``/``never`` or the older ``add_prefix_space``;
  ``split``), ``Sequence``.
- post-processor ``TemplateProcessing`` (single sequences).
- decoders ``Metaspace``, ``ByteFallback``, ``Fuse``, ``Replace``,
  ``Strip``, ``Sequence``.
- added tokens, matched in the raw text (leftmost, longest) before
  normalization (an added token marked ``normalized`` raises).

Any other component raises ``NotImplementedError`` naming it. Grapheme
clusters follow UAX #29 over what ``unicodedata`` gives (Extend, ZWJ,
SpacingMark, Prepend, Control, CR LF, Hangul syllables by code-point
arithmetic, regional-indicator pairs); the emoji rule GB11 and the Indic
conjunct rule GB9c need properties ``unicodedata`` lacks and are not
applied.

:func:`write_precompiled_charsmap` builds a charsmap blob (a little-endian
``uint32`` trie size, a Darts-clone double array, then NUL-terminated
replacements) and :func:`write_unigram_tokenizer` a tokenizer directory in
the layout of Flan-T5's published files.
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

SPIECE_UNDERLINE = "▁"
UNK_PENALTY = 10.0  # an unknown character's score below the vocabulary's least
_PRECOMPILED_WHOLE_BELOW = 6  # bytes: a shorter grapheme cluster is looked up whole
# Rust's char::is_whitespace (the White_Space property), which WhitespaceSplit
# and Strip use; str.isspace() also takes U+001C-001F
_WHITESPACE = frozenset(chr(c) for c in (*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680,
                                          *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                                          0x205F, 0x3000))


# --- the charsmap: a Darts-clone double array --------------------------------

def _unit_offset(u: int) -> int:
    return (u >> 10) << ((u & (1 << 9)) >> 6)


def read_precompiled_charsmap(blob: bytes) -> Dict[str, str]:
    """Every key of a charsmap blob and its replacement: the trie walked
    from the root over every byte label, as ``tokenizers``'
    ``common_prefix_search`` would step through it."""
    (size,) = struct.unpack_from("<I", blob, 0)
    units = np.frombuffer(blob, "<u4", size // 4, 4).astype(np.int64)
    normalized = blob[4 + size:]
    labels = np.arange(1, 256, dtype=np.int64)
    out: Dict[str, str] = {}
    stack = [(b"", int(_unit_offset(int(units[0]))))]
    while stack:
        key, base = stack.pop()
        pos = base ^ labels
        inside = pos < len(units)
        pos, lab = pos[inside], labels[inside]
        hit = (units[pos] & ((1 << 31) | 0xFF)) == lab
        for c, p in zip(lab[hit].tolist(), pos[hit].tolist()):
            u = int(units[p])
            child, k = p ^ _unit_offset(u), key + bytes([c])
            if (u >> 8) & 1:
                v = int(units[child]) & ((1 << 31) - 1)
                end = normalized.find(b"\0", v)
                try:
                    out[k.decode("utf-8")] = normalized[v:end if end >= 0 else None].decode("utf-8")
                except UnicodeDecodeError:
                    pass  # a key or value no valid text reaches
            stack.append((k, child))
    return out


def write_precompiled_charsmap(mapping: Mapping[str, str]) -> bytes:
    """A charsmap blob (the ``precompiled_charsmap`` of a ``Precompiled``
    normalizer, before base64) mapping each key to its replacement."""
    norm = bytearray()
    root: dict = {}
    for src, dst in sorted(mapping.items()):
        if not src or "\0" in src:
            raise ValueError(f"charsmap key {src!r}: keys are non-empty, without NUL")
        node = root
        for b in src.encode("utf-8"):
            node = node.setdefault(b, {})
        node[-1] = len(norm)
        norm += dst.encode("utf-8") + b"\0"
    units: List[int] = [0]
    used, bases = {0}, set()
    queue = [(root, 0, 0)]  # node, its unit's position, the label that reached it
    first_free = 1
    while queue:
        node, pos, label = queue.pop(0)
        kids = sorted(k for k in node if k >= 0)
        need = ([0] if -1 in node else []) + kids
        while first_free in used:
            first_free += 1
        p = first_free
        while True:  # the first base whose slots are all free
            base = p ^ need[0]
            if base not in bases and base > 0 and all((base ^ c) not in used for c in need):
                break
            p += 1
        offset = pos ^ base
        if offset >= 1 << 21:
            raise ValueError("charsmap too large: a node offset needs more than 21 bits")
        bases.add(base)
        # every label of a base's block must index the array, as Darts pads it
        units += [0] * ((base | 0xFF) + 1 - len(units))
        units[pos] = label | ((-1 in node) << 8) | (offset << 10)
        if -1 in node:
            used.add(base)
            units[base] = node[-1] | (1 << 31)
        for c in kids:
            used.add(base ^ c)
            queue.append((node[c], base ^ c, c))
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + bytes(norm)


# --- extended grapheme clusters (UAX #29 over unicodedata) -------------------

(_OTHER, _CR, _LF, _CONTROL, _EXTEND, _ZWJ, _RI, _PREPEND, _SPACING,
 _L, _V, _T, _LV, _LVT) = range(14)
_OTHER_GRAPHEME_EXTEND = frozenset(
    [0x09BE, 0x09D7, 0x0B3E, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5, 0x0CD6, 0x0D3E, 0x0D57,
     0x0DCF, 0x0DDF, 0x1B35, 0x200C, 0x302E, 0x302F, 0xFF9E, 0xFF9F, 0x1133E, 0x11357,
     0x114B0, 0x114BD, 0x115AF, 0x11930, 0x1D165, *range(0x1D16E, 0x1D173),
     *range(0x1F3FB, 0x1F400), *range(0xE0020, 0xE0080)])
_PREPEND_CPS = frozenset(
    [*range(0x0600, 0x0606), 0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2, 0x0D4E, 0x110BD, 0x110CD,
     0x111C2, 0x111C3, 0x1193F, 0x11941, 0x11A3A, *range(0x11A84, 0x11A8A), 0x11D46, 0x11F02])
# Mc characters that are not SpacingMark, and two Lo that are
_NOT_SPACING = frozenset(
    [0x102B, 0x102C, 0x1038, 0x1062, 0x1063, 0x1064, *range(0x1067, 0x106E), 0x1083,
     *range(0x1087, 0x108D), 0x108F, 0x109A, 0x109B, 0x109C, 0x1A61, 0x1A63, 0x1A64, 0xAA7B,
     0xAA7D, 0x11720, 0x11721])
_gcb_cache: Dict[str, int] = {}


def _gcb(c: str) -> int:
    """The Grapheme_Cluster_Break class of one character."""
    got = _gcb_cache.get(c)
    if got is not None:
        return got
    cp = ord(c)
    cat = unicodedata.category(c)
    if cp == 0x0D:
        k = _CR
    elif cp == 0x0A:
        k = _LF
    elif cp == 0x200D:
        k = _ZWJ
    elif cp in _PREPEND_CPS:
        k = _PREPEND
    elif cat in ("Mn", "Me") or cp in _OTHER_GRAPHEME_EXTEND:
        k = _EXTEND
    elif cat in ("Cc", "Zl", "Zp", "Cf"):
        k = _CONTROL
    elif 0x1F1E6 <= cp <= 0x1F1FF:
        k = _RI
    elif (cat == "Mc" and cp not in _NOT_SPACING) or cp in (0x0E33, 0x0EB3):
        k = _SPACING
    elif 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        k = _L
    elif 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        k = _V
    elif 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        k = _T
    elif 0xAC00 <= cp <= 0xD7A3:
        k = _LV if (cp - 0xAC00) % 28 == 0 else _LVT
    else:
        k = _OTHER
    _gcb_cache[c] = k
    return k


def _joins(a: int, b: int, ri_run: int) -> bool:
    """Whether no boundary falls between classes ``a`` and ``b`` (GB3-GB13;
    ``ri_run``: regional indicators in a row up to and including ``a``)."""
    if a == _CR and b == _LF:
        return True
    if a in (_CONTROL, _CR, _LF) or b in (_CONTROL, _CR, _LF):
        return False
    if a == _L and b in (_L, _V, _LV, _LVT):
        return True
    if a in (_LV, _V) and b in (_V, _T):
        return True
    if a in (_LVT, _T) and b == _T:
        return True
    if b in (_EXTEND, _ZWJ, _SPACING) or a == _PREPEND:
        return True
    return a == _RI and b == _RI and ri_run % 2 == 1


def graphemes(text: str) -> List[str]:
    """``text`` split into extended grapheme clusters."""
    out: List[str] = []
    start, prev, ri_run = 0, None, 0
    for i, c in enumerate(text):
        k = _gcb(c)
        if prev is not None and not _joins(prev, k, ri_run):
            out.append(text[start:i])
            start = i
        ri_run = ri_run + 1 if k == _RI else 0
        prev = k
    if start < len(text):
        out.append(text[start:])
    return out


# --- normalizers ------------------------------------------------------------

class _Precompiled:
    def __init__(self, blob: bytes):
        self.map = read_precompiled_charsmap(blob)
        self.longest = max((len(k) for k in self.map), default=0)
        self.first_chars = frozenset(k[0] for k in self.map)

    def _lookup(self, chunk: str) -> Optional[str]:
        # tokenizers takes the first (shortest) of the trie's prefix matches
        if chunk[0] not in self.first_chars:
            return None
        for n in range(1, min(len(chunk), self.longest) + 1):
            got = self.map.get(chunk[:n])
            if got is not None:
                return got
        return None

    def __call__(self, text: str) -> str:
        if text.isascii() and self.first_chars.isdisjoint(text):
            return text
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < _PRECOMPILED_WHOLE_BELOW:
                got = self._lookup(g)
                if got is not None:
                    out.append(got)
                    continue
            for c in g:
                got = self.map.get(c)
                out.append(c if got is None else got)
        return "".join(out)


def _pattern(spec: dict) -> "re.Pattern":
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return re.compile(spec["Regex"])
    raise NotImplementedError(f"pattern {spec!r}")


def _strip(text: str, left: bool, right: bool) -> str:
    a, b = 0, len(text)
    while left and a < b and text[a] in _WHITESPACE:
        a += 1
    while right and b > a and text[b - 1] in _WHITESPACE:
        b -= 1
    return text[a:b]


def _normalizer(spec: Optional[dict]):
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def run(s):
            for p in parts:
                s = p(s)
            return s
        return run
    if kind == "Precompiled":
        blob = spec.get("precompiled_charsmap")
        if not blob:
            return lambda s: s
        return _Precompiled(base64.b64decode(blob))
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.sub(lambda m: content, s)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return lambda s: "".join(c.lower() for c in s)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)
        return lambda s: _strip(s, left, right)
    raise NotImplementedError(f"normalizer {kind!r} is not implemented")


# --- pre-tokenizers: a word is (text, whether it starts the original text) ---

def _prepend_scheme(spec: dict) -> str:
    if "prepend_scheme" in spec:
        return spec["prepend_scheme"]
    return "always" if spec.get("add_prefix_space", True) else "never"


def _pre_tokenizer(spec: Optional[dict]):
    if spec is None:
        return lambda words: words
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(words):
            for p in parts:
                words = p(words)
            return words
        return run
    if kind == "WhitespaceSplit":
        def split_ws(words):
            out = []
            for text, first in words:
                start = None
                for i, c in enumerate(text + " "):
                    if c in _WHITESPACE or i == len(text):
                        if start is not None:
                            out.append((text[start:i], first and start == 0))
                            start = None
                    elif start is None:
                        start = i
            return out
        return split_ws
    if kind == "Metaspace":
        rep = spec.get("replacement", SPIECE_UNDERLINE)
        scheme, split = _prepend_scheme(spec), spec.get("split", True)

        def metaspace(words):
            out = []
            for text, first in words:
                text = text.replace(" ", rep)
                if (scheme == "always" or (scheme == "first" and first)) and \
                        not text.startswith(rep):
                    text = rep + text
                if not split:
                    out.append((text, first))
                    continue
                start = 0
                for i in range(1, len(text)):
                    if text[i] == rep:
                        out.append((text[start:i], first and start == 0))
                        start = i
                if text:
                    out.append((text[start:], first and start == 0))
            return out
        return metaspace
    raise NotImplementedError(f"pre-tokenizer {kind!r} is not implemented")


# --- decoders ---------------------------------------------------------------

_BYTE_PIECE = re.compile(r"<0x([0-9A-Fa-f]{2})>")


def _decoder(spec: Optional[dict]):
    """A ``decode_chain``: tokens in, tokens out."""
    if spec is None:
        return lambda toks: [" ".join(toks)]
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_decoder(s) for s in spec["decoders"]]

        def run(toks):
            for p in parts:
                toks = p(toks)
            return toks
        return run
    if kind == "Metaspace":
        rep = spec.get("replacement", SPIECE_UNDERLINE)
        scheme = _prepend_scheme(spec)
        return lambda toks: [t.replace(rep, "" if i == 0 and scheme != "never" else " ")
                             for i, t in enumerate(toks)]
    if kind == "ByteFallback":
        def byte_fallback(toks):
            out, run = [], bytearray()

            def flush():
                if run:
                    try:
                        out.append(run.decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend(["�"] * len(run))
                    run.clear()
            for t in toks:
                m = _BYTE_PIECE.fullmatch(t) if len(t) == 6 else None
                if m:
                    run.append(int(m.group(1), 16))
                else:
                    flush()
                    out.append(t)
            flush()
            return out
        return byte_fallback
    if kind == "Fuse":
        return lambda toks: ["".join(toks)]
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda toks: [pat.sub(lambda m: content, t) for t in toks]
    if kind == "Strip":
        ch, start, stop = spec["content"], spec.get("start", 0), spec.get("stop", 0)

        def strip(toks):
            out = []
            for t in toks:
                a, b = 0, len(t)
                while a < min(start, b) and t[a] == ch:
                    a += 1
                n = 0
                while n < stop and b > a and t[b - 1] == ch:
                    b -= 1
                    n += 1
                out.append(t[a:b])
            return out
        return strip
    raise NotImplementedError(f"decoder {kind!r} is not implemented")


# --- the tokenizer ----------------------------------------------------------

_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
            (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))
_SPECIAL_NAMES = ("eos_token", "unk_token", "pad_token", "bos_token", "sep_token", "cls_token",
                  "mask_token")
_T5_CLASSES = ("T5Tokenizer", "T5TokenizerFast")


def _content(value):
    return value.get("content") if isinstance(value, dict) else value


class UnigramTokenizer:
    """The tokenizer of an HF ``tokenizer.json`` whose model is ``Unigram``,
    with the calls of ``PreTrainedTokenizerFast`` that the captioner makes.
    ``spec`` is the parsed ``tokenizer.json``; ``config`` the directory's
    ``tokenizer_config.json`` merged with ``special_tokens_map.json``."""

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = dict(config or {})
        model = spec.get("model") or {}
        if model.get("type") != "Unigram":
            raise NotImplementedError(f"model {model.get('type')!r}: only Unigram is read")
        vocab = model["vocab"]
        self.pieces = [p for p, _ in vocab]
        self.scores = [float(s) for _, s in vocab]
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        self.model_unk_id = model.get("unk_id")
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.min_score = min(self.scores) if self.scores else 0.0
        self._prefixes = {p[:n] for p in self.pieces for n in range(1, len(p) + 1)}
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode_chain = _decoder(spec.get("decoder"))
        self._template = self._post_processor(spec.get("post_processor"))
        # added tokens: tokenizer.json's, then the config's, then the specials
        self.added: Dict[str, int] = {}
        self.special: set = set()
        for t in spec.get("added_tokens") or []:
            self._add(t["content"], t["id"], t.get("special", False), t.get("normalized", False),
                      t)
        for i, t in sorted((config.get("added_tokens_decoder") or {}).items(),
                           key=lambda kv: int(kv[0])):
            self._add(t["content"], int(i), t.get("special", False),
                      t.get("normalized", not t.get("special", False)), t)
        extra = [_content(t) for t in config.get("additional_special_tokens") or []]
        if config.get("tokenizer_class") in _T5_CLASSES and \
                not any("<extra_id_" in t for t in extra):
            extra += [f"<extra_id_{i}>" for i in range(config.get("extra_ids", 100))]
        defaults = ({"eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>"}
                    if config.get("tokenizer_class") in _T5_CLASSES else {})
        for name in _SPECIAL_NAMES:
            setattr(self, name, _content(config.get(name, defaults.get(name))))
        for t in [getattr(self, n) for n in _SPECIAL_NAMES] + extra:
            if t is not None:
                self._add(t, None, True, False, {})
        self.additional_special_tokens = extra
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces",
                                                            False))
        self.id_to_added = {i: t for t, i in self.added.items()}
        by_length = sorted(self.added, key=len, reverse=True)
        self._added_re = (re.compile("|".join(map(re.escape, by_length))) if by_length
                          else None)
        self._cache: Dict[str, List[int]] = {}

    def _add(self, content: str, i: Optional[int], special: bool, normalized: bool,
             flags: dict) -> None:
        unsupported = [f for f in ("single_word", "lstrip", "rstrip") if flags.get(f)]
        if normalized:
            unsupported.append("normalized")
        if unsupported:
            raise NotImplementedError(f"added token {content!r}: {', '.join(unsupported)} "
                                      "not implemented")
        if content not in self.added:
            if i is None:
                i = self.piece_to_id.get(content)
            if i is None:
                i = max([len(self.pieces) - 1, *self.added.values()]) + 1
            self.added[content] = i
        if special:
            self.special.add(content)

    @staticmethod
    def _post_processor(spec: Optional[dict]):
        if spec is None:
            return None
        if spec.get("type") != "TemplateProcessing":
            raise NotImplementedError(f"post-processor {spec.get('type')!r} is not implemented")
        template = []
        for item in spec["single"]:
            if "Sequence" in item:
                template.append(None)
            else:
                template.extend(spec["special_tokens"][item["SpecialToken"]["id"]]["ids"])
        return template

    @classmethod
    def from_pretrained(cls, path: str) -> "UnigramTokenizer":
        """From a directory holding ``tokenizer.json``, with its
        ``tokenizer_config.json`` and ``special_tokens_map.json`` where
        present (the special tokens map wins, as ``transformers`` reads it)."""
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config: dict = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    config.update(json.load(f))
        return cls(spec, config)

    # ------------------------------------------------------------- ids
    def __len__(self) -> int:
        return max([len(self.pieces) - 1, *self.added.values()]) + 1

    def _token_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        i = self.added.get(token)
        return self.piece_to_id.get(token) if i is None else i

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._token_id(self.eos_token)

    @property
    def pad_token_id(self) -> Optional[int]:
        return self._token_id(self.pad_token)

    @property
    def unk_token_id(self) -> Optional[int]:
        return self._token_id(self.unk_token)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            i = self._token_id(tokens)
            return self.unk_token_id if i is None else i
        return [self.convert_tokens_to_ids(t) for t in tokens]

    def _id_to_token(self, i: int) -> Optional[str]:
        t = self.id_to_added.get(i)
        if t is None and 0 <= i < len(self.pieces):
            t = self.pieces[i]
        return t

    def convert_ids_to_tokens(self, ids, skip_special_tokens: bool = False):
        if isinstance(ids, (int, np.integer)):
            return self._id_to_token(int(ids))
        toks = [self._id_to_token(int(i)) for i in ids]
        return [t for t in toks if t is not None
                and not (skip_special_tokens and t in self.special)]

    # ------------------------------------------------------------- model
    def _viterbi(self, word: str) -> List[str]:
        """The best segmentation of ``word`` into pieces (unknowns fused)."""
        n = len(word)
        unk_score = self.min_score - UNK_PENALTY
        best = [0.0] * (n + 1)
        start_of: List[Optional[int]] = [None] * (n + 1)
        is_unk = [False] * (n + 1)
        for s in range(n):
            here = best[s]
            single = False
            for e in range(s + 1, n + 1):
                piece = word[s:e]
                if piece not in self._prefixes:
                    break
                i = self.piece_to_id.get(piece)
                if i is None:
                    continue
                score = self.scores[i] + here
                if start_of[e] is None or score > best[e]:
                    best[e], start_of[e], is_unk[e] = score, s, i == self.model_unk_id
                if e == s + 1:
                    single = True
            if not single:
                score = unk_score + here
                if start_of[s + 1] is None or score > best[s + 1]:
                    best[s + 1], start_of[s + 1], is_unk[s + 1] = score, s, True
        out: List[str] = []
        fused: List[str] = []
        e = n
        while e > 0:
            s = start_of[e]
            if is_unk[e] and self.model_unk_id is not None:
                fused.append(word[s:e])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(word[s:e])
            e = s
        if fused:
            out.append("".join(reversed(fused)))
        return out[::-1]

    def _model_ids(self, word: str) -> List[int]:
        got = self._cache.get(word)
        if got is not None:
            return got
        ids: List[int] = []
        for piece in self._viterbi(word):
            i = self.piece_to_id.get(piece)
            if i is None:
                if self.byte_fallback:
                    spelled = [self.piece_to_id.get(f"<0x{b:02X}>") for b in piece.encode("utf-8")]
                    if None not in spelled:
                        ids.extend(spelled)
                        continue
                if self.model_unk_id is None:
                    raise ValueError(f"{piece!r} is not in the vocabulary and there is no unk_id")
                i = self.model_unk_id
            ids.append(i)
        if len(self._cache) < 100_000:
            self._cache[word] = ids
        return ids

    # ------------------------------------------------------------- encode
    def _split_added(self, text: str, pattern) -> List[Tuple[str, Optional[int], int]]:
        """``text`` as (piece, added-token id or None, start) in order."""
        if pattern is None:
            return [(text, None, 0)]
        out, at = [], 0
        for m in pattern.finditer(text):
            if m.start() > at:
                out.append((text[at:m.start()], None, at))
            out.append((m.group(), self.added[m.group()], m.start()))
            at = m.end()
        if at < len(text):
            out.append((text[at:], None, at))
        return out

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for seg, added, at in self._split_added(text, self._added_re):
            if added is not None:
                ids.append(added)
                continue
            norm = self._normalize(seg)
            if not norm:  # an empty piece reaches no pre-tokenizer
                continue
            for word, _ in self._pre_tokenize([(norm, at == 0)]):
                if word:
                    ids.extend(self._model_ids(word))
        return ids

    def tokenize(self, text: str) -> List[str]:
        return self.convert_ids_to_tokens(self._encode_text(text))

    def encode(self, text: str, add_special_tokens: bool = True, truncation: bool = False,
               max_length: Optional[int] = None) -> List[int]:
        ids = self._encode_text(text)
        template = self._template if add_special_tokens else None
        if truncation and max_length is not None:
            extra = len(template) - 1 if template else 0
            if max_length < extra:
                raise ValueError(f"max_length {max_length} leaves no room for the template's "
                                 f"{extra} special tokens")
            ids = ids[:max_length - extra]
        if template:
            ids = [t for slot in template for t in (ids if slot is None else [slot])]
        return ids

    def __call__(self, text, padding=False, truncation=None, max_length: Optional[int] = None,
                 return_tensors: Optional[str] = None, add_special_tokens: bool = True,
                 **unused):
        """Encode a string or a list of strings, as ``PreTrainedTokenizerFast``
        does: ``padding`` ``"max_length"``, True/``"longest"`` or False (on
        the right, with the pad id); ``truncation`` True/``"longest_first"``
        (to ``max_length``, keeping the template's room); ``return_tensors``
        ``"np"`` (int64 arrays) or None (lists)."""
        if unused.get("text_pair") is not None:
            raise NotImplementedError("pairs are not implemented")
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        if truncation is None:  # HF truncates only when max_length comes without padding
            truncation = max_length is not None and not padding
        if truncation not in (False, True, "longest_first", "do_not_truncate"):
            raise ValueError(f"truncation {truncation!r} is not supported")
        trunc = truncation not in (False, "do_not_truncate")
        encs = [self.encode(t, add_special_tokens, trunc, max_length) for t in texts]
        if padding in (True, "longest"):
            target = max((len(e) for e in encs), default=0)
        elif padding == "max_length":
            target = max_length
        elif padding in (False, None, "do_not_pad"):
            target = None
        else:
            raise ValueError(f"padding {padding!r} is not supported")
        out = {"input_ids": [], "attention_mask": []}
        for ids in encs:
            pad = max((target or len(ids)) - len(ids), 0)
            out["input_ids"].append(ids + [self.pad_token_id] * pad)
            out["attention_mask"].append([1] * len(ids) + [0] * pad)
        if return_tensors == "np":
            return {k: np.asarray(v, np.int64) for k, v in out.items()}
        if return_tensors is not None:
            raise ValueError(f"return_tensors={return_tensors!r}: only 'np' is supported")
        return {k: v[0] for k, v in out.items()} if single else out

    # ------------------------------------------------------------- decode
    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        """The text of ``ids``: their pieces (an id outside the vocabulary
        skipped, special tokens too with ``skip_special_tokens``) through
        the decoder, then the tokenization-space clean-up where the config
        asks for it."""
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        toks = self.convert_ids_to_tokens(list(ids), skip_special_tokens=skip_special_tokens)
        text = "".join(self._decode_chain(toks))
        clean = (self.clean_up_tokenization_spaces if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        if clean:
            for a, b in _CLEANUP:
                text = text.replace(a, b)
        return text

    def batch_decode(self, sequences, skip_special_tokens: bool = False,
                     clean_up_tokenization_spaces: Optional[bool] = None) -> List[str]:
        return [self.decode(s, skip_special_tokens, clean_up_tokenization_spaces)
                for s in sequences]


# --- writing a tokenizer directory ------------------------------------------

T5_SPECIALS = ("<pad>", "</s>", "<unk>")


def t5_layout(charsmap: Optional[bytes] = None) -> dict:
    """The normalizer, pre-tokenizer and decoder of Flan-T5's published
    ``tokenizer.json``: the charsmap, runs of spaces made one, whitespace
    split, then ``▁`` before each word."""
    norms = [{"type": "Precompiled",
              "precompiled_charsmap": base64.b64encode(charsmap).decode("ascii")}
             ] if charsmap is not None else []
    norms.append({"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "})
    return {
        "normalizer": {"type": "Sequence", "normalizers": norms},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "WhitespaceSplit"},
            {"type": "Metaspace", "replacement": SPIECE_UNDERLINE, "add_prefix_space": True}]},
        "decoder": {"type": "Metaspace", "replacement": SPIECE_UNDERLINE,
                    "add_prefix_space": True},
    }


def write_unigram_tokenizer(path: str, pieces: Sequence[str], scores: Sequence[float],
                            charsmap: Optional[bytes] = None, extra_ids: int = 100,
                            layout: Optional[dict] = None,
                            clean_up_tokenization_spaces: Optional[bool] = None) -> str:
    """Write a T5-style tokenizer directory: ``tokenizer.json`` (a Unigram
    model over ``<pad>``, ``</s>``, ``<unk>``, then ``pieces`` with
    ``scores``, then ``<extra_id_{extra_ids-1}>`` down to ``<extra_id_0>``
    as added special tokens, as Flan-T5's file orders them; the normalizer,
    pre-tokenizer and decoder of :func:`t5_layout` unless ``layout``
    replaces some; ``TemplateProcessing`` appending ``</s>``),
    ``tokenizer_config.json`` (``T5Tokenizer``) and
    ``special_tokens_map.json``. Returns ``path``."""
    if len(pieces) != len(scores):
        raise ValueError("one score a piece")
    os.makedirs(path, exist_ok=True)
    vocab = [[t, 0.0] for t in T5_SPECIALS] + [[p, float(s)] for p, s in zip(pieces, scores)]
    extras = [f"<extra_id_{i}>" for i in range(extra_ids - 1, -1, -1)]
    vocab += [[t, 0.0] for t in extras]

    def added(i, t):
        return {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
                "normalized": False, "special": True}
    first_extra = len(vocab) - len(extras)
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [added(i, t) for i, t in enumerate(T5_SPECIALS)]
        + [added(first_extra + k, t) for k, t in enumerate(extras)],
        **t5_layout(charsmap), **(layout or {}),
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}}},
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False},
    }
    specials = {"eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>",
                "additional_special_tokens": extras[::-1]}
    config = {"tokenizer_class": "T5Tokenizer", "extra_ids": extra_ids,
              "model_max_length": 512, **specials}
    if clean_up_tokenization_spaces is not None:
        config["clean_up_tokenization_spaces"] = clean_up_tokenization_spaces
    for name, obj in (("tokenizer.json", spec), ("tokenizer_config.json", config),
                      ("special_tokens_map.json", specials)):
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    return path
