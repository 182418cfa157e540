"""FLMR query/context tokenizers (the port's own copy of the JAX package's
``models/tokenization.py``, which imports no JAX).

Same contract as the reference tokenizers
(`src/models/flmr/models/flmr/tokenization_flmr.py:90-250`), implemented as
thin post-processing over HF ``BertTokenizerFast`` returning NumPy arrays
(the host side of the input pipeline, fixed shapes):

- context: prepend ". " placeholder, force the ``[D]`` marker (``[unused1]``)
  at position 1, pad/truncate to ``doc_maxlen``.
- query: prepend ". " placeholder, force ``[Q]`` (``[unused0]``) at position
  1, pad to ``query_maxlen`` and replace pad ids with ``[MASK]`` (ColBERT
  query augmentation); ``attend_to_mask_tokens`` optionally turns the
  attention mask on for those rows.

Also exports the tokenizer-derived static sets the models need:
``punctuation_skiplist_ids`` (reference `modeling_flmr.py:701-709`) and
``instruction_token_id`` (`:711-716`).

:class:`WordPieceTokenizer` is a pure-Python BERT tokenizer built from a
``vocab.txt``, with the part of ``BertTokenizerFast``'s interface that the
data pipeline and these wrappers use; the data pipeline builds it
(``WordPieceTokenizer.from_pretrained``, :func:`tiny_wordpiece_tokenizer`),
so it runs on a machine without ``transformers``; so do the FLMR
tokenizers' ``from_pretrained``, which read a local tokenizer directory's
``vocab.txt`` and ``tokenizer_config.json``. ``transformers`` is imported
only where a test's HF tokenizer is built (:func:`tiny_bert_tokenizer`):
the module imports without it. :class:`UnigramTokenizer` (T5's, from an HF
``tokenizer.json``) lives in ``models/unigram.py`` and is exported here.
"""

from __future__ import annotations

import json
import logging
import os
import re
import string
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

# the Unigram tokenizer of T5-family ``tokenizer.json`` files, beside WordPiece
from .unigram import (UnigramTokenizer, write_precompiled_charsmap,  # noqa: F401
                      write_unigram_tokenizer)


# --- pure-Python WordPiece (BertTokenizerFast's normaliser, pre-tokenizer,
# model, post-processor and decoder) -----------------------------------------

_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
               (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
            (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))
_SPECIAL_KEYS = ("unk_token", "sep_token", "pad_token", "cls_token", "mask_token")
# ASCII text takes a shorter road to the same words: the control characters
# (category Cc) are dropped, \t \n \r become spaces, and the words are the
# runs of non-space, non-punctuation characters and each punctuation
# character (ASCII's punctuation characters are ``string.punctuation``)
_ASCII_CLEAN = {**{c: None for c in range(32) if chr(c) not in "\t\n\r"}, 0x7F: None,
                **{ord(c): " " for c in "\t\n\r"}}
_PUNCT_CLASS = "[" + re.escape(string.punctuation) + "]"
_ASCII_WORDS = re.compile(r"[^\s" + re.escape(string.punctuation) + "]+|" + _PUNCT_CLASS)


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c).startswith("C")


def _is_punctuation(c: str) -> bool:
    return c in string.punctuation or unicodedata.category(c).startswith("P")


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _truncate_pair(n1: int, n2: int, budget: int) -> Tuple[int, int]:
    """The lengths ``longest_first`` truncation keeps of a pair of
    ``n1`` and ``n2`` tokens within ``budget`` (the tokenizers library's
    rule: the shorter keeps its length if the longer can take the rest,
    else they split the budget, the longer taking the odd token)."""
    swap = n1 > n2
    a, b = (n2, n1) if swap else (n1, n2)
    b = a if a > budget else max(a, budget - a)
    if a + b > budget:
        a = budget // 2
        b = a + budget % 2
    return (b, a) if swap else (a, b)


class WordPieceTokenizer:
    """BERT WordPiece tokenization in pure Python, from a ``vocab.txt``:
    clean the text, pad CJK characters with spaces, strip accents and
    lowercase (``do_lower_case``), split on whitespace and punctuation,
    then greedy longest-match WordPiece (``##`` continuations, ``[UNK]`` for
    a word that does not decompose or is over 100 characters). Special
    tokens in the text are kept whole. The calls take the arguments of
    ``BertTokenizerFast`` that the pipeline uses and return the same ids."""

    max_input_chars_per_word = 100

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 tokenize_chinese_chars: bool = True, strip_accents: Optional[bool] = None,
                 unk_token="[UNK]", sep_token="[SEP]", pad_token="[PAD]",
                 cls_token="[CLS]", mask_token="[MASK]",
                 clean_up_tokenization_spaces: bool = True):
        with open(vocab_file, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab: Dict[str, int] = {}
        for t in tokens:
            self.vocab.setdefault(t, len(self.vocab))
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.vocab_size = len(self.vocab)  # the file's, without added tokens
        self.do_lower_case = do_lower_case
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.strip_accents = do_lower_case if strip_accents is None else strip_accents
        self.clean_up_tokenization_spaces = clean_up_tokenization_spaces
        self.unk_token, self.sep_token, self.pad_token = unk_token, sep_token, pad_token
        self.cls_token, self.mask_token = cls_token, mask_token
        self.additional_special_tokens: List[str] = []
        self._special: List[str] = []
        self._refresh_special()

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "WordPieceTokenizer":
        """From a directory holding ``vocab.txt``, or the file itself. A
        directory's ``tokenizer_config.json`` (as ``save_pretrained``
        writes it) gives the lower-casing, accent and CJK options, the
        special tokens, the added tokens beyond the vocabulary (by id) and
        the additional special tokens; ``kwargs`` override it."""
        if not os.path.isdir(path):
            return cls(path, **kwargs)
        opts, added, extra = {}, [], []
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            for key in ("do_lower_case", "strip_accents", "tokenize_chinese_chars",
                        "clean_up_tokenization_spaces", *_SPECIAL_KEYS):
                value = cfg.get(key)
                if isinstance(value, dict):  # an AddedToken's serialisation
                    value = value.get("content")
                if value is not None:
                    opts[key] = value
            added = sorted((int(i), d["content"])
                           for i, d in (cfg.get("added_tokens_decoder") or {}).items())
            extra = [t.get("content") if isinstance(t, dict) else t
                     for t in cfg.get("additional_special_tokens") or []]
        tok = cls(os.path.join(path, "vocab.txt"), **{**opts, **kwargs})
        for i, content in added:
            if content not in tok.vocab:
                if i != len(tok.ids_to_tokens):
                    raise ValueError(f"{cfg_path}: added token {content!r} has id {i}, the "
                                     f"vocabulary's next id is {len(tok.ids_to_tokens)}")
                tok._add_token(content)
        if extra:
            tok.add_special_tokens({"additional_special_tokens": extra})
        return tok

    def _refresh_special(self) -> None:
        names = [getattr(self, k) for k in _SPECIAL_KEYS] + self.additional_special_tokens
        self._special = sorted(set(names), key=len, reverse=True)
        self._special_re = re.compile("(" + "|".join(map(re.escape, self._special)) + ")")

    def _add_token(self, token: str) -> None:
        if token not in self.vocab:
            i = len(self.ids_to_tokens)
            self.vocab[token] = i
            self.ids_to_tokens[i] = token

    def add_special_tokens(self, special: Dict[str, Union[str, Sequence[str]]]) -> int:
        """Register special tokens (``{"additional_special_tokens": [...]}`` or
        ``{"<name>_token": "..."}``), adding to the vocabulary those it lacks;
        returns the number added."""
        before = len(self.ids_to_tokens)
        for key, value in special.items():
            values = [value] if isinstance(value, str) else list(value)
            for v in values:
                self._add_token(v)
            if key == "additional_special_tokens":
                self.additional_special_tokens += [v for v in values
                                                   if v not in self.additional_special_tokens]
            else:
                setattr(self, key, values[0])
        self._refresh_special()
        return len(self.ids_to_tokens) - before

    def __len__(self) -> int:
        return len(self.ids_to_tokens)

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    def __getattr__(self, name: str):
        # pad_token_id, mask_token_id, ... for every special token name
        if name.endswith("_token_id") and name[:-3] in _SPECIAL_KEYS:
            return self.vocab.get(getattr(self, name[:-3]))
        raise AttributeError(name)

    @property
    def all_special_ids(self) -> List[int]:
        return [self.vocab[t] for t in self._special if t in self.vocab]

    # ------------------------------------------------------------- tokenize
    def _normalize(self, text: str) -> str:
        text = "".join(" " if c.isspace() else c for c in text
                       if not (c in "\x00\ufffd" or _is_control(c)))
        if self.tokenize_chinese_chars:
            text = "".join(f" {c} " if _is_cjk(c) else c for c in text)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if self.do_lower_case:
            text = text.lower()
        return text

    @staticmethod
    def _split_words(text: str) -> List[str]:
        words, cur = [], []
        for c in text:
            if c.isspace():
                if cur:
                    words.append("".join(cur))
                    cur = []
            elif _is_punctuation(c):
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(c)
            else:
                cur.append(c)
        if cur:
            words.append("".join(cur))
        return words

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end, piece = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for part in self._special_re.split(text) if self._special else [text]:
            if not part:
                continue
            if part in self._special:
                out.append(part)
                continue
            if part.isascii():
                text = part.translate(_ASCII_CLEAN)
                words = _ASCII_WORDS.findall(text.lower() if self.do_lower_case else text)
            else:
                words = self._split_words(self._normalize(part))
            for word in words:
                if word in self.vocab and len(word) <= self.max_input_chars_per_word:
                    out.append(word)
                else:
                    out.extend(self._wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.vocab.get(self.unk_token))
        return [self.convert_tokens_to_ids(t) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, (int, np.integer)):
            return self.ids_to_tokens[int(ids)]
        return [self.ids_to_tokens[int(i)] for i in ids]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self._encode_one(text, None, add_special_tokens, False, None)[0]

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        """``BertTokenizerFast.decode``: tokens joined by spaces, ``##``
        continuations glued on, then the tokenization-space clean-up. An id
        outside the vocabulary (a model's vocabulary may be larger) is
        skipped, as HF's tokenizers skip it."""
        special = set(self.all_special_ids)
        toks = [self.ids_to_tokens[int(i)] for i in ids
                if int(i) in self.ids_to_tokens
                and not (skip_special_tokens and int(i) in special)]
        parts = []
        for i, tok in enumerate(toks):
            if i and tok.startswith("##"):
                tok = tok[2:]
            elif i:
                tok = " " + tok
            for a, b in _CLEANUP[:4]:  # the WordPiece decoder's own clean-up
                tok = tok.replace(a, b)
            parts.append(tok)
        text = "".join(parts)
        clean = (self.clean_up_tokenization_spaces if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        if clean:
            for a, b in _CLEANUP:
                text = text.replace(a, b)
        return text

    # --------------------------------------------------------------- encode
    def _encode_one(self, text, pair, add_special_tokens, truncation, max_length):
        a = self.convert_tokens_to_ids(self.tokenize(text))
        b = None if pair is None else self.convert_tokens_to_ids(self.tokenize(pair))
        if truncation not in (False, None, "do_not_truncate") and max_length is not None:
            extra = (3 if b is not None else 2) if add_special_tokens else 0
            budget = max(max_length - extra, 0)
            if truncation not in (True, "longest_first"):
                raise ValueError(f"truncation {truncation!r} is not supported")
            if b is None:
                a = a[:budget]
            else:
                na, nb = _truncate_pair(len(a), len(b), budget)
                a, b = a[:na], b[:nb]
        if add_special_tokens:
            ids = [self.cls_token_id] + a + [self.sep_token_id]
            types = [0] * len(ids)
            if b is not None:
                ids += b + [self.sep_token_id]
                types += [1] * (len(b) + 1)
        else:
            ids = a + (b or [])
            types = [0] * len(a) + [1] * len(b or [])
        return ids, types

    def __call__(self, text, text_pair=None, padding=False, truncation=None,
                 max_length: Optional[int] = None, return_tensors: Optional[str] = None,
                 add_special_tokens: bool = True, return_token_type_ids: Optional[bool] = None,
                 return_attention_mask: Optional[bool] = None, **_unused):
        """Encode a string, a list of strings, or a list of (text, pair)
        tuples. ``padding``: ``"max_length"``, ``True``/``"longest"`` or
        False; ``truncation``: True/``"longest_first"`` or False;
        ``return_tensors="np"`` gives int64 arrays, else lists (of lists for
        a batch)."""
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        if text_pair is not None:
            pairs = [text_pair] if isinstance(text_pair, str) else list(text_pair)
            items = list(zip(texts, pairs))
        else:
            items = [t if isinstance(t, tuple) else (t, None) for t in texts]
        if truncation is None:  # HF truncates only when max_length comes without padding
            truncation = "longest_first" if max_length is not None and not padding else False
        encs = [self._encode_one(t, p, add_special_tokens, truncation, max_length)
                for t, p in items]
        if padding in (True, "longest"):
            target = max(len(ids) for ids, _ in encs) if encs else 0
        elif padding == "max_length":
            target = max_length
        else:
            target = None
        out = {"input_ids": [], "token_type_ids": [], "attention_mask": []}
        for ids, types in encs:
            n = len(ids)
            pad = max((target or n) - n, 0)
            out["input_ids"].append(ids + [self.pad_token_id] * pad)
            out["token_type_ids"].append(types + [0] * pad)
            out["attention_mask"].append([1] * n + [0] * pad)
        if return_token_type_ids is False:
            del out["token_type_ids"]
        if return_attention_mask is False:
            del out["attention_mask"]
        if return_tensors == "np":
            return {k: np.asarray(v, np.int64) for k, v in out.items()}
        if return_tensors is not None:
            raise ValueError(f"return_tensors={return_tensors!r}: only 'np' is supported")
        return {k: v[0] for k, v in out.items()} if single else out

    def batch_encode_plus(self, batch_text_or_text_pairs, **kwargs):
        return self(list(batch_text_or_text_pairs), **kwargs)


def tiny_wordpiece_tokenizer(tmpdir: str, words: Optional[List[str]] = None
                             ) -> WordPieceTokenizer:
    """:func:`tiny_bert_tokenizer`'s vocabulary, as a :class:`WordPieceTokenizer`."""
    return WordPieceTokenizer(write_test_vocab(os.path.join(tmpdir, "vocab.txt"), words),
                              do_lower_case=True)


def _load_bert_tokenizer(name_or_path: str) -> WordPieceTokenizer:
    """The tokenizer of a local BERT tokenizer directory (``vocab.txt`` and
    ``tokenizer_config.json``), where the JAX package calls
    ``BertTokenizerFast.from_pretrained``: the same ids, no
    ``transformers``."""
    if not os.path.exists(name_or_path):
        raise FileNotFoundError(f"{name_or_path!r} is not a local tokenizer directory (hub ids "
                                "need the network)")
    return WordPieceTokenizer.from_pretrained(name_or_path)


class FLMRContextTokenizer:
    def __init__(self, tokenizer, doc_maxlen: int = 512):
        self.tok = tokenizer
        self.doc_maxlen = doc_maxlen
        self.D_marker_token_id = self.tok.convert_tokens_to_ids("[unused1]")

    @classmethod
    def from_pretrained(cls, name_or_path: str, doc_maxlen: int = 512):
        return cls(_load_bert_tokenizer(name_or_path), doc_maxlen=doc_maxlen)

    def __call__(
        self,
        text: Union[str, List[str]],
        max_length: Optional[int] = None,
        padding: str = "max_length",
    ):
        if isinstance(text, str):
            text = [text]
        text = [". " + x for x in text]
        if max_length is not None and max_length > self.doc_maxlen:
            # honoring the caller's larger budget silently would desync the
            # static shapes this tokenizer was configured for; capping it
            # silently hides real signal loss (a reranker configured for a
            # 64-token doc budget over a 24-token tokenizer sees nothing past
            # token 24) — so cap, but loudly
            logging.getLogger(__name__).warning(
                "requested max_length=%d exceeds this tokenizer's doc_maxlen"
                "=%d; capping — configure the tokenizer's doc_maxlen if the "
                "longer budget is intended", max_length, self.doc_maxlen,
            )
        max_length = min(max_length or self.doc_maxlen, self.doc_maxlen)
        enc = self.tok(
            text,
            padding=padding,
            truncation="longest_first",
            max_length=max_length,
            return_tensors="np",
        )
        ids = enc["input_ids"]
        ids[:, 1] = self.D_marker_token_id
        return {
            "input_ids": ids.astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32),
        }


class FLMRQueryTokenizer:
    def __init__(
        self,
        tokenizer,
        query_maxlen: int = 32,
        attend_to_mask_tokens: bool = False,
    ):
        self.tok = tokenizer
        self.query_maxlen = query_maxlen
        self.attend_to_mask_tokens = attend_to_mask_tokens
        self.Q_marker_token_id = self.tok.convert_tokens_to_ids("[unused0]")
        self.mask_token_id = self.tok.mask_token_id
        self.pad_token_id = self.tok.pad_token_id

    @classmethod
    def from_pretrained(
        cls,
        name_or_path: str,
        query_maxlen: int = 32,
        attend_to_mask_tokens: bool = False,
    ):
        return cls(
            _load_bert_tokenizer(name_or_path),
            query_maxlen=query_maxlen,
            attend_to_mask_tokens=attend_to_mask_tokens,
        )

    def __call__(
        self,
        text: Union[str, List[str]],
        max_length: Optional[int] = None,
    ):
        if isinstance(text, str):
            text = [text]
        text = [". " + x for x in text]
        max_length = max_length or self.query_maxlen
        enc = self.tok(
            text,
            padding="max_length",
            truncation=True,
            max_length=max_length,
            return_tensors="np",
        )
        ids = enc["input_ids"].astype(np.int32)
        mask = enc["attention_mask"].astype(np.int32)
        ids[:, 1] = self.Q_marker_token_id
        ids[ids == self.pad_token_id] = self.mask_token_id
        if self.attend_to_mask_tokens:
            mask[ids == self.mask_token_id] = 1
        return {"input_ids": ids, "attention_mask": mask}


def punctuation_skiplist_ids(tokenizer) -> tuple:
    """Token ids of all punctuation symbols (reference builds this as a dict
    of both the symbol string and its id, `modeling_flmr.py:701-709`; only the
    ids matter to an id-space mask)."""
    ids = []
    for symbol in string.punctuation:
        enc = tokenizer.encode(symbol, add_special_tokens=False)
        if enc:
            ids.append(enc[0])
    return tuple(sorted(set(ids)))


def instruction_token_id(tokenizer, instruction_token: str) -> int:
    """Reference `modeling_flmr.py:711-716`."""
    return tokenizer.encode(instruction_token, add_special_tokens=False)[0]


INSTRUCTION_PREFIXES = [
    "Using the provided image, obtain documents that address the subsequent question: ",
    "Retrieve documents that provide an answer to the question alongside the image: ",
    "Extract documents linked to the question provided in conjunction with the image: ",
    "Utilizing the given image, obtain documents that respond to the following question: ",
    "Using the given image, access documents that provide insights into the following question: ",
    "Obtain documents that correspond to the inquiry alongside the provided image: ",
    "With the provided image, gather documents that offer a solution to the question: ",
    "Utilizing the given image, obtain documents that respond to the following question: ",
]


def remove_instruction_prefix(text: str) -> str:
    """Strip a known M2KR instruction prefix (reference `utils.py:109-127`)."""
    for prefix in INSTRUCTION_PREFIXES:
        if text.startswith(prefix):
            return text[len(prefix):]
    return text


def prepare_full_context_inputs(
    query_text_sequences: List[str],
    context_text_sequences: List[str],
    tokenizer,
    max_query_length: int,
    max_context_length: int,
    max_decoder_source_length: int,
    docs_per_query: int,
):
    """Host-side joint tokenization for ``FullContextRerankModel``
    (reference `src/models/rerank/utils.py:129-167`): each part is truncated
    to its own token budget, then the (query, context) pair is encoded with
    ``token_type_ids`` and padded to ``max_decoder_source_length``.
    Returns numpy int32 arrays."""
    truncated_query = [
        tokenizer.decode(
            tokenizer.encode(t, add_special_tokens=False)[:max_query_length]
        )
        for t in query_text_sequences
    ]
    truncated_context = [
        tokenizer.decode(
            tokenizer.encode(t, add_special_tokens=False)[:max_context_length]
        )
        for t in context_text_sequences
    ]
    pairs = []
    for i, q in enumerate(truncated_query):
        for j in range(docs_per_query):
            pairs.append((q, truncated_context[i * docs_per_query + j]))
    enc = tokenizer.batch_encode_plus(
        pairs,
        add_special_tokens=True,
        padding="max_length",
        truncation=True,
        max_length=max_decoder_source_length,
        return_token_type_ids=True,
        return_attention_mask=True,
        return_tensors="np",
    )
    return {
        "input_ids": enc["input_ids"].astype(np.int32),
        "attention_mask": enc["attention_mask"].astype(np.int32),
        "token_type_ids": enc["token_type_ids"].astype(np.int32),
    }


# --- offline test vocab -----------------------------------------------------

BASE_SPECIALS = ["[PAD]", "[unused0]", "[unused1]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def write_test_vocab(path: str, words: Optional[List[str]] = None) -> str:
    """Build a minimal BERT WordPiece vocab file for offline tests (there is
    no network access to fetch ``bert-base-uncased``)."""
    words = words or []
    chars = sorted(set(string.ascii_lowercase) | set(string.digits) | set(string.punctuation))
    vocab = BASE_SPECIALS + chars + sorted(set(w.lower() for w in words))
    # add ##-continuations for all single chars so WordPiece never fails
    vocab += ["##" + c for c in chars]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    content = "\n".join(dict.fromkeys(vocab))
    if os.path.exists(path):
        with open(path) as f:
            old = f.read()
        if old != content:
            # overwriting a vocab with different content shifts token ids —
            # every checkpoint trained against the old file is invalidated.
            # Legitimate when regenerating a task at a new size; fatal when
            # two tasks accidentally share a vocab path. Be loud either way.
            logging.getLogger(__name__).warning(
                "write_test_vocab: OVERWRITING %s with different content "
                "(%d -> %d entries); checkpoints trained against the old "
                "vocab are invalidated", path,
                len(old.splitlines()), len(content.splitlines()),
            )
    with open(path, "w") as f:
        f.write(content)
    return path


def tiny_bert_tokenizer(tmpdir: str, words: Optional[List[str]] = None):
    from transformers import BertTokenizerFast

    vocab_file = write_test_vocab(os.path.join(tmpdir, "vocab.txt"), words)
    return BertTokenizerFast(vocab_file=vocab_file, do_lower_case=True)
