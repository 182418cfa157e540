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

``transformers`` is imported only where a tokenizer is built
(``from_pretrained``, :func:`tiny_bert_tokenizer`): the module imports
without it, and the tokenizers are not on the card's path.
"""

from __future__ import annotations

import logging
import os
import string
from typing import List, Optional, Union

import numpy as np


def _load_bert_tokenizer(name_or_path: str):
    from transformers import BertTokenizerFast

    return BertTokenizerFast.from_pretrained(name_or_path)


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
