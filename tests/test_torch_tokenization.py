"""The port's copy of the FLMR tokenizers (``models/tokenization.py``)
against the JAX package's, on the offline test vocabulary of
``write_test_vocab``: the same ids and masks, exactly, for the query and
context tokenizers (with and without ``attend_to_mask_tokens``, truncated
and padded), ``prepare_full_context_inputs``, the punctuation skiplist, the
instruction token and the instruction-prefix stripping."""

import pytest

pytest.importorskip("transformers")

import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.models import tokenization as jtok  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import tokenization as ttok  # noqa: E402

WORDS = ["what", "is", "the", "capital", "of", "france", "paris", "city", "river", "seine"]
QUERIES = ["what is the capital of france?", "Paris, the city!"]
DOCS = ["paris is the capital of france.", "the seine is a river",
        "the city of paris, on the seine, is the capital", "france"]


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    return jtok.tiny_bert_tokenizer(str(jdir), WORDS), ttok.tiny_bert_tokenizer(str(tdir), WORDS)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_write_test_vocab_is_the_same_file(tmp_path):
    a = jtok.write_test_vocab(str(tmp_path / "a" / "vocab.txt"), WORDS)
    b = ttok.write_test_vocab(str(tmp_path / "b" / "vocab.txt"), WORDS)
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize("maxlen,attend", [(8, False), (16, False), (16, True)])
def test_query_tokenizer_matches_jax(toks, maxlen, attend):
    j, t = (m.FLMRQueryTokenizer(tok, query_maxlen=maxlen, attend_to_mask_tokens=attend)
            for m, tok in zip((jtok, ttok), toks))
    _same(j(QUERIES), t(QUERIES))
    _same(j(QUERIES[0], max_length=6), t(QUERIES[0], max_length=6))


@pytest.mark.parametrize("doc_maxlen,max_length", [(12, None), (32, None), (32, 10), (12, 20)])
def test_context_tokenizer_matches_jax(toks, doc_maxlen, max_length):
    j, t = (m.FLMRContextTokenizer(tok, doc_maxlen=doc_maxlen)
            for m, tok in zip((jtok, ttok), toks))
    _same(j(DOCS, max_length=max_length), t(DOCS, max_length=max_length))


def test_prepare_full_context_inputs_matches_jax(toks):
    kw = dict(max_query_length=6, max_context_length=9, max_decoder_source_length=24,
              docs_per_query=2)
    _same(jtok.prepare_full_context_inputs(QUERIES, DOCS, toks[0], **kw),
          ttok.prepare_full_context_inputs(QUERIES, DOCS, toks[1], **kw))


def test_token_sets_and_prefixes_match_jax(toks):
    assert ttok.punctuation_skiplist_ids(toks[1]) == jtok.punctuation_skiplist_ids(toks[0])
    for marker in ("?", ":", "[SEP]"):
        assert (ttok.instruction_token_id(toks[1], marker)
                == jtok.instruction_token_id(toks[0], marker))
    assert ttok.INSTRUCTION_PREFIXES == jtok.INSTRUCTION_PREFIXES
    for text in [jtok.INSTRUCTION_PREFIXES[3] + "what is this?", "no prefix here"]:
        assert ttok.remove_instruction_prefix(text) == jtok.remove_instruction_prefix(text)
