"""The port's pure-Python WordPiece tokenizer (``models/tokenization.py::
WordPieceTokenizer``) against HF ``BertTokenizerFast`` on the same vocab:
the synthetic task's vocab (as ``GenerateSyntheticM2KR`` writes it) and
``tiny_bert_tokenizer``'s. Ids, token types, masks and decoded text must be
equal exactly; then the FLMR query and context tokenizers and the
full-context pair encoding on each tokenizer."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("transformers")

from reranking_multimodal_retrievers_tpu.models import tokenization as jtok  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import tokenization as ttok  # noqa: E402

SYNTH_WORDS = ([f"a{i:04d}" for i in range(40)] + [f"b{i:04d}" for i in range(40)]
               + [f"c{i:04d}" for i in range(20)] + [f"f{i:03d}" for i in range(30)]
               + [f"p{j}v{c:02d}" for j in range(4) for c in range(16)] + ["pair", "find"])
TINY_WORDS = ["what", "is", "this", "where", "the", "dog", "a", "passage", "another",
              "here", "yes", "no", "capital", "unaffable", "un", "##aff", "##able"]

TEXTS = {
    "synthetic": "find pair a0003 b0017 f012 p0v03 p1v15 p2v00 p3v07",
    "punctuation": "Hello, world! What's this? (a dog) [x]; a-b/c... \"quoted\" #1 $2.50",
    "accents": "Café déjà vu — naïve façade, ÀÉÎÕÜ ñ",
    "cjk": "中文字符 mixed 中 text 日本語",
    "unknown": "zzz€ unknownword ☃ snowman",
    "long_word": "x" * 101 + " short " + "y" * 100,
    "special_tokens": "a [MASK] b[SEP]c [UNK] [CLS]",
    "whitespace_and_controls": "tab\there\nnew\x0bline\x85 end nbsp​ zero",
    "ascii_controls": "tab\there\r\nnew\x0bline\x0c\x1f end\x7f\x00 [x] {y}",
    "contractions": "don't stop... it's they're we've I'm",
    "empty": "",
    "wordpiece_continuations": "unaffable unaff able",
}


@pytest.fixture(scope="module", params=["synthetic_vocab", "tiny_vocab"])
def pair(request, tmp_path_factory):
    """(HF tokenizer, port tokenizer) on one vocab file."""
    d = tmp_path_factory.mktemp(request.param)
    words = SYNTH_WORDS if request.param == "synthetic_vocab" else TINY_WORDS
    hf = jtok.tiny_bert_tokenizer(str(d), words)
    return hf, ttok.WordPieceTokenizer(str(d / "vocab.txt"))


@pytest.mark.parametrize("case", sorted(TEXTS))
def test_encode_and_decode_match_hf(pair, case):
    hf, wp = pair
    text = TEXTS[case]
    assert wp.tokenize(text) == hf.tokenize(text)
    for special in (False, True):
        a = hf.encode(text, add_special_tokens=special)
        assert wp.encode(text, add_special_tokens=special) == a
        assert wp.decode(a) == hf.decode(a)
        assert wp.decode(a, skip_special_tokens=True) == hf.decode(a, skip_special_tokens=True)


@pytest.mark.parametrize("kwargs", [
    dict(padding="max_length", truncation=True, max_length=12),
    dict(padding=True),
    dict(padding="max_length", truncation="longest_first", max_length=40),
    dict(max_length=6),  # truncation implied, no padding: rows of equal length only
], ids=["max_length_truncated", "longest", "max_length_40", "max_length_only"])
def test_batch_call_matches_hf(pair, kwargs):
    hf, wp = pair
    texts = list(TEXTS.values())
    if "padding" not in kwargs:
        texts = [TEXTS["synthetic"], TEXTS["punctuation"]]
    a, b = hf(texts, return_tensors="np", **kwargs), wp(texts, return_tensors="np", **kwargs)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("max_length", [8, 13, 20, 64])
def test_pair_encoding_longest_first_matches_hf(pair, max_length):
    hf, wp = pair
    texts = list(TEXTS.values())
    pairs = [(p, q) for p in texts for q in texts]
    kw = dict(add_special_tokens=True, padding="max_length", truncation=True,
              max_length=max_length, return_token_type_ids=True, return_attention_mask=True,
              return_tensors="np")
    a, b = hf.batch_encode_plus(pairs, **kw), wp.batch_encode_plus(pairs, **kw)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_vocab_queries_match_hf(pair):
    hf, wp = pair
    assert wp.get_vocab() == hf.get_vocab()
    for name in ("pad", "mask", "cls", "sep", "unk"):
        assert getattr(wp, f"{name}_token_id") == getattr(hf, f"{name}_token_id")
    assert wp.convert_tokens_to_ids("[unused0]") == hf.convert_tokens_to_ids("[unused0]")
    assert wp.convert_tokens_to_ids("no-such-token") == hf.convert_tokens_to_ids("no-such-token")
    assert ttok.punctuation_skiplist_ids(wp) == jtok.punctuation_skiplist_ids(hf)


def test_added_special_tokens_match_hf(tmp_path):
    hf = jtok.tiny_bert_tokenizer(str(tmp_path), TINY_WORDS)
    wp = ttok.WordPieceTokenizer(str(tmp_path / "vocab.txt"))
    special = {"additional_special_tokens": ["<BOK>", "<EOK>"]}
    assert wp.add_special_tokens(special) == hf.add_special_tokens(special)
    text = "the <BOK>dog<EOK> is here <BOK>"
    assert wp.encode(text) == hf.encode(text)
    assert ttok.instruction_token_id(wp, "<BOK>") == jtok.instruction_token_id(hf, "<BOK>")


@pytest.mark.parametrize("attend", [False, True])
def test_flmr_tokenizers_match_on_both_paths(pair, attend):
    hf, wp = pair
    texts = [TEXTS["synthetic"], TEXTS["punctuation"], TEXTS["accents"], TEXTS["empty"]]
    qa = jtok.FLMRQueryTokenizer(hf, query_maxlen=16, attend_to_mask_tokens=attend)(texts)
    qb = ttok.FLMRQueryTokenizer(wp, query_maxlen=16, attend_to_mask_tokens=attend)(texts)
    ca = jtok.FLMRContextTokenizer(hf, doc_maxlen=24)(texts, max_length=20)
    cb = ttok.FLMRContextTokenizer(wp, doc_maxlen=24)(texts, max_length=20)
    for a, b in ((qa, qb), (ca, cb)):
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_full_context_inputs_match_on_both_paths(pair):
    hf, wp = pair
    queries = [TEXTS["synthetic"], TEXTS["punctuation"]]
    contexts = [TEXTS[k] for k in ("accents", "cjk", "unknown", "contractions", "long_word",
                                   "synthetic")]
    kw = dict(max_query_length=6, max_context_length=9, max_decoder_source_length=20,
              docs_per_query=3)
    a = jtok.prepare_full_context_inputs(queries, contexts, hf, **kw)
    b = ttok.prepare_full_context_inputs(queries, contexts, wp, **kw)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("lower", [True, False])
def test_flmr_tokenizers_from_a_saved_directory_match_hf(tmp_path, lower):
    """``FLMRQueryTokenizer``/``FLMRContextTokenizer.from_pretrained`` on a
    directory ``BertTokenizerFast.save_pretrained`` wrote (its
    ``tokenizer_config.json``: lower-casing, accents, added special tokens)
    build the port's WordPiece tokenizer, no ``transformers``, with the JAX
    package's ids (which load it with ``BertTokenizerFast``)."""
    from transformers import BertTokenizerFast

    vocab = jtok.write_test_vocab(str(tmp_path / "src" / "vocab.txt"),
                                  TINY_WORDS + ["Café", "Dog"])
    hf = BertTokenizerFast(vocab_file=vocab, do_lower_case=lower, strip_accents=not lower)
    hf.add_special_tokens({"additional_special_tokens": ["<BOK>", "<EOK>"]})
    hf.save_pretrained(str(tmp_path / "saved"))
    path = str(tmp_path / "saved")
    port_base = ttok._load_bert_tokenizer(path)
    assert isinstance(port_base, ttok.WordPieceTokenizer)
    assert len(port_base) == len(BertTokenizerFast.from_pretrained(path))
    texts = [TEXTS["accents"], "<BOK> the Dog here <EOK>", TEXTS["punctuation"]]
    for cls, kw in (("FLMRQueryTokenizer", {"query_maxlen": 24}),
                    ("FLMRContextTokenizer", {"doc_maxlen": 40})):
        want = getattr(jtok, cls).from_pretrained(path, **kw)(texts)
        got = getattr(ttok, cls).from_pretrained(path, **kw)(texts)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{cls} {k}")
    with pytest.raises(FileNotFoundError, match="not a local tokenizer directory"):
        ttok.FLMRQueryTokenizer.from_pretrained("bert-base-uncased")
