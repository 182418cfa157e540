"""``models/unigram.py``'s Unigram tokenizer against ``transformers.
AutoTokenizer`` on the same directory (the JAX captioner's own call,
JAX ``data/ops/infoseek_ops.py:187``), which runs the ``tokenizers``
library: ``input_ids``, ``attention_mask`` and the ``decode``/
``batch_decode`` strings must be equal. The directories are written here by
``write_unigram_tokenizer`` (a few hundred pieces with scores on a 1/4
grid, so that equal path scores tie exactly and the tie rule is held too),
with charsmaps from ``write_precompiled_charsmap``; the same charsmap
bytes go to ``tokenizers.normalizers.Precompiled``. Texts are seeded and
``hypothesis``-drawn (a bounded number of examples): ASCII, accented
letters precomposed and combining, full-width forms, CJK, Hangul jamo and
syllables, whitespace runs, added tokens inside the text, and text longer
than ``max_length``."""

import base64
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
from hypothesis import given, settings, strategies as st  # noqa: E402

from reranking_multimodal_retrievers_tpu_torch.models import unigram  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (  # noqa: E402
    UnigramTokenizer, write_precompiled_charsmap, write_unigram_tokenizer)

transformers.logging.set_verbosity_error()

# the charsmap: full-width ASCII, ideographic and no-break spaces, two
# combining sequences and a jamo sequence composed, a ligature, a removal,
# and a key (full-width A, U+0301) with a key as its prefix: the library
# takes a grapheme cluster's shortest match and drops the rest of it
CHARSMAP = {**{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)},
            "　": " ", " ": " ", "\t": " ", "\n": " ", "é": "é",
            "ñ": "ñ", "가": "가", "ﬁ": "fi", "​": "",
            "Ａ́": "Á"}
FRAGMENTS = (["a", "photo", "of", "the", "cat", "on", "mat", "sun", "kato", "lomi", "x", "Q",
              "7", ".", ",", "'s", "n't", "?", "!"]
             + ["é", "ü", "ñ", "ç", "é", "ñ", "ü", "ﬁ", "ﬁ́"]
             + ["ａ", "ｐｈｏｔｏ", "ＡＢ", "１２", "！", "Ａ́"]
             + ["東", "京", "大学", "日本"]
             + ["ᄀ", "ᅡ", "ᆨ", "가", "각", "가", "각"]
             + [" ", "  ", "   ", "\t", "\n", "　", " ", "​"]
             + ["<extra_id_0>", "<extra_id_7>", "</s>", "<pad>", "<unk>"])
# a modern converter's layout: right strip, space runs to one metaspace,
# the metaspace only before the text's first word
MODERN = {
    "normalizer": {"type": "Sequence", "normalizers": [
        {"type": "Precompiled", "precompiled_charsmap": None},
        {"type": "Strip", "strip_left": False, "strip_right": True},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]},
    "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                      "split": True},
    "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                "split": True},
}
# a byte-fallback layout (Llama's): no normalizer, spaces as metaspaces
# and one before the text, unknown characters spelled in bytes
BYTES = {
    "normalizer": None,
    "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                      "split": False},
    "decoder": {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
        {"type": "ByteFallback"}, {"type": "Fuse"},
        {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
}


def _vocab(seed: int, byte_pieces: bool = False):
    """A few hundred pieces: characters, ``▁``-words and their parts,
    syllables; scores are multiples of 1/4."""
    rng = np.random.default_rng(seed)
    chars = sorted(set("abcdefghijklmnopqrstuvwxyzAQ0127.,'?!éüñçfi東京大学日本가각"
                       "각"))
    words = ["a", "photo", "of", "the", "cat", "on", "mat", "sun", "kato", "lomi", "fine",
             "café", "ph", "ot", "oto", "ka", "to", "lo", "mi", "at", "he", "th", "ca",
             "'s", "n't", "12", "東京", "大学", "日本", "가각", "su", "un", "ma"]
    pieces = ["▁"] + chars + ["▁" + w for w in words] + words
    if byte_pieces:
        pieces += [f"<0x{b:02X}>" for b in range(256)]
    pieces = list(dict.fromkeys(pieces))
    scores = (-rng.integers(4, 60, len(pieces)) / 4.0).tolist()
    return pieces, scores


def _write(tmp, name, layout=None, byte_pieces=False, clean=None, charsmap=CHARSMAP):
    path = str(tmp / name)
    blob = write_precompiled_charsmap(charsmap) if charsmap is not None else None
    if layout is not None and blob is not None:
        layout = json.loads(json.dumps(layout))
        for n in (layout["normalizer"] or {}).get("normalizers", []):
            if n["type"] == "Precompiled":
                n["precompiled_charsmap"] = base64.b64encode(blob).decode()
    pieces, scores = _vocab(len(name), byte_pieces)
    write_unigram_tokenizer(path, pieces, scores, blob, layout=layout,
                            clean_up_tokenization_spaces=clean)
    if byte_pieces:  # the model spells unknowns in bytes
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        spec["model"]["byte_fallback"] = True
        with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
            json.dump(spec, f, ensure_ascii=False)
    return (transformers.AutoTokenizer.from_pretrained(path),
            UnigramTokenizer.from_pretrained(path))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unigram")
    return {"t5": _write(tmp, "t5"), "t5_clean": _write(tmp, "t5_clean", clean=True),
            "modern": _write(tmp, "modern", MODERN),
            "bytes": _write(tmp, "bytes", BYTES, byte_pieces=True, charsmap=None)}


def _assert_same(hf, me, texts, max_length=16):
    a = hf(texts, padding="max_length", truncation=True, max_length=max_length,
           return_tensors="np")
    b = me(texts, padding="max_length", truncation=True, max_length=max_length,
           return_tensors="np")
    for text, x, y in zip(texts, a["input_ids"], b["input_ids"]):
        assert x.tolist() == y.tolist(), (text, hf.convert_ids_to_tokens(x.tolist()),
                                          me.convert_ids_to_tokens(y.tolist()))
    assert a["input_ids"].dtype == b["input_ids"].dtype
    np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
    full = [hf(t)["input_ids"] for t in texts]
    for text, ids in zip(texts, full):
        assert me.encode(text) == ids, text
        for skip in (True, False):
            assert me.decode(ids, skip_special_tokens=skip) == \
                hf.decode(ids, skip_special_tokens=skip), (text, skip)
    assert me.batch_decode(a["input_ids"], skip_special_tokens=True) == \
        hf.batch_decode(a["input_ids"], skip_special_tokens=True)


TEXTS = ["a photo of", "ａ ｐｈｏｔｏ ｏｆ the  cat", "café é ñ ñ", "東京 大学 가각 xyz",
         "각 ᄀ ᅡ", "  lead  and\ttab　ideo nb", "",
         "a <extra_id_0> photo</s>of<pad>", "Ａ́B ﬁ́ne ﬁne", "​the cat",
         "the cat on the mat " * 6, "it's n't ? ! , .", "zzz qqq ẞ ◆◆", "​ ​"]


@pytest.mark.parametrize("layout", ["t5", "t5_clean", "modern", "bytes"])
def test_seeded_texts_equal_autotokenizer(pairs, layout):
    hf, me = pairs[layout]
    rng = np.random.default_rng(7)
    drawn = ["".join(rng.choice(FRAGMENTS, rng.integers(1, 30))) for _ in range(60)]
    _assert_same(hf, me, TEXTS + drawn)
    _assert_same(hf, me, TEXTS, max_length=64)
    if layout == "bytes":  # unknown characters are spelled in byte pieces
        assert "<0xE2>" in me.tokenize("zz ẞ ◆")


@pytest.mark.parametrize("layout", ["t5", "modern", "bytes"])
@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(st.sampled_from(FRAGMENTS), max_size=40).map("".join),
                min_size=1, max_size=4))
def test_drawn_texts_equal_autotokenizer(pairs, layout, texts):
    _assert_same(*pairs[layout], texts)


def test_special_ids_and_tokens(pairs):
    hf, me = pairs["t5"]
    assert (me.eos_token_id, me.pad_token_id, me.unk_token_id) == \
        (hf.eos_token_id, hf.pad_token_id, hf.unk_token_id) == (1, 0, 2)
    assert len(me) == len(hf)
    ids = list(range(len(hf) + 5))  # ids past the vocabulary are skipped
    assert me.convert_ids_to_tokens(ids[:len(hf)]) == hf.convert_ids_to_tokens(ids[:len(hf)])
    assert me.decode(ids, skip_special_tokens=True) == hf.decode(ids, skip_special_tokens=True)
    assert me.decode(ids) == hf.decode(ids)
    assert me.convert_tokens_to_ids("<extra_id_0>") == hf.convert_tokens_to_ids("<extra_id_0>")


def test_viterbi_ties_and_unknowns_fuse(tmp_path):
    """Equal-score segmentations take the one whose last piece starts
    first; runs of unknown characters become one unk id."""
    pieces = ["▁", "a", "b", "c", "ab", "bc", "▁abc", "▁ab", "▁a"]
    scores = [-1.0, -2.0, -2.0, -2.0, -3.0, -3.0, -9.0, -4.0, -3.0]
    path = write_unigram_tokenizer(str(tmp_path / "tie"), pieces, scores, None)
    hf = transformers.AutoTokenizer.from_pretrained(path)
    me = UnigramTokenizer.from_pretrained(path)
    _assert_same(hf, me, ["abc", "abcabc", "a b c", "xyz abc", "ab xy bc", "ꙮꙮa"])
    assert me.tokenize("xyzw") == ["▁", "<unk>"]


def test_charsmap_bytes_equal_tokenizers_precompiled():
    """The same blob through ``tokenizers``' normalizer and the port's."""
    blob = write_precompiled_charsmap(CHARSMAP)
    assert unigram.read_precompiled_charsmap(blob) == CHARSMAP
    theirs = tokenizers.normalizers.Precompiled(blob)
    ours = unigram._normalizer({"type": "Precompiled",
                                "precompiled_charsmap": base64.b64encode(blob).decode()})
    rng = np.random.default_rng(3)
    for text in TEXTS + ["".join(rng.choice(FRAGMENTS, 20)) for _ in range(200)]:
        assert ours(text) == theirs.normalize_str(text), text


def test_graphemes_equal_regex_clusters():
    """The supported break classes split as ``regex``'s ``\\X`` does."""
    regex = pytest.importorskip("regex")
    samples = ["é̂x", "\r\n\n\r", "각ᄀ각ᆨᆨ",
               "🇯🇵🇫🇷🇩", "कि", "؀a", "a‍b", "a‌b", "ｶﾞ", "\x01́",
               "가ᅡ", "ힰퟋ"]
    for s in samples:
        assert unigram.graphemes(s) == regex.findall(r"\X", s), s


@pytest.mark.parametrize("component,spec", [
    ("model 'BPE'", {"model": {"type": "BPE"}}),
    ("normalizer 'BertNormalizer'", {"normalizer": {"type": "BertNormalizer"}}),
    ("pre-tokenizer 'ByteLevel'", {"pre_tokenizer": {"type": "ByteLevel"}}),
    ("decoder 'WordPiece'", {"decoder": {"type": "WordPiece"}}),
    ("post-processor 'BertProcessing'", {"post_processor": {"type": "BertProcessing"}}),
])
def test_unimplemented_components_raise_naming_them(tmp_path, component, spec):
    path = write_unigram_tokenizer(str(tmp_path / "t"), ["a"], [-1.0], None)
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        full = json.load(f)
    full.update(spec)
    with pytest.raises(NotImplementedError, match=component):
        UnigramTokenizer(full, {})


def test_committed_tokenizer_equals_its_digests_without_the_libraries():
    """The committed ``tests/fixtures/unigram_tokenizer`` read where
    ``tokenizers``, ``transformers`` and ``regex`` cannot be imported: its
    ids and decoded strings equal the digests of the library's."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys, json, hashlib\n"
        "for m in ('tokenizers', 'transformers', 'regex', 'jax'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(root / 'tests' / 'fixtures')!r})\n"
        "import make_m2kr_parquet as fx\n"
        "from reranking_multimodal_retrievers_tpu_torch.data.ops.infoseek_ops import "
        "load_caption_tokenizer\n"
        "d = json.load(open(fx.DIGESTS))['tokenizer']\n"
        "tok = load_caption_tokenizer(fx.TOKENIZER)\n"
        "ids = [tok.encode(t) for t in d['texts']]\n"
        "dec = [tok.decode(i, skip_special_tokens=True) for i in ids]\n"
        "assert hashlib.sha256(json.dumps(ids).encode()).hexdigest() == d['ids']\n"
        "assert hashlib.sha256(json.dumps(dec, ensure_ascii=False).encode('utf-8'))"
        ".hexdigest() == d['decoded']\n"
        "print('ok', type(tok).__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "ok UnigramTokenizer", out.stderr[-2000:]
