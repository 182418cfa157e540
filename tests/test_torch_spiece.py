"""``models/spiece.py``: SentencePiece's ``spiece.model`` read and written
by hand, against ``protobuf`` (through ``transformers``' bundled
``sentencepiece_model_pb2``), and the T5 tokenizer built from it against
``transformers``' ``T5Converter`` (which needs ``protobuf`` but not
``sentencepiece``) wrapped in ``T5TokenizerFast``, and against ``tokenizers``
on the ``tokenizer.json`` a file was written from: the same ``input_ids``,
``attention_mask`` and decoded strings."""

import json
import os
import shutil
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
pytest.importorskip("google.protobuf")

from transformers.convert_slow_tokenizer import T5Converter, import_protobuf  # noqa: E402

from reranking_multimodal_retrievers_tpu_torch.data.ops.infoseek_ops import (  # noqa: E402
    load_caption_tokenizer)
from reranking_multimodal_retrievers_tpu_torch.models import spiece  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (  # noqa: E402
    UnigramTokenizer, write_precompiled_charsmap)

transformers.logging.set_verbosity_error()
FIXTURE = Path(__file__).parent / "fixtures" / "unigram_tokenizer"
CHARSMAP = {**{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)}, "　": " ", "\t": " ",
            "é": "é", "ﬁ": "fi"}
WORDS = ["a", "photo", "of", "the", "cat", "on", "mat", "sun", "kato", "café", "ph", "oto",
         "ka", "to", "th", "at", "12", "東京"]
TEXTS = ["a photo of", "ａ ｐｈｏｔｏ ｏｆ the  cat", "café é ﬁne", "東京 xyz q", "",
         "  lead  and\ttab　ideo ", "a <extra_id_0> photo</s>of<pad>", "the cat " * 9,
         "kato sun mat 12 ?"]


def _model(seed=0, extra_control=()):
    rng = np.random.default_rng(seed)
    chars = sorted(set("abcdefghijklmnopqrstuvwxyz0127.,?éf東京"))
    pieces = ["<pad>", "</s>", "<unk>", *extra_control, "▁",
              *dict.fromkeys(chars + ["▁" + w for w in WORDS] + WORDS)]
    scores = [0.0] * (3 + len(extra_control)) + (-rng.integers(4, 60, len(pieces) - 3
                                                             - len(extra_control)) / 4).tolist()
    kinds = ([spiece.CONTROL, spiece.CONTROL, spiece.UNKNOWN]
             + [spiece.USER_DEFINED] * len(extra_control)
             + [spiece.NORMAL] * (len(pieces) - 3 - len(extra_control)))
    return pieces, scores, kinds


def _pb_write(path, pieces, scores, kinds, charsmap, add_dummy_prefix=True):
    """The same model written by protobuf itself."""
    pb = import_protobuf()
    m = pb.ModelProto()
    for p, s, t in zip(pieces, scores, kinds):
        m.pieces.add(piece=p, score=s, type=t)
    m.trainer_spec.model_type = 1
    m.trainer_spec.unk_id = 2
    m.trainer_spec.pad_id = -1  # a negative int32: a 10-byte varint
    m.trainer_spec.vocab_size = len(pieces)
    m.normalizer_spec.name = "nmt_nfkc"
    m.normalizer_spec.precompiled_charsmap = charsmap
    m.normalizer_spec.add_dummy_prefix = add_dummy_prefix
    m.normalizer_spec.remove_extra_whitespaces = False
    m.self_test_data.samples.add(input="a", expected="▁a")  # a field the reader skips
    Path(path).write_bytes(m.SerializeToString())
    return path


def _converted(path, extra_ids, **attrs):
    """transformers' T5Converter on ``path`` wrapped as T5TokenizerFast."""
    ids = {p.piece: i for i, p in enumerate(
        spiece_pb(path).pieces)}
    orig = types.SimpleNamespace(vocab_file=str(path), _extra_ids=extra_ids,
                                 convert_tokens_to_ids=ids.get, add_prefix_space=True,
                                 legacy=True, **attrs)
    tok = T5Converter(orig).converted()
    return transformers.T5TokenizerFast(tokenizer_object=tok, extra_ids=extra_ids)


def spiece_pb(path):
    m = import_protobuf().ModelProto()
    m.ParseFromString(Path(path).read_bytes())
    return m


def _assert_same(hf, me, texts, max_length=16):
    a = hf(texts, padding="max_length", truncation=True, max_length=max_length,
           return_tensors="np")
    b = me(texts, padding="max_length", truncation=True, max_length=max_length,
           return_tensors="np")
    for text, x, y in zip(texts, a["input_ids"], b["input_ids"]):
        assert x.tolist() == y.tolist(), (text, hf.convert_ids_to_tokens(x.tolist()),
                                          me.convert_ids_to_tokens(y.tolist()))
    np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
    for text in texts:
        ids = hf(text)["input_ids"]
        assert me.encode(text) == ids, text
        assert me.decode(ids, skip_special_tokens=True) == \
            hf.decode(ids, skip_special_tokens=True), text


def test_reader_equals_protobuf(tmp_path):
    """Every field the reader keeps, from a file protobuf wrote (with a
    negative int32 and a message the reader skips)."""
    pieces, scores, kinds = _model(1, extra_control=("<sep>",))
    blob = write_precompiled_charsmap(CHARSMAP)
    path = _pb_write(tmp_path / "spiece.model", pieces, scores, kinds, blob)
    m = spiece.read_spiece_model(Path(path).read_bytes())
    assert m.pieces == pieces and m.types == kinds
    assert m.scores == [float(np.float32(s)) for s in scores]
    assert (m.unk_id, m.model_type, m.byte_fallback) == (2, 1, False)
    assert m.precompiled_charsmap == blob
    assert (m.add_dummy_prefix, m.remove_extra_whitespaces) == (True, False)


def test_writer_is_read_by_protobuf(tmp_path):
    pieces, scores, kinds = _model(2)
    blob = write_precompiled_charsmap(CHARSMAP)
    path = spiece.write_spiece_model(str(tmp_path / "spiece.model"), pieces, scores, kinds,
                                     unk_id=2, precompiled_charsmap=blob,
                                     add_dummy_prefix=False, byte_fallback=True)
    pb = spiece_pb(path)
    assert [p.piece for p in pb.pieces] == pieces
    assert [p.type for p in pb.pieces] == kinds
    assert [p.score for p in pb.pieces] == [float(np.float32(s)) for s in scores]
    assert pb.trainer_spec.unk_id == 2 and pb.trainer_spec.byte_fallback
    assert pb.trainer_spec.model_type == 1
    assert pb.normalizer_spec.precompiled_charsmap == blob
    assert not pb.normalizer_spec.add_dummy_prefix
    assert pb.normalizer_spec.remove_extra_whitespaces
    m = spiece.read_spiece_model(Path(path).read_bytes())
    assert (m.pieces, m.types, m.unk_id, m.byte_fallback) == (pieces, kinds, 2, True)


@pytest.mark.parametrize("charsmap,extra_ids,user", [
    (CHARSMAP, 100, ()), (None, 8, ()), (CHARSMAP, 8, ("<sep>",))])
def test_tokenizer_equals_the_t5_converter(tmp_path, charsmap, extra_ids, user):
    """The tokenizer built from a protobuf-written file equals
    transformers' T5Converter on it (the converter's right strip, space runs
    to ``▁``, the dummy prefix on every word, user-defined pieces as added
    tokens), on seeded texts and runs of whitespace."""
    pieces, scores, kinds = _model(3, extra_control=user)
    blob = write_precompiled_charsmap(charsmap) if charsmap else b""
    path = _pb_write(tmp_path / "spiece.model", pieces, scores, kinds, blob)
    with open(tmp_path / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "T5Tokenizer", "extra_ids": extra_ids}, f)
    me = spiece.tokenizer_from_spiece(str(tmp_path))
    hf = _converted(path, extra_ids)
    rng = np.random.default_rng(5)
    frags = WORDS + [" ", "  ", "\t", "ａ", "é", "ﬁ", "<extra_id_0>", "</s>", "<sep>", "?"]
    drawn = ["".join(rng.choice(frags, rng.integers(1, 20))) for _ in range(40)]
    _assert_same(hf, me, TEXTS + drawn)
    assert len(me) == len(hf)


def test_spiece_from_the_committed_tokenizer_equals_tokenizers(tmp_path):
    """The committed Unigram fixture written as ``spiece.model`` (alone in
    its directory): the tokenizer built from it gives the ids, masks and
    strings ``tokenizers`` gives on the fixture's ``tokenizer.json`` (and
    the port's reader of that file), on texts where Flan-T5's published
    layout and the converter's agree (single spaces, no edge whitespace)."""
    with open(FIXTURE / "tokenizer.json", encoding="utf-8") as f:
        spec = json.load(f)
    only = tmp_path / "only"
    only.mkdir()
    spiece.spiece_from_tokenizer_json(spec, str(only / "spiece.model"))
    assert os.listdir(only) == ["spiece.model"]
    me = load_caption_tokenizer(str(only))
    hf = transformers.AutoTokenizer.from_pretrained(str(FIXTURE))
    texts = ["a photo of", "the cat on the mat", "ａ ｐｈｏｔｏ", "zq x", "", "a b c d e f " * 3]
    _assert_same(hf, me, texts)
    _assert_same(UnigramTokenizer.from_pretrained(str(FIXTURE)), me, texts)


def test_tokenizer_json_wins_over_spiece(tmp_path):
    """Where both files are present the tokenizer.json is read, as
    AutoTokenizer reads it; a config naming another class raises."""
    both = tmp_path / "both"
    shutil.copytree(FIXTURE, both)
    pieces, scores, kinds = _model(4)
    spiece.write_spiece_model(str(both / "spiece.model"), pieces, scores, kinds, unk_id=2)
    tok = load_caption_tokenizer(str(both))
    want = UnigramTokenizer.from_pretrained(str(FIXTURE))
    assert tok.pieces == want.pieces
    (both / "tokenizer.json").unlink()
    assert load_caption_tokenizer(str(both)).pieces[:len(pieces)] == pieces
    with open(both / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "LlamaTokenizer"}, f)
    with pytest.raises(NotImplementedError, match="LlamaTokenizer"):
        load_caption_tokenizer(str(both))
