"""The port's decoder rerankers (``models/rerankers/decoder.py``: the two
compact ``VisionSeq2SeqLM`` models, the two BLIP-2 models over Flan-T5 and
OPT, ``prepare_decoder_rerank_inputs``) and ``make_decoder_rerank_fn``
against the JAX package, on the same numpy inputs and the same weights
(``models/weights.py::decoder_rerank_state_dict`` /
``blip2_rerank_state_dict``).

Both sides run in fp32 on the CPU; every LoRA ``lora_b`` is set non-zero.
Tolerance 1e-4 abs / 1e-4 rel on losses, p(yes) and head logits: fp32
round-off through a few layers of order-1 activations.
"""

import dataclasses
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.models import blip2 as jblip2  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import opt as jopt  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import t5 as jt5  # noqa: E402
from reranking_multimodal_retrievers_tpu.models.rerankers import decoder as jdec  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import make_decoder_rerank_fn  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import vit as tvit  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.rerankers import decoder as tdec  # noqa: E402
from test_torch_blip2 import NWAY, jax_rerank_params, port_blip2_config, rerank_io  # noqa: E402
from test_torch_t5 import nonzero_lora  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return x.detach().float().numpy()


def _check(got, want, with_loss=True):
    np.testing.assert_allclose(_np(got.logits), np.asarray(want.logits), **TOL)
    if with_loss:
        np.testing.assert_allclose(float(got.loss), float(want.loss), **TOL)


# ---- the compact VisionSeq2SeqLM backbone ----------------------------------

def _compact_batch(seed):
    rng = np.random.default_rng(seed)
    B, nway, L = 2, 3, 12
    ids = rng.integers(20, 1000, size=(B * nway, L)).astype(np.int32)
    am = np.ones((B * nway, L), np.int32)
    am[1, 8:] = 0
    pix = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
    return rng, ids, am, pix, nway - 1


def _port_compact_config(jcfg):
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["text_config"] = tbert.BertConfig(**dataclasses.asdict(jcfg.text_config))
    d["vision_config"] = tvit.CLIPVisionConfig(**dataclasses.asdict(jcfg.vision_config))
    return tdec.DecoderRerankConfig(**d)


@pytest.mark.parametrize("head,loss_fn,lora_r", [
    (False, "BCE", 8),
    (False, "BCE", 0),
    (True, "BCE", 8),
    (True, "2H_BCE", 4),
    (True, "negative_sampling", 8),
])
def test_compact_decoder_rerankers_match_jax(head, loss_fn, lora_r):
    jcfg = jdec.DecoderRerankConfig.tiny(loss_fn=loss_fn, lora_r=lora_r)
    rng, ids, am, pix, n_neg = _compact_batch(0)
    jm = (jdec.DecoderHeadRerankModel if head else jdec.DecoderRerankModel)(jcfg)
    params = nonzero_lora(jax.device_get(
        jm.init(jax.random.PRNGKey(0), ids, am, pix, num_negative_examples=n_neg)["params"]), rng)
    tm = (tdec.DecoderHeadRerankModel if head else tdec.DecoderRerankModel)(
        _port_compact_config(jcfg), device="cpu")
    tm.load_state_dict(weights.decoder_rerank_state_dict(params))
    labels = np.array([0, 1, 0, 1, 0, 0], np.int32)
    for lbl in (None, labels):
        want = jm.apply({"params": params}, ids, am, pix, num_negative_examples=n_neg,
                        labels=lbl)
        with torch.no_grad():
            got = tm(torch.as_tensor(ids).long(), torch.as_tensor(am), torch.as_tensor(pix),
                     num_negative_examples=n_neg,
                     labels=None if lbl is None else torch.as_tensor(lbl))
        _check(got, want)


# ---- the BLIP-2 rerankers ---------------------------------------------------

def blip2_rerankers(opt: bool, head: bool, seed: int, loss_fn: str = "BCE", lora_r: int = 2):
    text = (jopt.OPTConfig.tiny(lora_r=lora_r) if opt
            else jt5.T5Config.tiny(lora_r=lora_r))
    jcfg = jdec.Blip2RerankConfig(blip2=jblip2.Blip2Config.tiny(text_config=text),
                                  yes_token_id=10, no_token_id=11, loss_fn=loss_fn)
    rng, ids, am, pix = rerank_io(seed)
    jm = (jdec.Blip2DecoderHeadRerankModel if head else jdec.Blip2DecoderRerankModel)(jcfg)
    params = jax_rerank_params(jm, seed, ids, am, pix, rng)
    tcfg = tdec.Blip2RerankConfig(blip2=port_blip2_config(jcfg.blip2), yes_token_id=10,
                                  no_token_id=11, loss_fn=loss_fn)
    tm = (tdec.Blip2DecoderHeadRerankModel if head else tdec.Blip2DecoderRerankModel)(
        tcfg, device="cpu")
    tm.load_state_dict(weights.blip2_rerank_state_dict(params))
    return jm, params, tm, ids, am, pix


@pytest.mark.parametrize("opt", [False, True], ids=["t5", "opt"])
@pytest.mark.parametrize("head,loss_fn", [(False, "BCE"), (True, "BCE"), (True, "2H_BCE")])
def test_blip2_rerankers_match_jax(opt, head, loss_fn):
    """Loss and logits from pixels, with the default and explicit labels,
    and through ``vision_feats`` (the prefix computed once per image and
    broadcast over the candidates)."""
    jm, params, tm, ids, am, pix = blip2_rerankers(opt, head, seed=4, loss_fn=loss_fn)
    tids, tam, tpix = (torch.as_tensor(x) for x in (ids, am, pix))
    labels = np.array([0, 0, 1], np.int32)
    for lbl in (None, labels):
        want = jm.apply({"params": params}, ids, am, pix, num_negative_examples=NWAY - 1,
                        labels=lbl)
        with torch.no_grad():
            got = tm(tids.long(), tam, tpix, num_negative_examples=NWAY - 1,
                     labels=None if lbl is None else torch.as_tensor(lbl))
        _check(got, want)
    with torch.no_grad():
        feats = tm.encode_vision(tpix).repeat(NWAY, 1, 1)
        via_feats = tm(tids.long(), tam, None, num_negative_examples=NWAY - 1,
                       labels=torch.as_tensor(labels), vision_feats=feats)
    _check(via_feats, want)


@pytest.mark.parametrize("opt", [False, True], ids=["t5", "opt"])
def test_decoder_rerank_fn_matches_jax_reranker(opt):
    """The chunked program (prefix once, LM over chunks of 1 row, one
    decode or vocabulary projection over all rows) gives the reranker's
    p(yes)."""
    jm, params, tm, ids, am, pix = blip2_rerankers(opt, head=False, seed=5)
    want = jm.apply({"params": params}, ids, am, pix, num_negative_examples=NWAY - 1)
    for chunk in (1, 3):
        got = make_decoder_rerank_fn(tm, chunk_size=chunk)(
            torch.as_tensor(ids).long(), torch.as_tensor(am), torch.as_tensor(pix))
        assert got.shape == (NWAY,)
        np.testing.assert_allclose(_np(got), np.asarray(want.logits)[:, 0], **TOL)


# ---- prompts ----------------------------------------------------------------

@pytest.mark.parametrize("generation_token", [False, True])
def test_prepare_decoder_rerank_inputs_matches_jax(generation_token):
    from reranking_multimodal_retrievers_tpu.models.tokenization import tiny_bert_tokenizer

    tok = tiny_bert_tokenizer(
        tempfile.mkdtemp(), ["query", "document", "relevant", "paris", "france", "what"])
    args = (["what paris", "france"], ["paris", "france", "what", "paris france what"], tok)
    kw = dict(max_query_length=3, max_context_length=4, max_decoder_source_length=16,
              docs_per_query=2, generation_token=generation_token)
    want = jdec.prepare_decoder_rerank_inputs(*args, **kw)
    got = tdec.prepare_decoder_rerank_inputs(*args, **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("loss_fn", ["BCE", "2H_BCE", "negative_sampling"])
@pytest.mark.parametrize("pos_weight", [None, 3.0])
def test_rerank_loss_matches_jax(loss_fn, pos_weight):
    """``losses.py::rerank_loss`` (forward) on the logits and labels
    ``prepare_logits_labels`` shapes, with and without ``pos_weight``."""
    from reranking_multimodal_retrievers_tpu.models.rerankers import losses as jlosses
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import losses as tlosses

    rng = np.random.default_rng(6)
    l1, l2 = (rng.normal(size=(6, 1)).astype(np.float32) for _ in range(2))
    labels = np.array([0, 1, 0, 1, 0, 0], np.float32)
    jl, jlbl = jlosses.prepare_logits_labels(loss_fn, l1, l2, 2, 2, labels)
    tl, tlbl = tlosses.prepare_logits_labels(loss_fn, torch.as_tensor(l1), torch.as_tensor(l2),
                                             2, 2, torch.as_tensor(labels))
    want = float(jlosses.rerank_loss(loss_fn, jl, jlbl, pos_weight))
    got = float(tlosses.rerank_loss(loss_fn, tl, tlbl, pos_weight))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
