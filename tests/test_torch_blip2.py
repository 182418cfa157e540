"""The port's BLIP-2 (``models/blip2.py``: vision model, Q-Former,
language projection, Flan-T5 or OPT) against the JAX package, on the same
numpy inputs and the same weights (``models/weights.py::blip2_state_dict``).

Both sides run in fp32 on the CPU (JAX at matmul precision "highest"). The
weights are those of a JAX ``Blip2DecoderRerankModel`` (its init builds
every parameter of both LM families), with every LoRA ``lora_b`` set
non-zero. Tolerance 1e-4 abs / 1e-4 rel: fp32 round-off through the ViT,
the Q-Former and a few LM layers of LayerNorm'd order-1 activations.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.models import blip2 as jblip2  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import opt as jopt  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import t5 as jt5  # noqa: E402
from reranking_multimodal_retrievers_tpu.models.rerankers import decoder as jdec  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import blip2 as tblip2  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import opt as topt  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import t5 as tt5  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from test_torch_t5 import nonzero_lora  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
NWAY, L = 3, 9


def _np(x):
    return x.detach().float().numpy()


def port_blip2_config(jcfg):
    """The port's ``Blip2Config`` with the JAX config's values."""
    tc = jcfg.text_config
    text = (topt.OPTConfig if isinstance(tc, jopt.OPTConfig) else tt5.T5Config)(
        **dataclasses.asdict(tc))
    return tblip2.Blip2Config(
        vision_config=tblip2.Blip2VisionConfig(**dataclasses.asdict(jcfg.vision_config)),
        qformer_config=tblip2.Blip2QFormerConfig(**dataclasses.asdict(jcfg.qformer_config)),
        text_config=text, num_query_tokens=jcfg.num_query_tokens)


def rerank_io(seed):
    """NWAY prompts of L tokens for one image; rows 1 and 2 right-padded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 60, size=(NWAY, L)).astype(np.int32)
    am = np.ones((NWAY, L), np.int32)
    am[1, 6:] = 0
    am[2, 3:] = 0
    pix = rng.normal(size=(1, 3, 32, 32)).astype(np.float32)
    return rng, ids, am, pix


def jax_rerank_params(jreranker, seed, ids, am, pix, rng):
    params = jax.device_get(jreranker.init(jax.random.PRNGKey(seed), ids, am, pix,
                                           num_negative_examples=NWAY - 1)["params"])
    return nonzero_lora(params, rng)


def blip2_pair(opt: bool, seed: int = 0, **text_kw):
    text = (jopt.OPTConfig.tiny(**text_kw) if opt else jt5.T5Config.tiny(**text_kw))
    jcfg = jblip2.Blip2Config.tiny(text_config=text)
    rng, ids, am, pix = rerank_io(seed)
    jr = jdec.Blip2DecoderRerankModel(jdec.Blip2RerankConfig(blip2=jcfg, yes_token_id=10,
                                                             no_token_id=11))
    params = jax_rerank_params(jr, seed, ids, am, pix, rng)["model"]
    tm = tblip2.Blip2ForConditionalGeneration(port_blip2_config(jcfg), device="cpu")
    tm.load_state_dict(weights.blip2_state_dict(params))
    return jblip2.Blip2ForConditionalGeneration(jcfg), params, tm, ids, am, pix


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("opt", [False, True], ids=["t5", "opt"])
def test_vision_prefix_matches_jax(opt):
    jm, params, tm, _, _, pix = blip2_pair(opt)
    want = jm.apply({"params": params}, pix, method=jm.vision_prefix)
    with torch.no_grad():
        got = tm.vision_prefix(torch.as_tensor(pix))
    assert got.shape == (1, 4, 16)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("lora_r", [0, 2])
def test_blip2_t5_forward_matches_jax(lora_r):
    """[vision prefix ; prompt] through the Flan-T5 encoder and two decoder
    positions; the encoder states and combined mask too."""
    jm, params, tm, ids, am, pix = blip2_pair(False, seed=1, lora_r=lora_r)
    dec = np.array([[0, 5]] * NWAY, np.int32)
    pix3 = np.repeat(pix, NWAY, 0)
    want_logits, want_hidden = jm.apply({"params": params}, ids, am, dec, pixel_values=pix3)
    want_enc, want_mask = jm.apply({"params": params}, ids, am, pixel_values=pix3,
                                   method=jm.encode_for_generation)
    tids, tam, tdec, tpix = _t(ids, am, dec, pix3)
    with torch.no_grad():
        logits, hidden = tm(tids.long(), tam, tdec.long(), pixel_values=tpix)
        enc, mask = tm.encode_for_generation(tids.long(), tam, pixel_values=tpix)
        step = tm.decode_logits(tdec.long(), enc, mask)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(_np(enc), np.asarray(want_enc), **TOL)
    np.testing.assert_allclose(_np(hidden), np.asarray(want_hidden), **TOL)
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(_np(step), np.asarray(want_logits), **TOL)


@pytest.mark.parametrize("lora_r", [0, 2])
def test_blip2_opt_causal_lm_matches_jax(lora_r):
    """Full-sequence logits and hidden states over [vision prefix ; prompt]
    (right-padded rows included: they carry position ids and masks)."""
    jm, params, tm, ids, am, pix = blip2_pair(True, seed=2, lora_r=lora_r)
    prefix = jm.apply({"params": params}, pix, method=jm.vision_prefix)
    prefix3 = np.repeat(np.asarray(prefix), NWAY, 0)
    want_logits, want_hidden, want_mask = jm.apply(
        {"params": params}, ids, am, vision_prefix=prefix3, method=jm.causal_lm_logits)
    tids, tam, tprefix = _t(ids, am, prefix3)
    with torch.no_grad():
        logits, hidden, mask = tm.causal_lm_logits(tids.long(), tam, vision_prefix=tprefix)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(_np(hidden), np.asarray(want_hidden), **TOL)
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), **TOL)


def test_causal_last_hidden_on_right_padded_rows():
    """Each row's state at ``prefix_len + sum(mask) - 1``: its own last real
    prompt token, never a shared pad column."""
    jm, params, tm, ids, am, pix = blip2_pair(True, seed=3)
    pix3 = np.repeat(pix, NWAY, 0)
    want = jm.apply({"params": params}, ids, am, pixel_values=pix3,
                    method=jm.causal_last_hidden)
    tids, tam, tpix = _t(ids, am, pix3)
    with torch.no_grad():
        got = tm.causal_last_hidden(tids.long(), tam, pixel_values=tpix)
        _, hidden, _ = tm.causal_lm_hidden(tids.long(), tam, pixel_values=tpix)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    last = 4 + am.sum(axis=1) - 1  # prefix of 4 query tokens
    assert list(last) == [12, 9, 6]
    np.testing.assert_array_equal(got.numpy(), hidden[np.arange(NWAY), last].numpy())


def test_blip2_opt_needs_equal_embed_and_hidden_width():
    cfg = tblip2.Blip2Config.tiny_opt(text_config=topt.OPTConfig.tiny(word_embed_proj_dim=8))
    with pytest.raises(ValueError, match="word_embed_proj_dim"):
        tblip2.Blip2ForConditionalGeneration(cfg, device="meta")
