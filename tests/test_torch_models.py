"""The port's BERT, CLIP-ViT and FLMR query/doc encoders against the JAX
models, on the same inputs and the same weights (carried over by
``reranking_multimodal_retrievers_tpu_torch/models/weights.py``).

Both sides run in fp32 on the CPU (JAX at matmul precision "highest", set by
conftest). Tolerance 1e-4 abs / 1e-4 rel: fp32 round-off of a few layers of
LayerNorm'd activations of order 1, summed in a different order on each side.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.models import bert as jbert  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import flmr as jflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import vit as jvit  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import flmr as tflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import vit as tvit  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (  # noqa: E402
    fused_self_attention,
)

TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return np.asarray(x.detach().float().numpy() if hasattr(x, "detach") else x)


def _ids(rng, B, L, pad_from=None):
    ids = rng.integers(1, 1000, size=(B, L)).astype(np.int32)
    am = np.ones((B, L), np.int32)
    if pad_from is not None:
        for b, n in enumerate(pad_from):
            ids[b, n:] = 0
            am[b, n:] = 0
    return ids, am


# hd 64 with 2 heads: the JAX Pallas attention gate accepts it, so the
# use_pallas_attention case runs the interpret-mode Pallas kernel on the JAX
# side against the port's K2 wrapper (plain version on the CPU)
_WIDE = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256)


@pytest.mark.parametrize("case", ["plain", "pallas_attention", "serving_knobs"])
def test_bert_matches_jax(case):
    kw = dict(_WIDE)
    if case == "pallas_attention":
        kw["use_pallas_attention"] = True
    if case == "serving_knobs":
        kw.update(gelu_approximate=True, attention_scores_bf16=True)
    cfg = jbert.BertConfig.tiny(**kw)
    rng = np.random.default_rng(0)
    ids, am = _ids(rng, 2, 16, pad_from=[16, 9])
    tt = rng.integers(0, 2, size=(2, 16)).astype(np.int32)
    jm = jbert.BertModel(cfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), ids, am, tt)["params"])
    want = jm.apply({"params": params}, ids, am, tt)

    tm = tbert.BertModel(tbert.BertConfig.tiny(**kw), device="cpu")
    tm.load_state_dict(weights.bert_state_dict(params))
    launches = fused_self_attention.launches
    with torch.no_grad():
        got = tm(torch.as_tensor(ids).long(), torch.as_tensor(am),
                 torch.as_tensor(tt).long())
    assert fused_self_attention.launches == launches  # CPU: plain version
    np.testing.assert_allclose(_np(got["last_hidden_state"]),
                               np.asarray(want["last_hidden_state"]), **TOL)
    np.testing.assert_allclose(_np(got["pooler_output"]),
                               np.asarray(want["pooler_output"]), **TOL)


def test_bert_encoder_cross_attention_matches_jax():
    """The mapping-network form: a bare BertEncoder with cross-attention to
    encoder states under an all-ones additive mask."""
    cfg = jbert.BertConfig.tiny(num_hidden_layers=1, add_cross_attention=True)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    enc = rng.normal(size=(3, 5, 32)).astype(np.float32)
    enc_bias = np.asarray(jbert.additive_mask(jnp.ones((3, 5), jnp.int32)))
    je = jbert.BertEncoder(cfg)
    params = jax.device_get(je.init(jax.random.PRNGKey(1), x, None, enc, enc_bias)["params"])
    want, _ = je.apply({"params": params}, x, None, enc, enc_bias)

    with torch.device("meta"):
        te = tbert.BertEncoder(tbert.BertConfig.tiny(num_hidden_layers=1,
                                                     add_cross_attention=True))
    sd = {}
    weights._bert_encoder(sd, "", params)
    te.load_state_dict({k[1:]: v for k, v in sd.items()}, assign=True)
    with torch.no_grad():
        got, hidden = te(torch.as_tensor(x), None, torch.as_tensor(enc),
                         torch.tensor(enc_bias))
    assert len(hidden) == 2
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_vit_matches_jax():
    cfg = jvit.CLIPVisionConfig.tiny()
    rng = np.random.default_rng(2)
    pix = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    jm = jvit.CLIPVisionModel(cfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(2), pix)["params"])
    want = jm.apply({"params": params}, pix)

    tm = tvit.CLIPVisionModel(tvit.CLIPVisionConfig.tiny(), device="cpu")
    tm.load_state_dict(weights.clip_vision_state_dict(params))
    with torch.no_grad():
        got = tm(torch.as_tensor(pix))
    for key in ("last_hidden_state", "pooler_output"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), **TOL)
    np.testing.assert_allclose(_np(got["hidden_states"][-2]),
                               np.asarray(want["hidden_states"][-2]), **TOL)


def _flmr_pair(seed=3, **kw):
    """A tiny FLMR on both sides with the same weights (hd 64, so the JAX
    text encoders take the interpret-mode Pallas attention)."""
    text = jbert.BertConfig.tiny(use_pallas_attention=True, **_WIDE)
    jcfg = jflmr.FLMRConfig.tiny(text_config=text, **kw)
    tcfg = tflmr.FLMRConfig.tiny(
        text_config=tbert.BertConfig.tiny(use_pallas_attention=True, **_WIDE), **kw)
    rng = np.random.default_rng(seed)
    ids, am = _ids(rng, 2, 16, pad_from=[16, 11])
    ids[0, 3] = 5  # a punctuation id: masked on the doc side
    pix = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    jm = jflmr.FLMRModelForRetrieval(jcfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), ids, am, ids, am,
                                    query_pixel_values=pix,
                                    context_pixel_values=pix,
                                    num_negative_examples=0)["params"])
    tm = tflmr.FLMRModelForRetrieval(tcfg, device="cpu")
    tm.load_state_dict(weights.flmr_state_dict(params))
    return jm, params, tm, ids, am, pix


@pytest.mark.parametrize("with_image", [True, False])
def test_flmr_query_matches_jax(with_image):
    jm, params, tm, ids, am, pix = _flmr_pair()
    jpix = pix if with_image else None
    want = jm.apply({"params": params}, ids, am, pixel_values=jpix,
                    method=jflmr.FLMRModelForRetrieval.query)
    with torch.no_grad():
        got = tm.query(torch.as_tensor(ids).long(), torch.as_tensor(am),
                       pixel_values=torch.as_tensor(pix) if with_image else None)
    # 16 text + 4 prefix + 4 mapped patch tokens with the image
    assert got.late_interaction_output.shape == (2, 24 if with_image else 16, 16)
    np.testing.assert_allclose(_np(got.late_interaction_output),
                               np.asarray(want.late_interaction_output), **TOL)
    np.testing.assert_array_equal(_np(got.query_mask), np.asarray(want.query_mask))


@pytest.mark.parametrize("multimodal_docs", [False, True])
def test_flmr_doc_matches_jax(multimodal_docs):
    kw = dict(context_concat_output_from_vision_encoder=multimodal_docs)
    jm, params, tm, ids, am, pix = _flmr_pair(seed=4, **kw)
    jpix = pix if multimodal_docs else None
    want = jm.apply({"params": params}, ids, am, pixel_values=jpix,
                    method=jflmr.FLMRModelForRetrieval.doc)
    with torch.no_grad():
        got = tm.doc(torch.as_tensor(ids).long(), torch.as_tensor(am),
                     pixel_values=torch.as_tensor(pix) if multimodal_docs else None)
    np.testing.assert_allclose(_np(got.late_interaction_output),
                               np.asarray(want.late_interaction_output), **TOL)
    np.testing.assert_array_equal(_np(got.context_mask), np.asarray(want.context_mask))
    assert not got.context_mask[0, 3 + (4 if multimodal_docs else 0)]  # punctuation


def test_unported_bert_options_raise():
    for kw in (dict(use_flash_attention=True), dict(quantize_int8=True)):
        with pytest.raises(NotImplementedError):
            tbert.BertModel(tbert.BertConfig.tiny(**kw), device="cpu")
