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
    """The name is kept from when the port refused options; it now holds the
    opposite. Every BERT option builds now: ``quantize_int8`` (held against the JAX
    package in ``tests/test_torch_quant.py``) and ``use_flash_attention``,
    which was refused here before (held below)."""
    for kw in (dict(quantize_int8=True), dict(use_flash_attention=True)):
        m = tbert.BertModel(tbert.BertConfig.tiny(**kw), device="cpu")
        with torch.no_grad():
            out = m(torch.ones(1, 4, dtype=torch.long), torch.ones(1, 4, dtype=torch.long))
        assert torch.isfinite(out["last_hidden_state"]).all()
    layer = tbert.BertModel(tbert.BertConfig.tiny(quantize_int8=True), device="cpu").encoder.layer[0]
    assert type(layer.attention.self.query).__name__ == "Int8Linear"


def test_attention_route_matches_jax():
    """``flash_block_q`` is the JAX package's tile choice
    (``models/bert.py:157-158``) at every length; every length padded to a
    multiple of 128 has one, so the gate's length test is ``L >= 256``."""
    for L in range(1, 1100):
        L_pad = -(-L // 128) * 128
        want = next((b for b in (512, 256, 128) if L_pad % b == 0), None)
        assert tbert.flash_block_q(L) == want
    cfg = tbert.BertConfig.tiny(use_flash_attention=True)

    def route(c, L, can_flash, cross, heads=12, hd=64):
        return tbert.attention_route(c, L, can_flash, cross, heads, hd)

    assert [route(cfg, L, True, False) for L in (128, 255, 256, 384)] == [
        "unfused", "unfused", "flash", "flash"]
    assert route(cfg, 384, False, False) == "unfused"  # attention fusion: no flash
    assert route(cfg, 384, True, True) == "unfused"  # cross-attention
    both = tbert.BertConfig.tiny(use_flash_attention=True, use_pallas_attention=True)
    assert route(both, 384, True, False) == "k2"  # K2 takes precedence
    # a geometry the JAX gate refuses: JAX's use_flash (``not use_pallas``
    # counts only an admitted kernel) then takes it
    assert route(both, 384, True, False, heads=4, hd=16) == "flash"
    k2 = tbert.BertConfig.tiny(use_pallas_attention=True)
    assert [route(k2, L, True, False) for L in (8, 369, 640)] == ["k2"] * 3  # any L
    assert route(k2, 384, True, True) == route(k2, 384, False, False) == "unfused"
    assert route(k2, 384, True, False, heads=4, hd=16) == "unfused"
    assert route(tbert.BertConfig.tiny(), 384, True, False) == "unfused"


@pytest.mark.parametrize("L,case", [(256, "flash"), (384, "flash"), (128, "fallback"),
                                    (255, "fallback"), (384, "pallas_precedence")])
def test_bert_flash_attention(L, case):
    """``use_flash_attention`` at tiny width with right padding. Real rows
    match the JAX package's unfused path within 1e-5 (a real token attends
    only real tokens either way); every row matches the plain segment-mask
    version (the same weights on the unfused path with a [B, L, L] bias
    that is 0 within a segment and -1e9 across). Below 256 the gate falls
    back to the unfused path, where pad rows attend real keys: every row
    then matches JAX's; so does K2's path, which takes precedence. At
    L >= 256 the pad rows differ from the unfused path's."""
    kw = dict(max_position_embeddings=512)
    if case == "pallas_precedence":  # a head geometry both gates admit: 2 x 64
        kw.update(hidden_size=128, num_attention_heads=2)
    jcfg = jbert.BertConfig.tiny(**kw)
    rng = np.random.default_rng(L)
    ids, am = _ids(rng, 2, L, pad_from=[L - 37, L // 2])
    jm = jbert.BertModel(jcfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), ids, am)["params"])
    want = np.asarray(jm.apply({"params": params}, ids, am)["last_hidden_state"])

    tkw = dict(kw, use_flash_attention=True,
               use_pallas_attention=case == "pallas_precedence")
    tm = tbert.BertModel(tbert.BertConfig.tiny(**tkw), device="cpu")
    tm.load_state_dict(weights.bert_state_dict(params))
    tids, tam = torch.as_tensor(ids).long(), torch.as_tensor(am)
    seg = tam.bool()
    seg_bias = torch.where(seg[:, :, None] == seg[:, None, :], 0.0, -1e9)
    with torch.no_grad():
        got = _np(tm(tids, tam)["last_hidden_state"])
        plain = _np(tm(tids, None, attention_adj=seg_bias)["last_hidden_state"])
    real = am.astype(bool)
    np.testing.assert_allclose(got[real], want[real], rtol=1e-5, atol=1e-5)
    if case == "flash":
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
        assert np.abs(got[~real] - want[~real]).max() > 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
