"""The port's legacy retrievers (``models/legacy_retrievers.py``) against the
JAX package's, at the tiny widths of ``tests/test_engine_extras.py``: the
same inputs from a seed, the same weights carried by ``models/weights.py``
(``flmr_state_dict`` for VisualColBERT, ``legacy_retriever_state_dict`` for
the rest), every output and loss compared. One case per class and option;
the cases are one parametrised test.

Both sides in fp32 on the CPU (JAX at matmul precision "highest").
Tolerance 1e-5 (relative and absolute): fp32 round-off through two tiny
BERT layers and the tiny ViT.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.models import legacy_retrievers as jleg  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import legacy_retrievers as tleg  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import vit as tvit  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (  # noqa: E402
    fused_self_attention)
from test_torch_flmr_train import port_config  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B, NWAY, LQ, LD = 2, 2, 6, 10


def _port(jcfg):
    """The port's config with every field of the JAX one."""
    if isinstance(jcfg, jleg.FLMRConfig):
        return port_config(jcfg)
    d = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if isinstance(v, jleg.BertConfig):
            v = tbert.BertConfig(**dataclasses.asdict(v))
        elif isinstance(v, jleg.CLIPVisionConfig):
            v = tvit.CLIPVisionConfig(**dataclasses.asdict(v))
        d[f.name] = v
    return getattr(tleg, type(jcfg).__name__)(**d)


def _inputs():
    rng = np.random.default_rng(0)
    qi = rng.integers(5, 500, size=(B, LQ)).astype(np.int32)
    qm = np.ones((B, LQ), np.int32)
    qi[1, 4:], qm[1, 4:] = 0, 0
    di = rng.integers(5, 500, size=(B * NWAY, LD)).astype(np.int32)
    dm = np.ones((B * NWAY, LD), np.int32)
    di[2, 7:], dm[2, 7:] = 0, 0
    return rng, qi, qm, di, dm


def _case(name):
    """(JAX model, port class, port kwargs, call kwargs, carrier)."""
    rng, qi, qm, di, dm = _inputs()
    dpr = dict(query_input_ids=qi, query_attention_mask=qm, item_input_ids=di,
               item_attention_mask=dm, num_negative_examples=NWAY - 1)
    legacy = weights.legacy_retriever_state_dict
    if name == "visual_colbert":
        jm = jleg.VisualColBERT.build(jleg.BertConfig.tiny(), jleg.CLIPVisionConfig.tiny(),
                                      dim=16, prefix_length=4)
        pix = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
        call = dict(query_input_ids=qi, query_attention_mask=qm, query_pixel_values=pix,
                    context_input_ids=di, context_attention_mask=dm, num_negative_examples=1)
        return jm, tleg.VisualColBERT, {}, call, weights.flmr_state_dict
    if name.startswith("visual_dpr"):
        kw = dict(use_vision=True, projection_dim=16)
        if name.endswith("shared"):
            kw.update(separate_query_and_item_encoders=False, projection_dim=0)
        if name.endswith("k2"):
            kw.update(text_config=jleg.BertConfig.tiny(use_pallas_attention=True))
        dpr["query_pixel_values"] = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
        return jleg.VisualDPR(jleg.DPRConfig.tiny(**kw)), tleg.VisualDPR, {}, dpr, legacy
    if name == "retriever_dpr_bpr":
        return jleg.RetrieverDPR(jleg.DPRConfig.tiny(bpr=True)), tleg.RetrieverDPR, {}, dpr, legacy
    if name == "retriever_t5":
        return (jleg.RetrieverT5(jleg.DPRConfig.tiny(projection_dim=16)), tleg.RetrieverT5, {},
                dpr, legacy)
    if name.startswith("multiple_mapping"):
        cfg = jleg.MultiMappingConfig.tiny()
        rois = 2 if name.endswith("rois") else None
        shape = (B, cfg.vision_embedding_size) if rois is None else (
            B, rois, cfg.vision_embedding_size)
        feats = rng.normal(size=shape).astype(np.float32)
        call = dict(query_input_ids=qi, query_attention_mask=qm, query_image_features=feats,
                    item_input_ids=di, item_attention_mask=dm, num_negative_examples=1)
        port_kw = {} if rois is None else dict(
            vision_feature_size=rois * cfg.vision_embedding_size)
        return (jleg.VisualColBERTMultipleMapping(cfg), tleg.VisualColBERTMultipleMapping,
                port_kw, call, legacy)
    if name == "mae":
        cfg = jleg.MAERetrieverConfig.tiny()
        size = cfg.vision_config.image_size
        call = dict(query_pixel_values=rng.normal(size=(B, 3, size, size)).astype(np.float32),
                    item_input_ids=di, item_attention_mask=dm, num_negative_examples=1)
        return jleg.VisualColBERTMAE(cfg), tleg.VisualColBERTMAE, {}, call, legacy
    if name == "dpr_for_rag":
        cfg = jleg.DPRConfig.tiny(vision_prefix_length=3, projection_dim=12)
        feats = rng.normal(size=(B, cfg.vision_config.hidden_size)).astype(np.float32)
        call = dict(input_ids=qi, attention_mask=qm, image_features=feats)
        return (jleg.VisualDPRForRAG(cfg), tleg.VisualDPRForRAG,
                dict(vision_feature_size=cfg.vision_config.hidden_size), call, legacy)
    raise ValueError(name)


def _outputs(out):
    """The compared arrays of an output: a dataclass's fields or one array."""
    if dataclasses.is_dataclass(out):
        return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)
                if getattr(out, f.name) is not None}
    return {"out": out}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", [
    "visual_colbert", "visual_dpr", "visual_dpr_shared", "visual_dpr_k2",
    "retriever_dpr_bpr", "retriever_t5", "multiple_mapping", "multiple_mapping_rois", "mae",
    "dpr_for_rag"])
def test_legacy_retriever_matches_jax(name):
    jm, tcls, port_kw, call, carrier = _case(name)
    want, variables = jm.init_with_output(jax.random.PRNGKey(0), **call)
    params = jax.device_get(variables["params"])
    jcfg = jm.config
    tm = tcls(_port(jcfg), **port_kw, device="cpu")
    tm.load_state_dict(carrier(params))
    tcall = {k: (torch.tensor(v).long() if v.dtype.kind in "iu" else torch.tensor(v))
             if isinstance(v, np.ndarray) else v for k, v in call.items()}
    launches = fused_self_attention.launches
    with torch.no_grad():
        got = tm(**tcall)
    assert fused_self_attention.launches == launches  # CPU: K2's plain version
    want, got = _outputs(want), _outputs(got)
    assert set(got) == set(want)
    for key, w in want.items():
        g = _np(got[key])
        assert g.shape == np.asarray(w).shape, key
        if g.dtype == bool or g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)
        else:
            np.testing.assert_allclose(g, np.asarray(w), err_msg=key, **TOL)
