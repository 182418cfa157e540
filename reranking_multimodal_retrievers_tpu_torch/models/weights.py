"""Carry the JAX package's flax parameter trees into the port's state dicts.

Each function takes a flax parameter tree as nested dicts of numpy arrays
(the caller does ``jax.device_get`` on its side; this module imports no JAX)
and returns a ``state_dict`` for the matching port model, with HuggingFace
parameter names. The conversions are the inverse of the JAX package's
``models/hf_bridge.py`` (whose FLMR part the end of the module also copies,
for ``tools/convert_checkpoint.py::export_npz``): a flax ``Dense`` kernel ``[in, out]`` becomes a
``Linear.weight`` ``[out, in]``, a LayerNorm ``scale`` becomes ``weight``, an
``Embed`` table becomes ``weight``, and a conv kernel HWIO becomes OIHW.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

Tree = Mapping[str, object]
StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _dense(sd: StateDict, name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _layernorm(sd: StateDict, name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _embed(sd: StateDict, name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(p["embedding"])


def _bert_attention(sd: StateDict, prefix: str, p: Tree) -> None:
    for n in ("query", "key", "value"):
        _dense(sd, f"{prefix}.self.{n}", p[n])
    _dense(sd, f"{prefix}.output.dense", p["out"])
    _layernorm(sd, f"{prefix}.output.LayerNorm", p["layernorm"])


def _bert_encoder(sd: StateDict, prefix: str, p: Tree) -> None:
    i = 0
    while f"layer_{i}" in p:
        lp, lpre = p[f"layer_{i}"], f"{prefix}.layer.{i}"
        _bert_attention(sd, f"{lpre}.attention", lp["attention"])
        if "crossattention" in lp:
            _bert_attention(sd, f"{lpre}.crossattention", lp["crossattention"])
        _dense(sd, f"{lpre}.intermediate.dense", lp["intermediate"])
        _dense(sd, f"{lpre}.output.dense", lp["output"])
        _layernorm(sd, f"{lpre}.output.LayerNorm", lp["layernorm"])
        i += 1


def _bert(sd: StateDict, prefix: str, p: Tree) -> None:
    emb = p["embeddings"]
    for n in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        if n in emb:
            _embed(sd, f"{prefix}embeddings.{n}", emb[n])
    _layernorm(sd, f"{prefix}embeddings.LayerNorm", emb["layernorm"])
    _bert_encoder(sd, f"{prefix}encoder", p["encoder"])
    if "pooler" in p:
        _dense(sd, f"{prefix}pooler.dense", p["pooler"])


def _clip(sd: StateDict, prefix: str, p: Tree) -> None:
    emb = p["embeddings"]
    sd[f"{prefix}embeddings.class_embedding"] = _t(emb["class_embedding"])
    sd[f"{prefix}embeddings.patch_embedding.weight"] = _t(
        np.asarray(emb["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}embeddings.position_embedding.weight"] = _t(emb["position_embedding"])
    _layernorm(sd, f"{prefix}pre_layrnorm", p["pre_layrnorm"])
    _layernorm(sd, f"{prefix}post_layernorm", p["post_layernorm"])
    i = 0
    while f"layer_{i}" in p:
        lp, lpre = p[f"layer_{i}"], f"{prefix}encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{lpre}.self_attn.{n}", lp["self_attn"][n])
        _layernorm(sd, f"{lpre}.layer_norm1", lp["layer_norm1"])
        _layernorm(sd, f"{lpre}.layer_norm2", lp["layer_norm2"])
        _dense(sd, f"{lpre}.mlp.fc1", lp["fc1"])
        _dense(sd, f"{lpre}.mlp.fc2", lp["fc2"])
        i += 1


def _projection(sd: StateDict, prefix: str, p: Tree) -> None:
    _dense(sd, f"{prefix}.model.0", p["fc1"])
    _dense(sd, f"{prefix}.model.2", p["fc2"])


def bert_state_dict(params: Tree) -> StateDict:
    """Flax ``BertModel`` params -> the port's ``BertModel`` state dict."""
    sd: StateDict = {}
    _bert(sd, "", params)
    return sd


def sentence_reader_state_dict(params: Tree) -> StateDict:
    """Flax ``SentenceReader`` params (``engine/condenser.py``) -> the port's
    ``SentenceReader`` state dict: ``encoder.*`` and ``linear.*``."""
    sd: StateDict = {}
    _bert(sd, "encoder.", params["encoder"])
    _dense(sd, "linear", params["linear"])
    return sd


def clip_vision_state_dict(params: Tree) -> StateDict:
    """Flax ``CLIPVisionModel`` params -> the port's ``CLIPVisionModel``."""
    sd: StateDict = {}
    _clip(sd, "vision_model.", params)
    return sd


def vae_encoder_state_dict(params: Tree) -> StateDict:
    """The JAX feature node's flax VAE encoder params (``conv_16``,
    ``conv_32``, ``conv_64``, ``mean``, ``logvar``) -> the port's
    ``data/ops/feature_ops.py::VAEEncoder``. The port flattens in NHWC
    order as flax does, so the dense kernels only transpose."""
    sd: StateDict = {}
    for i, feat in enumerate((16, 32, 64)):
        p = params[f"conv_{feat}"]
        sd[f"convs.{i}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        sd[f"convs.{i}.bias"] = _t(p["bias"])
    _dense(sd, "mean", params["mean"])
    _dense(sd, "logvar", params["logvar"])
    return sd


def _backbone(sd: StateDict, params: Tree) -> None:
    """Modules shared by FLMR and the monoPreFLMR rerankers."""
    _bert(sd, "context_text_encoder.bert_model.", params["context_text_encoder"])
    _dense(sd, "context_text_encoder_linear", params["context_text_encoder_linear"])
    if "context_vision_encoder" in params:
        _clip(sd, "context_vision_encoder.vision_model.vision_model.",
              params["context_vision_encoder"])
        _projection(sd, "context_vision_projection", params["context_vision_projection"])
    if "transformer_mapping_network" in params:
        _dense(sd, "transformer_mapping_input_linear",
               params["transformer_mapping_input_linear"])
        _bert_encoder(sd, "transformer_mapping_network",
                      params["transformer_mapping_network"])
        _dense(sd, "transformer_mapping_output_linear",
               params["transformer_mapping_output_linear"])


def flmr_state_dict(params: Tree) -> StateDict:
    """Flax ``FLMRModelForRetrieval`` params -> the port's
    ``FLMRModelForRetrieval`` state dict (tied or separate encoders)."""
    sd: StateDict = {}
    _backbone(sd, params)
    if "query_text_encoder" in params:
        _bert(sd, "query_text_encoder.bert_model.", params["query_text_encoder"])
        _dense(sd, "query_text_encoder_linear", params["query_text_encoder_linear"])
    if "query_vision_encoder" in params:
        _clip(sd, "query_vision_encoder.vision_model.vision_model.",
              params["query_vision_encoder"])
        _projection(sd, "query_vision_projection", params["query_vision_projection"])
    return sd


def rerank_state_dict(params: Tree) -> StateDict:
    """Flax ``FullContextRerankModel`` params -> the port's
    ``FullContextRerankModel`` state dict."""
    sd: StateDict = {}
    _backbone(sd, params)
    _dense(sd, "cross_encoder_input_mapping", params["cross_encoder_input_mapping"])
    ce = params["reranker"]
    _bert(sd, "reranker.bert_model.", ce["bert_model"])
    _dense(sd, "reranker.classifier1", ce["classifier1"])
    _dense(sd, "reranker.classifier2", ce["classifier2"])
    return sd



def interaction_rerank_state_dict(params: Tree) -> StateDict:
    """Flax ``InteractionRerankModel`` params (CrossEncoder or MORES type) ->
    the port's ``InteractionRerankModel`` state dict."""
    sd: StateDict = {}
    _dense(sd, "cross_encoder_input_mapping", params["cross_encoder_input_mapping"])
    ce = params["reranker"]
    if "bert_model" in ce:
        _bert(sd, "reranker.bert_model.", ce["bert_model"])
    i = 0
    while f"layer_{i}" in ce:
        lp, lpre = ce[f"layer_{i}"], f"reranker.layers.{i}"
        _bert_attention(sd, f"{lpre}.crossattention", lp["crossattention"])
        _bert_attention(sd, f"{lpre}.attention", lp["attention"])
        for n in ("intermediate", "output"):
            _dense(sd, f"{lpre}.{n}", lp[n])
        _layernorm(sd, f"{lpre}.layernorm", lp["layernorm"])
        i += 1
    _dense(sd, "reranker.classifier1", ce["classifier1"])
    _dense(sd, "reranker.classifier2", ce["classifier2"])
    return sd


def legacy_retriever_state_dict(params: Tree) -> StateDict:
    """Flax params of a legacy retriever (``VisualDPR``, ``RetrieverDPR``,
    ``RetrieverT5``, ``VisualColBERTMultipleMapping``, ``VisualColBERTMAE``
    or ``VisualDPRForRAG``) -> the port's state dict; ``VisualColBERT``'s
    are ``flmr_state_dict``'s. BERTs keep their names, the CLIP ViT is
    ``vision_encoder.vision_model``, a two-layer vision MLP keeps ``fc1`` /
    ``fc2`` (``vision_projection_<i>`` becomes ``vision_projections.<i>``)
    and MAE's mapping encoder is ``vision_projection``."""
    sd: StateDict = {}
    for name, p in params.items():
        if name in ("query_encoder", "item_encoder", "text_encoder", "encoder"):
            _bert(sd, f"{name}.", p)
        elif name == "vision_encoder":
            _clip(sd, "vision_encoder.vision_model.", p)
        elif "layer_0" in p:
            _bert_encoder(sd, name, p)
        elif "fc1" in p:
            prefix = name.replace("vision_projection_", "vision_projections.")
            _dense(sd, f"{prefix}.fc1", p["fc1"])
            _dense(sd, f"{prefix}.fc2", p["fc2"])
        else:
            _dense(sd, name, p)
    return sd

# ---- the decoder rerankers: LoRA, T5, OPT, BLIP-2 ---------------------------

def _linear(sd: StateDict, name: str, p: Tree) -> None:
    """A flax ``Dense``, or a ``LoRADense`` (``base`` + ``lora_a [in, r]`` +
    ``lora_b [r, out]``) -> ``Linear`` / ``LoRALinear`` weights, the adapters
    stored as linear weights ``lora_a [r, in]`` and ``lora_b [out, r]``."""
    _dense(sd, name, p.get("base", p))
    if "lora_a" in p:
        sd[f"{name}.lora_a"] = _t(np.asarray(p["lora_a"]).T)
        sd[f"{name}.lora_b"] = _t(np.asarray(p["lora_b"]).T)


def _t5_stack(sd: StateDict, prefix: str, p: Tree, is_decoder: bool) -> None:
    i = 0
    while f"block_{i}" in p:
        bp, b = p[f"block_{i}"], f"{prefix}.block.{i}"
        sub = [("self_attn", "layer.0.SelfAttention", "self_attn_norm")]
        if is_decoder:
            sub.append(("cross_attn", "layer.1.EncDecAttention", "cross_attn_norm"))
        for jname, hname, norm in sub:
            for n in ("q", "k", "v", "o"):
                _linear(sd, f"{b}.{hname}.{n}", bp[jname][n])
            if "relative_attention_bias" in bp[jname]:
                _embed(sd, f"{b}.{hname}.relative_attention_bias",
                       bp[jname]["relative_attention_bias"])
            sd[f"{b}.{hname.rsplit('.', 1)[0]}.layer_norm.weight"] = _t(bp[norm]["weight"])
        ff = f"{b}.layer.{2 if is_decoder else 1}"
        for n, w in bp["ff"].items():
            _linear(sd, f"{ff}.DenseReluDense.{n}", w)
        sd[f"{ff}.layer_norm.weight"] = _t(bp["ff_norm"]["weight"])
        i += 1
    sd[f"{prefix}.final_layer_norm.weight"] = _t(p["final_norm"]["weight"])


def _t5(sd: StateDict, prefix: str, p: Tree) -> None:
    _embed(sd, f"{prefix}shared", p["shared"])
    _t5_stack(sd, f"{prefix}encoder", p["encoder"], is_decoder=False)
    _t5_stack(sd, f"{prefix}decoder", p["decoder"], is_decoder=True)
    if "lm_head" in p:
        _linear(sd, f"{prefix}lm_head", p["lm_head"])


def t5_state_dict(params: Tree) -> StateDict:
    """Flax ``T5ForConditionalGeneration`` params -> the port's
    ``T5ForConditionalGeneration`` state dict (HF names; the inverse of
    ``hf_bridge.t5_params``, LoRA adapters included)."""
    sd: StateDict = {}
    _t5(sd, "", params)
    return sd


def _opt(sd: StateDict, prefix: str, p: Tree) -> None:
    d = f"{prefix}model.decoder"
    _embed(sd, f"{d}.embed_tokens", p["embed_tokens"])
    _embed(sd, f"{d}.embed_positions", p["embed_positions"])
    for n in ("final_layer_norm",):
        if n in p:
            _layernorm(sd, f"{d}.{n}", p[n])
    for n in ("project_in", "project_out"):
        if n in p:
            _linear(sd, f"{d}.{n}", p[n])
    i = 0
    while f"layer_{i}" in p:
        lp, lpre = p[f"layer_{i}"], f"{d}.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{lpre}.self_attn.{n}", lp["self_attn"][n])
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            _layernorm(sd, f"{lpre}.{n}", lp[n])
        _linear(sd, f"{lpre}.fc1", lp["fc1"])
        _linear(sd, f"{lpre}.fc2", lp["fc2"])
        i += 1


def opt_state_dict(params: Tree) -> StateDict:
    """Flax ``OPTForCausalLM`` params -> the port's ``OPTForCausalLM`` state
    dict (HF names under ``model.decoder``; the head is tied to
    ``embed_tokens``; the inverse of ``hf_bridge.opt_params``)."""
    sd: StateDict = {}
    _opt(sd, "", params)
    return sd


def _blip2_attention(sd: StateDict, prefix: str, p: Tree) -> None:
    for n in ("query", "key", "value"):
        _dense(sd, f"{prefix}.attention.{n}", p[n])
    _dense(sd, f"{prefix}.output.dense", p["out"])
    _layernorm(sd, f"{prefix}.output.LayerNorm", p["layernorm"])


def _blip2(sd: StateDict, prefix: str, p: Tree) -> None:
    v, vp = f"{prefix}vision_model", p["vision_model"]
    emb = vp["embeddings"]
    sd[f"{v}.embeddings.class_embedding"] = _t(emb["class_embedding"])
    sd[f"{v}.embeddings.position_embedding"] = _t(emb["position_embedding"])
    sd[f"{v}.embeddings.patch_embedding.weight"] = _t(
        np.asarray(emb["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{v}.embeddings.patch_embedding.bias"] = _t(emb["patch_embedding"]["bias"])
    _layernorm(sd, f"{v}.post_layernorm", vp["post_layernorm"])
    i = 0
    while f"layer_{i}_attn" in vp:
        lpre = f"{v}.encoder.layers.{i}"
        _dense(sd, f"{lpre}.self_attn.qkv", vp[f"layer_{i}_attn"]["qkv"])
        _dense(sd, f"{lpre}.self_attn.projection", vp[f"layer_{i}_attn"]["projection"])
        _layernorm(sd, f"{lpre}.layer_norm1", vp[f"layer_{i}_norm1"])
        _layernorm(sd, f"{lpre}.layer_norm2", vp[f"layer_{i}_norm2"])
        _dense(sd, f"{lpre}.mlp.fc1", vp[f"layer_{i}_fc1"])
        _dense(sd, f"{lpre}.mlp.fc2", vp[f"layer_{i}_fc2"])
        i += 1
    q, qp = f"{prefix}qformer", p["qformer"]
    sd[f"{prefix}query_tokens"] = _t(qp["query_tokens"])
    _layernorm(sd, f"{q}.layernorm", qp["layernorm"])
    i = 0
    while f"layer_{i}_attention" in qp:
        lpre = f"{q}.encoder.layer.{i}"
        _blip2_attention(sd, f"{lpre}.attention", qp[f"layer_{i}_attention"])
        if f"layer_{i}_crossattention" in qp:
            _blip2_attention(sd, f"{lpre}.crossattention", qp[f"layer_{i}_crossattention"])
        _dense(sd, f"{lpre}.intermediate_query.dense", qp[f"layer_{i}_intermediate_query"])
        _dense(sd, f"{lpre}.output_query.dense", qp[f"layer_{i}_output_query"])
        _layernorm(sd, f"{lpre}.output_query.LayerNorm", qp[f"layer_{i}_output_query_norm"])
        i += 1
    _dense(sd, f"{prefix}language_projection", p["language_projection"])
    lm = p["language_model"]
    (_opt if "embed_tokens" in lm else _t5)(sd, f"{prefix}language_model.", lm)


def blip2_state_dict(params: Tree) -> StateDict:
    """Flax ``Blip2ForConditionalGeneration`` params (T5 or OPT language
    model) -> the port's ``Blip2ForConditionalGeneration`` state dict (HF
    names; the inverse of ``hf_bridge.blip2_params``)."""
    sd: StateDict = {}
    _blip2(sd, "", params)
    return sd


def blip2_rerank_state_dict(params: Tree) -> StateDict:
    """Flax ``Blip2DecoderRerankModel`` / ``Blip2DecoderHeadRerankModel``
    params -> the port's state dict (``model.*``, and the two heads)."""
    sd: StateDict = {}
    _blip2(sd, "model.", params["model"])
    for n in ("classifier1", "classifier2"):
        if n in params:
            _dense(sd, n, params[n])
    return sd


def _bert_layer(sd: StateDict, lpre: str, lp: Tree) -> None:
    _bert_attention(sd, f"{lpre}.attention", lp["attention"])
    _dense(sd, f"{lpre}.intermediate.dense", lp["intermediate"])
    _dense(sd, f"{lpre}.output.dense", lp["output"])
    _layernorm(sd, f"{lpre}.output.LayerNorm", lp["layernorm"])


def _vision_seq2seq(sd: StateDict, prefix: str, mp: Tree) -> None:
    if "vision_encoder" in mp:  # flax made none where init saw no pixels
        _clip(sd, f"{prefix}vision_encoder.vision_model.", mp["vision_encoder"])
        _dense(sd, f"{prefix}vision_projection", mp["vision_projection"])
    _embed(sd, f"{prefix}embed", mp["embed"])
    _embed(sd, f"{prefix}pos_embed", mp["pos_embed"])
    i = 0
    while f"encoder_layer_{i}" in mp:
        _bert_layer(sd, f"{prefix}encoder_layers.{i}", mp[f"encoder_layer_{i}"])
        i += 1
    i = 0
    while f"decoder_layer_{i}" in mp:
        lp, lpre = mp[f"decoder_layer_{i}"], f"{prefix}decoder_layers.{i}"
        _bert_attention(sd, f"{lpre}.self_attention", lp["self_attention"])
        _bert_attention(sd, f"{lpre}.cross_attention", lp["cross_attention"])
        _linear(sd, f"{lpre}.intermediate", lp["intermediate"])
        _linear(sd, f"{lpre}.output", lp["output"])
        _layernorm(sd, f"{lpre}.layernorm", lp["layernorm"])
        i += 1
    _layernorm(sd, f"{prefix}final_norm", mp["final_norm"])
    _dense(sd, f"{prefix}lm_head", mp["lm_head"])


def vision_seq2seq_state_dict(params: Tree) -> StateDict:
    """Flax ``VisionSeq2SeqLM`` params (the native RAG generator) -> the
    port's ``VisionSeq2SeqLM`` state dict."""
    sd: StateDict = {}
    _vision_seq2seq(sd, "", params)
    return sd


def decoder_rerank_state_dict(params: Tree) -> StateDict:
    """Flax ``DecoderRerankModel`` / ``DecoderHeadRerankModel`` params (the
    compact ``VisionSeq2SeqLM`` backbone) -> the port's state dict."""
    sd: StateDict = {}
    _vision_seq2seq(sd, "model.", params["model"])
    for n in ("classifier1", "classifier2"):
        if n in params:
            _dense(sd, n, params[n])
    return sd


# ---------------------------------------------------------------------------
# The other way: HF-named numpy state dicts -> flax parameter trees, as the
# JAX package's ``models/hf_bridge.py`` builds them (``bert_model_params``,
# ``clip_vision_params``, ``vision_projection_params``, ``flmr_params``), so
# that a port checkpoint exports the JAX package's ``.npz`` keys.

def _np_linear(sd, name):
    out = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T)}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _np_layernorm(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _np_strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _np_layer_ids(sd, pattern):
    return sorted({int(m.group(1)) for k in sd if (m := re.match(pattern, k))})


def _np_bert_attention(sd, prefix):
    return {"query": _np_linear(sd, f"{prefix}.self.query"),
            "key": _np_linear(sd, f"{prefix}.self.key"),
            "value": _np_linear(sd, f"{prefix}.self.value"),
            "out": _np_linear(sd, f"{prefix}.output.dense"),
            "layernorm": _np_layernorm(sd, f"{prefix}.output.LayerNorm")}


def flax_bert_encoder(sd, prefix="encoder", cross_attention=False) -> dict:
    """``hf_bridge.bert_encoder_params``: ``{prefix}.layer.{i}.*`` ->
    ``layer_{i}`` (with ``crossattention`` where asked and present)."""
    out = {}
    for i in _np_layer_ids(sd, rf"{re.escape(prefix)}\.layer\.(\d+)\."):
        pre = f"{prefix}.layer.{i}"
        p = {"attention": _np_bert_attention(sd, f"{pre}.attention"),
             "intermediate": _np_linear(sd, f"{pre}.intermediate.dense"),
             "output": _np_linear(sd, f"{pre}.output.dense"),
             "layernorm": _np_layernorm(sd, f"{pre}.output.LayerNorm")}
        if cross_attention and f"{pre}.crossattention.self.query.weight" in sd:
            p["crossattention"] = _np_bert_attention(sd, f"{pre}.crossattention")
        out[f"layer_{i}"] = p
    return out


def flax_bert(sd) -> dict:
    """``hf_bridge.bert_model_params``: an HF ``BertModel`` state dict."""
    p = {"embeddings": {
        "word_embeddings": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "position_embeddings": {"embedding": sd["embeddings.position_embeddings.weight"]},
        "token_type_embeddings": {"embedding": sd["embeddings.token_type_embeddings.weight"]},
        "layernorm": _np_layernorm(sd, "embeddings.LayerNorm")},
        "encoder": flax_bert_encoder(sd, "encoder")}
    if "pooler.dense.weight" in sd:
        p["pooler"] = _np_linear(sd, "pooler.dense")
    return p


def flax_clip_vision(sd) -> dict:
    """``hf_bridge.clip_vision_params``: the inner ``vision_model`` state
    dict of an HF ``CLIPVisionModel`` (conv kernel OIHW -> HWIO)."""
    p = {"embeddings": {
        "class_embedding": sd["embeddings.class_embedding"],
        "position_embedding": sd["embeddings.position_embedding.weight"],
        "patch_embedding": {"kernel": np.ascontiguousarray(
            sd["embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0))}},
        "pre_layrnorm": _np_layernorm(sd, "pre_layrnorm"),
        "post_layernorm": _np_layernorm(sd, "post_layernorm")}
    for i in _np_layer_ids(sd, r"encoder\.layers\.(\d+)\."):
        pre = f"encoder.layers.{i}"
        p[f"layer_{i}"] = {
            "self_attn": {n: _np_linear(sd, f"{pre}.self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm1": _np_layernorm(sd, f"{pre}.layer_norm1"),
            "layer_norm2": _np_layernorm(sd, f"{pre}.layer_norm2"),
            "fc1": _np_linear(sd, f"{pre}.mlp.fc1"),
            "fc2": _np_linear(sd, f"{pre}.mlp.fc2")}
    return p


def flax_flmr(sd) -> dict:
    """``hf_bridge.flmr_params`` over the state dict of the port's
    ``FLMRModelForRetrieval`` (numpy arrays): which encoders, projections
    and mapping network the tree holds follows the keys present, as the
    port's model holds exactly those of its config."""
    p = {"context_text_encoder": flax_bert(_np_strip(sd, "context_text_encoder.bert_model.")),
         "context_text_encoder_linear": _np_linear(sd, "context_text_encoder_linear")}
    if "query_text_encoder_linear.weight" in sd:
        p["query_text_encoder"] = flax_bert(_np_strip(sd, "query_text_encoder.bert_model."))
        p["query_text_encoder_linear"] = _np_linear(sd, "query_text_encoder_linear")
    if "context_vision_projection.model.0.weight" in sd:
        p["context_vision_encoder"] = flax_clip_vision(
            _np_strip(sd, "context_vision_encoder.vision_model.vision_model."))
        p["context_vision_projection"] = {
            "fc1": _np_linear(sd, "context_vision_projection.model.0"),
            "fc2": _np_linear(sd, "context_vision_projection.model.2")}
        if "query_vision_projection.model.0.weight" in sd:
            p["query_vision_encoder"] = flax_clip_vision(
                _np_strip(sd, "query_vision_encoder.vision_model.vision_model."))
            p["query_vision_projection"] = {
                "fc1": _np_linear(sd, "query_vision_projection.model.0"),
                "fc2": _np_linear(sd, "query_vision_projection.model.2")}
        if "transformer_mapping_input_linear.weight" in sd:
            p["transformer_mapping_input_linear"] = _np_linear(
                sd, "transformer_mapping_input_linear")
            p["transformer_mapping_network"] = flax_bert_encoder(
                sd, "transformer_mapping_network", cross_attention=True)
            p["transformer_mapping_output_linear"] = _np_linear(
                sd, "transformer_mapping_output_linear")
    return p
