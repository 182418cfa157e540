"""Carry the JAX package's flax parameter trees into the port's state dicts.

Each function takes a flax parameter tree as nested dicts of numpy arrays
(the caller does ``jax.device_get`` on its side; this module imports no JAX)
and returns a ``state_dict`` for the matching port model, with HuggingFace
parameter names. The conversions are the inverse of the JAX package's
``models/hf_bridge.py``: a flax ``Dense`` kernel ``[in, out]`` becomes a
``Linear.weight`` ``[out, in]``, a LayerNorm ``scale`` becomes ``weight``, an
``Embed`` table becomes ``weight``, and a conv kernel HWIO becomes OIHW.
"""

from __future__ import annotations

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


def clip_vision_state_dict(params: Tree) -> StateDict:
    """Flax ``CLIPVisionModel`` params -> the port's ``CLIPVisionModel``."""
    sd: StateDict = {}
    _clip(sd, "vision_model.", params)
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
