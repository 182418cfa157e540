"""Legacy retriever families (port of ``models/legacy_retrievers.py``).

The reference's superseded generation of retrievers, on the three
architectures the JAX package gives them:

- :class:`VisualColBERT`: FLMR without the transformer mapping network.
- :class:`VisualDPR` / :class:`RetrieverDPR` (with the BPR loss) /
  :class:`RetrieverT5`: single-vector dense retrievers, dot-product scores
  and an in-batch-negative CE.
- :class:`VisualColBERTMultipleMapping` and :class:`VisualColBERTMAE`:
  late-interaction retrievers with several vision MLPs, or a vision-only
  query tower; :class:`VisualDPRForRAG`, the query side of RAG training.

Each model is built on ``device`` (CUDA by default) with weights drawn from
``generator``; ``models/weights.py::legacy_retriever_state_dict`` carries a
JAX parameter tree in (``flmr_state_dict`` for :class:`VisualColBERT`).
Their BERTs take kernel K2 under ``use_pallas_attention``, as FLMR's do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from ..ops.maxsim import colbert_score
from .bert import BertConfig, BertEncoder, BertModel
from .flmr import FLMRConfig, FLMRModelForRetrieval, _l2_normalize, _softmax_ce
from .init import materialize_
from .vit import CLIPVisionConfig, CLIPVisionModel


class VisualColBERT(FLMRModelForRetrieval):
    """Late-interaction retriever without the transformer mapping network
    (the pre-PreFLMR architecture, reference `visual_colbert.py`)."""

    @classmethod
    def build(cls, text_config: BertConfig, vision_config: CLIPVisionConfig, dim: int = 128,
              prefix_length: int = 32, *, device: DeviceLike = "cuda",
              dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
              **kw) -> "VisualColBERT":
        cfg = FLMRConfig(text_config=text_config, vision_config=vision_config, dim=dim,
                         mapping_network_prefix_length=prefix_length,
                         use_transformer_mapping_network=False, **kw)
        return cls(cfg, device=device, dtype=dtype, generator=generator)


@dataclasses.dataclass(frozen=True)
class DPRConfig:
    text_config: BertConfig = dataclasses.field(default_factory=BertConfig)
    vision_config: Optional[CLIPVisionConfig] = None
    projection_dim: int = 0  # 0: the hidden size, no projection
    use_vision: bool = False
    vision_prefix_length: int = 4
    bpr: bool = False  # binary passage retrieval loss (reference `retriever_dpr.py:233`)
    # False shares one BERT tower for both sides (reference `retriever_dpr.py:55,89`)
    separate_query_and_item_encoders: bool = True

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(text_config=BertConfig.tiny(), vision_config=CLIPVisionConfig.tiny())
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass
class DPROutput:
    loss: torch.Tensor
    scores: torch.Tensor  # [B_q, B_d]
    query_embeddings: torch.Tensor
    item_embeddings: torch.Tensor


def _in_batch_ce(Q, D, num_negative_examples: int):
    """fp32 dot-product scores of every query against every item, and the CE
    against each query's positive (item ``i * nway``)."""
    scores = torch.einsum("qd,nd->qn", Q.float(), D.float())
    labels = torch.arange(Q.shape[0], device=Q.device) * (num_negative_examples + 1)
    return scores, labels, _softmax_ce(scores, labels)


class VisualDPR(nn.Module):
    """Single-vector dense retriever with optional vision conditioning
    (reference `visual_dpr.py`): the query's CLS vector plus the mean of the
    vision prefix, the item's CLS vector, optional projections."""

    def __init__(self, config: DPRConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        H = cfg.text_config.hidden_size
        with torch.device("meta"):
            self.query_encoder = BertModel(cfg.text_config, device="meta")
            if cfg.separate_query_and_item_encoders:
                self.item_encoder = BertModel(cfg.text_config, device="meta")
            if cfg.projection_dim:
                self.query_proj = nn.Linear(H, cfg.projection_dim)
                self.item_proj = nn.Linear(H, cfg.projection_dim)
            if cfg.use_vision:
                self.vision_encoder = CLIPVisionModel(cfg.vision_config, device="meta")
                self.vision_projection = nn.Linear(cfg.vision_config.hidden_size,
                                                   H * cfg.vision_prefix_length)
        materialize_(self, device, dtype, generator, cfg.text_config.initializer_range)

    def encode_query(self, input_ids, attention_mask, pixel_values=None):
        cls = self.query_encoder(input_ids, attention_mask)["last_hidden_state"][:, 0]
        if pixel_values is not None and self.config.use_vision:
            vis = self.vision_encoder(pixel_values)["last_hidden_state"][:, 0]
            prefix = self.vision_projection(vis).reshape(cls.shape[0], -1, cls.shape[-1])
            cls = cls + prefix.mean(dim=1)
        if self.config.projection_dim:
            cls = self.query_proj(cls)
        return cls

    def encode_item(self, input_ids, attention_mask):
        encoder = (self.item_encoder if self.config.separate_query_and_item_encoders
                   else self.query_encoder)
        cls = encoder(input_ids, attention_mask)["last_hidden_state"][:, 0]
        if self.config.projection_dim:
            cls = self.item_proj(cls)
        return cls

    def forward(self, query_input_ids, query_attention_mask, item_input_ids,
                item_attention_mask, query_pixel_values=None,
                num_negative_examples: int = 1) -> DPROutput:
        Q = self.encode_query(query_input_ids, query_attention_mask, query_pixel_values)
        D = self.encode_item(item_input_ids, item_attention_mask)
        scores, labels, loss = _in_batch_ce(Q, D, num_negative_examples)
        if self.config.bpr:
            # BPR: the same CE on tanh-binarised codes, added to the dense CE
            h_scores = torch.einsum("qd,nd->qn", torch.tanh(Q.float()), torch.tanh(D.float()))
            loss = loss + _softmax_ce(h_scores, labels)
        return DPROutput(loss=loss, scores=scores, query_embeddings=Q, item_embeddings=D)


class RetrieverDPR(VisualDPR):
    """Text-only DPR (reference `retriever_dpr.py`)."""

    def encode_query(self, input_ids, attention_mask, pixel_values=None):
        return super().encode_query(input_ids, attention_mask, None)


class RetrieverT5(nn.Module):
    """Encoder-pooled dense retriever (reference `retriever_t5.py`): the
    masked mean of one shared encoder's states, then a projection."""

    def __init__(self, config: DPRConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        H = cfg.text_config.hidden_size
        with torch.device("meta"):
            self.encoder = BertModel(cfg.text_config, add_pooling_layer=False, device="meta")
            self.projection = nn.Linear(H, cfg.projection_dim or H)
        materialize_(self, device, dtype, generator, cfg.text_config.initializer_range)

    def _pool(self, ids, mask):
        h = self.encoder(ids, mask)["last_hidden_state"]
        m = mask[:, :, None].to(h.dtype)
        return (h * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)

    def forward(self, query_input_ids, query_attention_mask, item_input_ids,
                item_attention_mask, num_negative_examples: int = 1) -> DPROutput:
        Q = self.projection(self._pool(query_input_ids, query_attention_mask))
        D = self.projection(self._pool(item_input_ids, item_attention_mask))
        scores, _, loss = _in_batch_ce(Q, D, num_negative_examples)
        return DPROutput(loss=loss, scores=scores, query_embeddings=Q, item_embeddings=D)


@dataclasses.dataclass
class LateInteractionOutput:
    loss: torch.Tensor
    scores: torch.Tensor  # [B, nway]
    query_embeddings: torch.Tensor  # [B, Lq, dim]
    item_embeddings: torch.Tensor  # [B * nway, Ld, dim]


def _nway_colbert_loss(Q, D, D_mask, num_negative_examples: int):
    """The 1-positive + N-negative MaxSim CE of the legacy late-interaction
    retrievers (the contract of `modeling_flmr.py:938-947`). Returns
    ``(loss, scores [B, nway])``."""
    nway = num_negative_examples + 1
    Q_dup = Q[:, None].expand(-1, nway, -1, -1).reshape(-1, *Q.shape[1:])
    scores, _ = colbert_score(Q_dup, D, D_mask)
    scores = scores.reshape(-1, nway)
    labels = torch.zeros(scores.shape[0], dtype=torch.long, device=scores.device)
    return _softmax_ce(scores, labels), scores


@dataclasses.dataclass(frozen=True)
class MultiMappingConfig:
    """Reference `visual_colbert.py:356-396`: one MLP per feature source,
    each ``vision_embedding_size -> dim * prefix / 2 -> dim * prefix``."""

    text_config: BertConfig = dataclasses.field(default_factory=BertConfig)
    dim: int = 128
    vision_embedding_size: int = 768
    prefix_lengths: Tuple[int, ...] = (4, 4)  # one vision projection each

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(text_config=BertConfig.tiny(), dim=16, vision_embedding_size=24,
                        prefix_lengths=(2, 3))
        defaults.update(kw)
        return cls(**defaults)


class MappingMLP(nn.Module):
    """The reference's two-layer exact-GELU vision projection
    (`visual_colbert.py:16-27`): ``in -> out_tokens * dim / 2 -> out_tokens
    * dim``, reshaped to ``[B, out_tokens, dim]``."""

    def __init__(self, in_features: int, out_tokens: int, dim: int):
        super().__init__()
        self.dim = dim
        width = out_tokens * dim
        self.fc1 = nn.Linear(in_features, width // 2)
        self.fc2 = nn.Linear(width // 2, width)

    def forward(self, x):
        x = self.fc2(F.gelu(self.fc1(x)))
        return x.reshape(x.shape[0], -1, self.dim)


class VisualColBERTMultipleMapping(nn.Module):
    """Late-interaction retriever whose query concatenates several vision
    mappings of the same precomputed image features (reference
    `visual_colbert.py:345-461`); ``[B, rois, vision_dim]`` feature stacks
    are flattened into one MLP input of ``vision_feature_size`` (by default
    ``vision_embedding_size``, one feature vector an image)."""

    def __init__(self, config: MultiMappingConfig, vision_feature_size: Optional[int] = None,
                 *, device: DeviceLike = "cuda", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        width = vision_feature_size or cfg.vision_embedding_size
        with torch.device("meta"):
            self.text_encoder = BertModel(cfg.text_config, add_pooling_layer=False,
                                          device="meta")
            self.linear = nn.Linear(cfg.text_config.hidden_size, cfg.dim, bias=False)
            self.vision_projections = nn.ModuleList(
                MappingMLP(width, p, cfg.dim) for p in cfg.prefix_lengths)
        materialize_(self, device, dtype, generator, cfg.text_config.initializer_range)

    def encode_text(self, input_ids, attention_mask):
        h = self.linear(self.text_encoder(input_ids, attention_mask)["last_hidden_state"])
        return h * attention_mask[:, :, None].to(h.dtype)

    def query(self, input_ids, attention_mask, image_features):
        Q = self.encode_text(input_ids, attention_mask)
        feats = image_features.reshape(image_features.shape[0], -1)
        Q = torch.cat([Q] + [proj(feats) for proj in self.vision_projections], dim=1)
        return _l2_normalize(Q)

    def doc(self, input_ids, attention_mask):
        return _l2_normalize(self.encode_text(input_ids, attention_mask)), attention_mask

    def forward(self, query_input_ids, query_attention_mask, query_image_features,
                item_input_ids, item_attention_mask,
                num_negative_examples: int = 1) -> LateInteractionOutput:
        Q = self.query(query_input_ids, query_attention_mask, query_image_features)
        D, D_mask = self.doc(item_input_ids, item_attention_mask)
        loss, scores = _nway_colbert_loss(Q, D, D_mask, num_negative_examples)
        return LateInteractionOutput(loss=loss, scores=scores, query_embeddings=Q,
                                     item_embeddings=D)


@dataclasses.dataclass(frozen=True)
class MAERetrieverConfig:
    """Reference `visual_colbert.py:1518-1645`: a vision-only query tower,
    ViT patch states -> input linear -> shallow self-attention encoder ->
    linear to ``dim``; text-only docs."""

    text_config: BertConfig = dataclasses.field(default_factory=BertConfig)
    vision_config: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    mapping_config: BertConfig = dataclasses.field(default_factory=BertConfig)
    dim: int = 128

    @classmethod
    def tiny(cls, **kw):
        vision = CLIPVisionConfig.tiny()
        mapping = dataclasses.replace(BertConfig.tiny(), hidden_size=vision.hidden_size,
                                      num_hidden_layers=1)
        defaults = dict(text_config=BertConfig.tiny(), vision_config=vision,
                        mapping_config=mapping, dim=16)
        defaults.update(kw)
        return cls(**defaults)


class VisualColBERTMAE(nn.Module):
    """Vision-only late-interaction query encoder (reference
    `visual_colbert.py:1615-1645`): the query is the mapped patch tokens
    alone; docs are text-only."""

    def __init__(self, config: MAERetrieverConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        V = cfg.vision_config.hidden_size
        with torch.device("meta"):
            self.vision_encoder = CLIPVisionModel(cfg.vision_config, device="meta")
            self.vision_projection_input_linear = nn.Linear(V, V)
            self.vision_projection = BertEncoder(cfg.mapping_config)
            self.vision_projection_linear = nn.Linear(cfg.mapping_config.hidden_size, cfg.dim)
            self.text_encoder = BertModel(cfg.text_config, add_pooling_layer=False,
                                          device="meta")
            self.linear = nn.Linear(cfg.text_config.hidden_size, cfg.dim, bias=False)
        materialize_(self, device, dtype, generator, cfg.text_config.initializer_range)

    def query(self, pixel_values):
        states = self.vision_encoder(pixel_values)["last_hidden_state"]
        states, _ = self.vision_projection(self.vision_projection_input_linear(states))
        return _l2_normalize(self.vision_projection_linear(states))

    def doc(self, input_ids, attention_mask):
        h = self.text_encoder(input_ids, attention_mask)["last_hidden_state"]
        D = self.linear(h) * attention_mask[:, :, None].to(h.dtype)
        return _l2_normalize(D), attention_mask

    def forward(self, query_pixel_values, item_input_ids, item_attention_mask,
                num_negative_examples: int = 1) -> LateInteractionOutput:
        Q = self.query(query_pixel_values)
        D, D_mask = self.doc(item_input_ids, item_attention_mask)
        loss, scores = _nway_colbert_loss(Q, D, D_mask, num_negative_examples)
        return LateInteractionOutput(loss=loss, scores=scores, query_embeddings=Q,
                                     item_embeddings=D)


class VisualDPRForRAG(nn.Module):
    """The query side of visual DPR inside RAG training (reference
    `visual_dpr.py:1008-1139`): the pooled text embedding plus the *sum* of
    the vision prefix tokens. ``vision_feature_size`` is the width of the
    flattened ``image_features`` the prefix MLP takes."""

    def __init__(self, config: DPRConfig, vision_feature_size: int, *,
                 device: DeviceLike = "cuda", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        H = cfg.text_config.hidden_size
        width = cfg.projection_dim or H
        with torch.device("meta"):
            self.query_encoder = BertModel(cfg.text_config, device="meta")
            if cfg.projection_dim:
                self.query_proj = nn.Linear(H, cfg.projection_dim)
            self.vision_projection = MappingMLP(vision_feature_size, cfg.vision_prefix_length,
                                                width)
        materialize_(self, device, dtype, generator, cfg.text_config.initializer_range)

    def forward(self, input_ids, attention_mask, image_features):
        pooled = self.query_encoder(input_ids, attention_mask)["pooler_output"]
        if self.config.projection_dim:
            pooled = self.query_proj(pooled)
        prefix = self.vision_projection(image_features.reshape(image_features.shape[0], -1))
        return pooled + prefix.sum(dim=1)
