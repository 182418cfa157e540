"""FLMR / PreFLMR late-interaction multimodal retriever in PyTorch (port of
``models/flmr.py``): the query and doc encoders used for retrieval.

- query: BERT text encoder -> linear to ``dim`` -> token mask; CLIP-ViT CLS ->
  2-layer tanh MLP producing ``mapping_network_prefix_length`` vision tokens;
  optionally a shallow cross-attention BertEncoder over the ViT second-to-last
  layer conditioned on the first text hidden states; concat, L2-normalise.
- doc: text tokens with punctuation-skiplist masking, vision prefix tokens
  prepended for multimodal docs; L2-normalise.
- forward (training): the CE loss of each query over its (1 positive + N
  negatives) aligned docs, and the all-pairs in-batch-negative loss.

Parameter names follow the reference ``FLMRModelForRetrieval`` checkpoint
(``context_text_encoder.bert_model.*``,
``context_vision_encoder.vision_model.vision_model.*``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike
from ..ops.maxsim import colbert_score, in_batch_maxsim_scores
from .bert import BertConfig, BertEncoder, BertModel, additive_mask
from .init import materialize_
from .vit import CLIPVisionConfig, CLIPVisionModel


@dataclasses.dataclass(frozen=True)
class FLMRConfig:
    text_config: BertConfig = dataclasses.field(default_factory=BertConfig)
    vision_config: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    dim: int = 128
    mapping_network_prefix_length: int = 32
    use_vision_encoder: bool = True
    initializer_range: float = 0.02
    separate_query_and_context_text_encoder: bool = False
    separate_query_and_context_vision_encoder: bool = False
    query_concat_output_from_vision_encoder: bool = True
    query_concat_output_from_text_encoder: bool = True
    context_concat_output_from_vision_encoder: bool = False
    context_concat_output_from_text_encoder: bool = True
    use_transformer_mapping_network: bool = False
    transformer_mapping_num_hidden_layers: int = 1
    transformer_mapping_cross_attention_length: int = 32
    mask_punctuation: bool = True
    punctuation_token_ids: Tuple[int, ...] = ()
    mask_instruction: bool = False
    instruction_token_id: int = -1

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            text_config=BertConfig.tiny(),
            vision_config=CLIPVisionConfig.tiny(),
            dim=16,
            mapping_network_prefix_length=4,
            use_transformer_mapping_network=True,
            transformer_mapping_num_hidden_layers=1,
            punctuation_token_ids=(5, 6, 7),
        )
        defaults.update(kw)
        return cls(**defaults)

    @property
    def transformer_mapping_config(self) -> BertConfig:
        return dataclasses.replace(
            self.text_config,
            num_hidden_layers=self.transformer_mapping_num_hidden_layers,
            add_cross_attention=True,
        )


@dataclasses.dataclass
class FLMRQueryOutput:
    late_interaction_output: torch.Tensor  # [B, L_q(+vis), dim], L2-normalised
    query_mask: torch.Tensor  # [B, L_q(+vis)] int
    pooler_output: torch.Tensor  # [B, dim]


@dataclasses.dataclass
class FLMRContextOutput:
    late_interaction_output: torch.Tensor  # [B, (vis+)L_d, dim], L2-normalised
    context_mask: torch.Tensor  # [B, (vis+)L_d] bool
    pooler_output: torch.Tensor  # [B, dim]


@dataclasses.dataclass
class FLMRForwardOutput:
    loss: torch.Tensor  # CE over each query's (1 + N) aligned docs
    in_batch_negative_loss: Optional[torch.Tensor]
    scores: torch.Tensor  # [B, 1 + num_negatives]
    scores_raw: torch.Tensor  # [B * nway, L_d, L_q] masked token scores
    query_late_interaction_output: torch.Tensor
    context_late_interaction_output: torch.Tensor
    query_mask: torch.Tensor
    context_mask: torch.Tensor


def token_skiplist_mask(input_ids: torch.Tensor, skiplist: Tuple[int, ...]) -> torch.Tensor:
    """True where the token is neither pad (id 0) nor in the skiplist."""
    keep = input_ids != 0
    if skiplist:
        keep &= ~torch.isin(input_ids, torch.tensor(skiplist, device=input_ids.device))
    return keep


def query_instruction_mask(input_ids: torch.Tensor, instruction_token_id: int) -> torch.Tensor:
    """Keep positions strictly after the first instruction-end token, plus
    positions 0 and 1; falls back to position 1 when there is none."""
    is_sep = (input_ids == instruction_token_id).int()
    sep_pos = torch.clamp(torch.argmax(is_sep, dim=1), min=1)
    idx = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    keep = (idx > sep_pos[:, None]) | (idx < 2)
    return keep & (input_ids != 0)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise the last axis in fp32; zero rows stay zero. The floor is
    taken on the squared norm, whose gradient is 0 below it, so a zero row
    (a masked token) passes its upstream gradient scaled by 1/eps and no
    NaN: exactly 0 for a masked token, whose scores the loss never reads."""
    x32 = x.float()
    sq = (x32 * x32).sum(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(torch.clamp(sq, min=eps * eps))).to(x.dtype)


class VisionProjection(nn.Module):
    """2-layer tanh MLP: vision CLS -> prefix_length x dim tokens (reference
    ``FLMRMultiLayerPerceptron``: ``model.0`` / ``model.2``)."""

    def __init__(self, in_dim: int, out_dim: int, prefix_length: int):
        super().__init__()
        self.out_dim = out_dim
        self.prefix_length = prefix_length
        total = out_dim * prefix_length
        self.model = nn.Sequential(
            nn.Linear(in_dim, total // 2), nn.Tanh(), nn.Linear(total // 2, total))

    def forward(self, x):
        return self.model(x).reshape(x.shape[0], self.prefix_length, self.out_dim)


class FLMRTextModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert_model = BertModel(cfg, device="meta")

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        return self.bert_model(input_ids, attention_mask, token_type_ids=token_type_ids)


class FLMRVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.vision_model = CLIPVisionModel(cfg, device="meta")

    def forward(self, pixel_values):
        return self.vision_model(pixel_values)


class FLMRBackbone(nn.Module):
    """The retriever modules shared by FLMR and the monoPreFLMR rerankers:
    tied context encoders, the vision projection and the mapping network."""

    def _build_text(self, cfg: FLMRConfig):
        self.context_text_encoder = FLMRTextModel(cfg.text_config)
        self.context_text_encoder_linear = nn.Linear(
            cfg.text_config.hidden_size, cfg.dim, bias=False)

    def _build_vision(self, cfg: FLMRConfig, mapping_network: bool):
        H = cfg.text_config.hidden_size
        self.context_vision_encoder = FLMRVisionModel(cfg.vision_config)
        self.context_vision_projection = VisionProjection(
            cfg.vision_config.hidden_size, cfg.dim, cfg.mapping_network_prefix_length)
        if mapping_network:
            self.transformer_mapping_input_linear = nn.Linear(cfg.vision_config.hidden_size, H)
            self.transformer_mapping_network = BertEncoder(cfg.transformer_mapping_config)
            self.transformer_mapping_output_linear = nn.Linear(H, cfg.dim)

    def _map_vision(self, cfg: FLMRConfig, second_last, text_hidden, batch_size):
        """Transformer mapping network over the ViT second-to-last layer (sans
        CLS), cross-attending to the first text hidden states with an all-ones
        mask. Returns [batch_size, n_roi * n_patches, dim]."""
        mapped_in = self.transformer_mapping_input_linear(second_last)
        enc_states = text_hidden[:, : cfg.transformer_mapping_cross_attention_length]
        n_roi = mapped_in.shape[0] // batch_size
        if n_roi > 1:
            enc_states = torch.repeat_interleave(enc_states, n_roi, dim=0)
        enc_bias = additive_mask(torch.ones(enc_states.shape[:2], device=enc_states.device))
        mapped, _ = self.transformer_mapping_network(
            mapped_in, mask_bias=None, encoder_hidden_states=enc_states,
            encoder_mask_bias=enc_bias)
        mapped = self.transformer_mapping_output_linear(mapped)
        return mapped.reshape(batch_size, -1, cfg.dim)


class FLMRModelForRetrieval(FLMRBackbone):
    """Query and doc encoders of FLMR/PreFLMR, built on ``device`` (CUDA by
    default) with weights drawn from ``generator``."""

    def __init__(self, config: FLMRConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        H = cfg.text_config.hidden_size
        with torch.device("meta"):
            self._build_text(cfg)
            if cfg.separate_query_and_context_text_encoder:
                self.query_text_encoder = FLMRTextModel(cfg.text_config)
                self.query_text_encoder_linear = nn.Linear(H, cfg.dim, bias=False)
            if cfg.use_vision_encoder:
                self._build_vision(cfg, cfg.use_transformer_mapping_network)
                if cfg.separate_query_and_context_vision_encoder:
                    self.query_vision_encoder = FLMRVisionModel(cfg.vision_config)
                    self.query_vision_projection = VisionProjection(
                        cfg.vision_config.hidden_size, cfg.dim,
                        cfg.mapping_network_prefix_length)
        materialize_(self, device, dtype, generator, cfg.initializer_range)

    def _query_text_encoder(self, ids, mask):
        if self.config.separate_query_and_context_text_encoder:
            return self.query_text_encoder(ids, mask), self.query_text_encoder_linear
        return self.context_text_encoder(ids, mask), self.context_text_encoder_linear

    def _query_projection(self):
        if self.config.separate_query_and_context_vision_encoder:
            return self.query_vision_projection
        return self.context_vision_projection

    def query(self, input_ids: Optional[torch.Tensor], attention_mask: Optional[torch.Tensor],
              pixel_values: Optional[torch.Tensor] = None,
              image_features: Optional[torch.Tensor] = None,
              concat_output_from_vision_encoder: Optional[bool] = None,
              concat_output_from_text_encoder: Optional[bool] = None) -> FLMRQueryOutput:
        """Query token matrices (reference `modeling_flmr.py:1200-1426`)."""
        cfg = self.config
        if concat_output_from_vision_encoder is None:
            concat_output_from_vision_encoder = cfg.query_concat_output_from_vision_encoder
        if concat_output_from_text_encoder is None:
            concat_output_from_text_encoder = cfg.query_concat_output_from_text_encoder

        text_embeddings = text_mask = text_hidden = None
        if input_ids is not None:
            text_out, linear = self._query_text_encoder(input_ids, attention_mask)
            text_hidden = text_out["last_hidden_state"]
            text_embeddings = linear(text_hidden)
            if cfg.mask_instruction:
                keep = query_instruction_mask(input_ids, cfg.instruction_token_id)
            else:
                keep = token_skiplist_mask(input_ids, ())
            text_mask = keep.to(text_embeddings.dtype)[:, :, None]
            text_embeddings = text_embeddings * text_mask

        vision_embeddings = None
        if pixel_values is not None or image_features is not None:
            vis_out = None
            if pixel_values is not None:
                batch_size = pixel_values.shape[0]
                if pixel_values.dim() == 5:  # multiple ROIs: merge into batch
                    pixel_values = pixel_values.reshape((-1,) + pixel_values.shape[2:])
                encoder = (self.query_vision_encoder
                           if cfg.separate_query_and_context_vision_encoder
                           else self.context_vision_encoder)
                vis_out = encoder(pixel_values)
                vision_cls = vis_out["last_hidden_state"][:, 0]
            else:
                batch_size = image_features.shape[0]
                vision_cls = image_features
            vision_embeddings = self._query_projection()(vision_cls)
            vision_embeddings = vision_embeddings.reshape(batch_size, -1, cfg.dim)
            if cfg.use_transformer_mapping_network and vis_out is not None:
                second_last = vis_out["hidden_states"][-2][:, 1:]
                mapped = self._map_vision(cfg, second_last, text_hidden, batch_size)
                vision_embeddings = torch.cat([vision_embeddings, mapped], dim=1)

        if vision_embeddings is None:
            concat_output_from_vision_encoder = False
        if text_embeddings is None:
            concat_output_from_text_encoder = False
        if concat_output_from_vision_encoder and concat_output_from_text_encoder:
            Q = torch.cat([text_embeddings, vision_embeddings], dim=1)
        elif concat_output_from_vision_encoder:
            Q = vision_embeddings
        else:
            Q = text_embeddings

        parts = []
        if concat_output_from_text_encoder and text_embeddings is not None:
            parts.append((attention_mask[:, :, None] * text_mask > 0).int()[..., 0])
        if concat_output_from_vision_encoder and vision_embeddings is not None:
            parts.append(torch.ones(vision_embeddings.shape[:2], dtype=torch.int32,
                                    device=vision_embeddings.device))
        Q = _l2_normalize(Q)
        return FLMRQueryOutput(
            late_interaction_output=Q,
            query_mask=torch.cat(parts, dim=1),
            pooler_output=Q[:, 0, :],
        )

    def doc(self, input_ids: Optional[torch.Tensor], attention_mask: Optional[torch.Tensor],
            pixel_values: Optional[torch.Tensor] = None,
            image_features: Optional[torch.Tensor] = None,
            concat_output_from_vision_encoder: Optional[bool] = None,
            concat_output_from_text_encoder: Optional[bool] = None) -> FLMRContextOutput:
        """Doc token matrices (reference `modeling_flmr.py:1432-1599`); vision
        tokens, if any, are prepended."""
        cfg = self.config
        if concat_output_from_vision_encoder is None:
            concat_output_from_vision_encoder = cfg.context_concat_output_from_vision_encoder
        if concat_output_from_text_encoder is None:
            concat_output_from_text_encoder = cfg.context_concat_output_from_text_encoder

        text_embeddings = text_mask = None
        if input_ids is not None:
            text_out = self.context_text_encoder(input_ids, attention_mask)
            text_embeddings = self.context_text_encoder_linear(text_out["last_hidden_state"])
            skiplist = cfg.punctuation_token_ids if cfg.mask_punctuation else ()
            keep = token_skiplist_mask(input_ids, skiplist)
            text_mask = keep.to(text_embeddings.dtype)[:, :, None]
            text_embeddings = text_embeddings * text_mask

        vision_embeddings = image_mask = None
        if pixel_values is not None or image_features is not None:
            if pixel_values is not None:
                vision_cls = self.context_vision_encoder(pixel_values)["last_hidden_state"][:, 0]
            else:
                vision_cls = image_features
            vision_embeddings = self.context_vision_projection(vision_cls)
            vision_embeddings = vision_embeddings.reshape(
                -1, cfg.mapping_network_prefix_length, cfg.dim)
            mask_dtype = text_mask.dtype if text_mask is not None else torch.float32
            image_mask = torch.ones(vision_embeddings.shape[:2] + (1,), dtype=mask_dtype,
                                    device=vision_embeddings.device)

        if concat_output_from_vision_encoder and concat_output_from_text_encoder:
            D = torch.cat([vision_embeddings, text_embeddings], dim=1)
            mask = torch.cat([image_mask, text_mask], dim=1)
        elif concat_output_from_vision_encoder:
            D, mask = vision_embeddings, image_mask
        else:
            D, mask = text_embeddings, text_mask

        D = _l2_normalize(D)
        return FLMRContextOutput(
            late_interaction_output=D,
            context_mask=mask[..., 0].bool(),
            pooler_output=D[:, 0, :],
        )

    def forward(self, query_input_ids, query_attention_mask, context_input_ids,
                context_attention_mask, query_pixel_values=None, query_image_features=None,
                context_pixel_values=None, context_image_features=None,
                use_in_batch_negatives: bool = True, num_negative_examples: int = 1,
                gather_group=None) -> FLMRForwardOutput:
        """Training forward (reference `modeling_flmr.py:788-1096`).

        The ``context_*`` batch has ``B * (1 + num_negative_examples)`` rows,
        each query's positive first in its group. ``loss`` is the CE of each
        query's aligned scores against its positive; ``in_batch_negative_loss``
        the CE of every query against every doc of the batch, labels
        ``arange(B) * nway``.

        ``gather_group`` (a process group, the JAX ``gather_axis_name``):
        Q, D and D_mask are all-gathered over its ranks before the
        in-batch-negative loss, which then spans the global batch, labels
        ``arange(B_all) * nway``, and is the same on every rank. The gather
        differentiates through every rank's rows (``parallel/mesh.py``)."""
        query_out = self.query(query_input_ids, query_attention_mask,
                               pixel_values=query_pixel_values,
                               image_features=query_image_features)
        Q = query_out.late_interaction_output
        context_out = self.doc(context_input_ids, context_attention_mask,
                               pixel_values=context_pixel_values,
                               image_features=context_image_features)
        D, D_mask = context_out.late_interaction_output, context_out.context_mask

        nway = num_negative_examples + 1
        # each query once per doc of its group; expand's backward sums the
        # copies in a fixed order (repeat_interleave's index_add may not)
        Q_dup = Q[:, None].expand(-1, nway, -1, -1).reshape(-1, *Q.shape[1:])
        scores, scores_raw = colbert_score(Q_dup, D, D_mask)
        scores = scores.reshape(-1, nway)
        loss = _softmax_ce(scores, torch.zeros(scores.shape[0], dtype=torch.long,
                                               device=scores.device))
        ib_loss = None
        if use_in_batch_negatives:
            Q_all, D_all, D_mask_all = Q, D, D_mask
            if gather_group is not None:
                from ..parallel.mesh import gather_rows

                Q_all, D_all = gather_rows(Q, gather_group), gather_rows(D, gather_group)
                D_mask_all = gather_rows(D_mask, gather_group)
            ib_scores = in_batch_maxsim_scores(Q_all, D_all, D_mask_all)
            ib_labels = torch.arange(Q_all.shape[0], device=Q.device) * nway
            ib_loss = _softmax_ce(ib_scores, ib_labels)
        return FLMRForwardOutput(
            loss=loss, in_batch_negative_loss=ib_loss, scores=scores, scores_raw=scores_raw,
            query_late_interaction_output=Q, context_late_interaction_output=D,
            query_mask=query_out.query_mask, context_mask=D_mask)


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over rows of ``logsumexp(logits) - logits[label]``, in fp32."""
    logits = logits.float()
    return (torch.logsumexp(logits, dim=-1) - logits.gather(1, labels[:, None])[:, 0]).mean()
