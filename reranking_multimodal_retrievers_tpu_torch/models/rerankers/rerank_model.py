"""monoPreFLMR cross-encoder rerankers (port of
``models/rerankers/rerank_model.py``).

- :class:`FullContextRerankModel`: query and candidate are tokenised jointly
  as a sentence pair, encoded by the retriever's context text encoder, the
  query image's vision tokens (projection prefix + transformer mapping
  network) are appended, the rows are mapped from the late-interaction space
  to the cross-encoder width, and a shallow BERT cross-encoder scores each
  row.
- :class:`RerankModel`: the spliced variant. The query's tokens replace the
  head of the candidate's, the rows are reordered to [query, image,
  context], and PreFLMR's token scores may bias the cross-encoder's
  attention (``fusion_attention_adj``).

Both return the ranking logits and the training loss of
``RerankConfig.loss_fn``. The reference computes ``loss_fn(logits,
logits)`` in ``RerankModel`` (labels ignored); ``replicate_reference_loss_bug``
keeps that, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike
from ..bert import BertConfig
from ..flmr import (FLMRBackbone, FLMRConfig, _l2_normalize, query_instruction_mask,
                    token_skiplist_mask)
from ..init import materialize_
from .cross_encoder import CrossEncoder, fusion_attention_adj
from .losses import prepare_logits_labels, primary_logits, rerank_loss

HEAD_TOKEN_LEEWAY = 4  # reference `utils.py:72`


@dataclasses.dataclass(frozen=True)
class RerankConfig:
    flmr: FLMRConfig
    cross_encoder: BertConfig
    loss_fn: str = "BCE"
    pos_weight: Optional[float] = None
    max_query_length: int = 32
    max_decoder_source_length: int = 512
    replicate_reference_loss_bug: bool = False

    @property
    def max_context_length(self) -> int:
        return self.max_decoder_source_length - self.max_query_length - HEAD_TOKEN_LEEWAY

    @classmethod
    def tiny(cls, **kw):
        flmr = FLMRConfig.tiny()
        ce = dataclasses.replace(
            flmr.text_config, num_hidden_layers=1, max_position_embeddings=512)
        defaults = dict(flmr=flmr, cross_encoder=ce)
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass
class RerankOutput:
    loss: torch.Tensor  # 0-d fp32, the training loss of config.loss_fn
    logits: torch.Tensor  # [rows, 1] ranking logits


class _RerankBase(FLMRBackbone):
    """The frozen-retriever encoding path shared by the monoPreFLMR
    rerankers: the context text encoder, and always the mapping network."""

    def __init__(self, config: RerankConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        flmr = config.flmr
        with torch.device("meta"):
            self._build_text(flmr)
            self._build_vision(flmr, mapping_network=True)
            self.cross_encoder_input_mapping = nn.Linear(
                flmr.dim, config.cross_encoder.hidden_size)
            self.reranker = CrossEncoder(config.cross_encoder)
        materialize_(self, device, dtype, generator, flmr.initializer_range)

    def encode_vision(self, pixel_values):
        """Run the ViT once per image: returns ``(vision_cls, second_last)``,
        the CLS embedding and the second-to-last hidden layer without CLS."""
        vis_out = self.context_vision_encoder(pixel_values)
        return vis_out["last_hidden_state"][:, 0], vis_out["hidden_states"][-2][:, 1:]

    def encode_query(self, input_ids, attention_mask, pixel_values=None,
                     image_features=None, mask_instructions: bool = False,
                     token_type_ids=None, vision_feats=None):
        """L2-normalised [text rows + vision rows, dim] matrices and the text
        token mask. ``vision_feats`` is a precomputed per-row
        ``(vision_cls, second_last)`` pair."""
        flmr = self.config.flmr
        text_hidden = self.context_text_encoder(
            input_ids, attention_mask, token_type_ids=token_type_ids)["last_hidden_state"]
        text_embeddings = self.context_text_encoder_linear(text_hidden)
        if mask_instructions:
            keep = query_instruction_mask(input_ids, flmr.instruction_token_id)
        else:
            keep = token_skiplist_mask(input_ids, ())
        text_mask = keep.to(text_embeddings.dtype)[:, :, None]
        text_embeddings = text_embeddings * text_mask

        vision_embeddings = None
        if pixel_values is not None or image_features is not None or vision_feats is not None:
            second_last = None
            if vision_feats is not None:
                vision_cls, second_last = vision_feats
                batch_size = vision_cls.shape[0]
            elif pixel_values is not None:
                batch_size = pixel_values.shape[0]
                if pixel_values.dim() == 5:
                    pixel_values = pixel_values.reshape((-1,) + pixel_values.shape[2:])
                vision_cls, second_last = self.encode_vision(pixel_values)
            else:
                batch_size = image_features.shape[0]
                vision_cls = image_features
            vision_embeddings = self.context_vision_projection(vision_cls)
            vision_embeddings = vision_embeddings.reshape(batch_size, -1, flmr.dim)
            if second_last is not None:
                mapped = self._map_vision(flmr, second_last, text_hidden, batch_size)
                vision_embeddings = torch.cat([vision_embeddings, mapped], dim=1)

        Q = text_embeddings if vision_embeddings is None else torch.cat(
            [text_embeddings, vision_embeddings], dim=1)
        return _l2_normalize(Q), text_mask[..., 0]

    def _score(self, reranker_inputs, reranker_attention_mask, attention_adj,
               batch_size, num_negative_examples, labels, token_type_ids=None):
        logits1, logits2 = self.reranker(
            reranker_inputs, attention_mask=reranker_attention_mask,
            attention_adj=attention_adj, token_type_ids=token_type_ids)
        cfg = self.config
        logits, lbl = prepare_logits_labels(
            cfg.loss_fn, logits1, logits2, batch_size, num_negative_examples, labels)
        loss = rerank_loss(cfg.loss_fn, logits,
                           logits if cfg.replicate_reference_loss_bug else lbl, cfg.pos_weight)
        return RerankOutput(loss=loss, logits=primary_logits(cfg.loss_fn, logits))


class RerankModel(_RerankBase):
    """Spliced-query monoPreFLMR reranker (reference `rerank_model.py:171-331`).
    ``context_*`` has ``B * (1 + num_negative_examples)`` rows;
    ``preflmr_scores [rows, Lc, q_ret]``, if given, are the retriever's
    token scores that bias attention."""

    def forward(self, query_input_ids, query_attention_mask, query_pixel_values,
                context_input_ids, context_attention_mask, num_negative_examples: int,
                preflmr_scores=None, fusion_multiplier: float = 1.0, labels=None,
                mask_instructions: Optional[bool] = None) -> RerankOutput:
        cfg = self.config
        batch_size = query_input_ids.shape[0]
        nway = num_negative_examples + 1
        expanded = batch_size * nway
        if context_input_ids.shape[0] != expanded:
            raise ValueError(f"{context_input_ids.shape[0]} context rows for {batch_size} "
                             f"queries x {nway}")
        q_ids = torch.repeat_interleave(query_input_ids, nway, dim=0)
        q_mask = torch.repeat_interleave(query_attention_mask, nway, dim=0)
        pix = (None if query_pixel_values is None
               else torch.repeat_interleave(query_pixel_values, nway, dim=0))
        Lq, Lc = q_ids.shape[1], context_input_ids.shape[1]
        # the query replaces the context's head; its tokens [2 : Lc-Lq+2] stay
        joint_ids = torch.cat([q_ids, context_input_ids[:, 2:Lc - Lq + 2]], dim=1)
        joint_mask = torch.cat([q_mask, context_attention_mask[:, 2:Lc - Lq + 2]], dim=1)
        mask_instr = cfg.flmr.mask_instruction if mask_instructions is None else mask_instructions
        Q, text_mask = self.encode_query(joint_ids, joint_mask, pixel_values=pix,
                                         mask_instructions=mask_instr)
        reranker_inputs = self.cross_encoder_input_mapping(Q)
        ctx_rows = joint_ids.shape[1]
        img_rows = reranker_inputs.shape[1] - ctx_rows
        reranker_attention_mask = torch.cat(
            [text_mask.int(), torch.ones(expanded, img_rows, dtype=torch.int32,
                                         device=Q.device)], dim=1)

        def reorder(x):  # [query text, image, context]
            return torch.cat([x[:, :Lq], x[:, ctx_rows:], x[:, Lq:ctx_rows]], dim=1)

        reranker_inputs = reorder(reranker_inputs)
        reranker_attention_mask = reorder(reranker_attention_mask)
        attention_adj = None
        if preflmr_scores is not None:
            attention_adj = fusion_attention_adj(
                preflmr_scores[:, 2:Lc - Lq + 2, :], query_rows=Lq + img_rows,
                context_rows=ctx_rows - Lq, fusion_multiplier=fusion_multiplier)
        return self._score(reranker_inputs, reranker_attention_mask, attention_adj,
                           batch_size, num_negative_examples, labels)


class FullContextRerankModel(_RerankBase):
    """Joint-retokenisation monoPreFLMR reranker (reference
    `rerank_model.py:515-591`). Inputs arrive pre-tokenised as sentence pairs,
    expanded to ``[B * (1 + num_negative_examples), L]``."""

    def forward(self, input_ids, attention_mask, token_type_ids, query_pixel_values,
                num_negative_examples: int, labels=None, vision_feats=None) -> RerankOutput:
        nway = num_negative_examples + 1
        expanded = input_ids.shape[0]
        batch_size = expanded // nway
        text_only = query_pixel_values is None and vision_feats is None
        pix = None
        if not text_only and vision_feats is None:
            pix = torch.repeat_interleave(query_pixel_values, nway, dim=0)
        Q, text_mask = self.encode_query(
            input_ids, attention_mask, pixel_values=pix, mask_instructions=False,
            token_type_ids=token_type_ids, vision_feats=vision_feats)
        reranker_inputs = self.cross_encoder_input_mapping(Q)
        reranker_attention_mask = text_mask.int()
        if not text_only:
            img_rows = reranker_inputs.shape[1] - text_mask.shape[1]
            reranker_attention_mask = torch.cat(
                [reranker_attention_mask,
                 torch.ones(expanded, img_rows, dtype=torch.int32, device=Q.device)], dim=1)
        return self._score(reranker_inputs, reranker_attention_mask, None,
                           batch_size, num_negative_examples, labels)
