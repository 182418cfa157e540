"""ModPreFLMR interaction rerankers: rerank from a frozen retriever's
late-interaction outputs only (port of ``models/rerankers/interaction.py``).

Two interaction types over the mapped query and context token matrices:

- ``CrossEncoder``: the query rows (repeated once per candidate) and the
  context rows are concatenated, mapped to the BERT width and scored by the
  shallow :class:`CrossEncoder`; with no attention fusion its
  self-attention goes through kernel K2 under ``use_pallas_attention``.
- ``MORES``: per layer, the query attends the context (cross-attention)
  *then* itself, then an FFN; the CLS row feeds two heads. No kernel runs
  on this path, as in the JAX package.

The encoders never run at rerank time: the executor feeds the retriever's
outputs (``executors/reranker_executor.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike
from ..bert import BertAttention, BertConfig, _linear, additive_mask
from ..init import materialize_
from .cross_encoder import CrossEncoder, fusion_attention_adj
from .losses import prepare_logits_labels, primary_logits, rerank_loss
from .rerank_model import RerankOutput

LATE_INTERACTION_EMBEDDING_SIZE = 128  # reference `interaction_rerank_model.py:84`


@dataclasses.dataclass(frozen=True)
class InteractionRerankConfig:
    cross_encoder: BertConfig
    interaction_type: str = "CrossEncoder"  # or "MORES"
    loss_fn: str = "BCE"
    pos_weight: Optional[float] = None
    late_interaction_dim: int = LATE_INTERACTION_EMBEDDING_SIZE

    @classmethod
    def tiny(cls, **kw):
        ce = BertConfig.tiny(max_position_embeddings=512)
        defaults = dict(cross_encoder=ce, late_interaction_dim=16)
        defaults.update(kw)
        return cls(**defaults)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU computed as ``jax.nn.gelu(approximate=False)``
    does, each step rounded to ``x``'s dtype: ``0.5 x * erfc(-x / sqrt 2)``
    with ``1 / sqrt 2`` in that dtype. In fp32 it is ``F.gelu`` to round-off;
    in bf16 it keeps the JAX package's roundings, which ``F.gelu`` (one
    rounding of the fp32 result) does not."""
    c = torch.tensor(2.0 ** -0.5, dtype=x.dtype, device=x.device)
    return (x * 0.5) * torch.erfc(-x * c)


class MORESLayer(nn.Module):
    """Cross-attention, then self-attention, then an FFN with the exact GELU
    whatever ``gelu_approximate`` says (reference ``MORES_BertLayer``). Its
    FFN layers are plain linears (no W8A8 under ``quantize_int8``), named
    ``intermediate``, ``output`` and ``layernorm``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.crossattention = BertAttention(cfg)
        self.attention = BertAttention(cfg)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, hidden, qry_mask_bias, doc, doc_mask_bias):
        hidden = self.crossattention(hidden, kv_states=doc, mask_bias=doc_mask_bias)
        hidden = self.attention(hidden, mask_bias=qry_mask_bias)
        inter = gelu_exact(self.intermediate(hidden))
        return self.layernorm(self.output(inter) + hidden)


class MORESSym(nn.Module):
    """MORES blocks over the mapped query and doc rows (reference
    `mores_model.py:60-94`). ``attention_adj``, a ``[B, Lq + Lc, Lq + Lc]``
    fusion bias, biases every layer's cross-attention with its query-to-doc
    block ``adj[:, :Lq, Lq:]`` only: doc rows are keys and values here and
    attend nothing, so the doc-to-query block has no place to go."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layers = nn.ModuleList(MORESLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.classifier1 = nn.Linear(cfg.hidden_size, 1)
        self.classifier2 = nn.Linear(cfg.hidden_size, 1)

    def forward(self, qry, doc, qry_mask, cross_mask, attention_adj=None):
        Lq = qry.shape[1]
        qb = additive_mask(qry_mask)
        db = additive_mask(cross_mask)
        if attention_adj is not None:
            db = db + attention_adj[:, None, :Lq, Lq:]
        hidden = qry
        for layer in self.layers:
            hidden = layer(hidden, qb, doc, db)
        cls = hidden[:, 0]
        return self.classifier1(cls), self.classifier2(cls)


class InteractionRerankModel(nn.Module):
    """The interaction reranker (reference `interaction_rerank_model.py:86-166`),
    built on ``device`` (CUDA by default) with weights drawn from
    ``generator``.

    ``query_late_interaction [B, Lq, dim]`` and ``query_mask [B, Lq]``;
    ``context_late_interaction [B * (1 + num_negative_examples), Lc, dim]``
    and ``context_mask``, each query's candidates in a row.
    ``preflmr_scores [rows, Lc, Lq]``, the retriever's token scores, make the
    attention-fusion bias (``fusion_attention_adj``), which keeps the
    cross-encoder off K2. MORES maps the docs in fp32 and the queries in
    their own dtype, as the JAX package does: with bf16 weights its doc keys
    and values are fp32."""

    def __init__(self, config: InteractionRerankConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.interaction_type not in ("CrossEncoder", "MORES"):
            raise ValueError(f"interaction_type must be 'CrossEncoder' or 'MORES', got "
                             f"{config.interaction_type!r}")
        self.config = config
        ce = config.cross_encoder
        with torch.device("meta"):
            self.cross_encoder_input_mapping = nn.Linear(config.late_interaction_dim,
                                                         ce.hidden_size)
            self.reranker = (MORESSym(ce) if config.interaction_type == "MORES"
                             else CrossEncoder(ce))
        materialize_(self, device, dtype, generator, ce.initializer_range)

    def forward(self, query_late_interaction, context_late_interaction,
                num_negative_examples: int, query_mask, context_mask, preflmr_scores=None,
                fusion_multiplier: float = 1.0, labels=None) -> RerankOutput:
        cfg = self.config
        batch_size = query_late_interaction.shape[0]
        nway = num_negative_examples + 1
        if context_late_interaction.shape[0] != batch_size * nway:
            raise ValueError(f"{context_late_interaction.shape[0]} context rows for "
                             f"{batch_size} queries x {nway}")
        Lq, Lc = query_late_interaction.shape[1], context_late_interaction.shape[1]
        q = torch.repeat_interleave(query_late_interaction, nway, dim=0)
        qm = torch.repeat_interleave(query_mask, nway, dim=0)
        attention_adj = None
        if preflmr_scores is not None:
            attention_adj = fusion_attention_adj(preflmr_scores, query_rows=Lq, context_rows=Lc,
                                                 fusion_multiplier=fusion_multiplier)
        mapping = self.cross_encoder_input_mapping
        if cfg.interaction_type == "MORES":
            logits1, logits2 = self.reranker(
                qry=_linear(mapping, q), doc=_linear(mapping, context_late_interaction.float()),
                qry_mask=qm, cross_mask=context_mask, attention_adj=attention_adj)
        else:
            inputs = _linear(mapping, torch.cat([q, context_late_interaction], dim=1))
            mask = torch.cat([qm.int(), context_mask.int()], dim=1)
            logits1, logits2 = self.reranker(inputs, attention_mask=mask,
                                             attention_adj=attention_adj)
        logits, lbl = prepare_logits_labels(cfg.loss_fn, logits1, logits2, batch_size,
                                            num_negative_examples, labels)
        loss = rerank_loss(cfg.loss_fn, logits, lbl, cfg.pos_weight)
        return RerankOutput(loss=loss, logits=primary_logits(cfg.loss_fn, logits))
