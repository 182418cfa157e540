"""Cross-encoder head: a shallow BERT over mapped late-interaction features
with two scalar heads over the CLS output, and the PreFLMR attention-fusion
bias (port of ``models/rerankers/cross_encoder.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..bert import BertConfig, BertModel


class CrossEncoder(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.bert_model = BertModel(config, add_pooling_layer=False,
                                    with_word_embeddings=False, device="meta")
        self.classifier1 = nn.Linear(config.hidden_size, 1)
        self.classifier2 = nn.Linear(config.hidden_size, 1)

    def forward(self, inputs_embeds, attention_mask=None, attention_adj=None,
                token_type_ids=None):
        out = self.bert_model(inputs_embeds=inputs_embeds, attention_mask=attention_mask,
                              attention_adj=attention_adj, token_type_ids=token_type_ids)
        cls = out["last_hidden_state"][:, 0]
        return self.classifier1(cls), self.classifier2(cls)


def fusion_attention_adj(scores: torch.Tensor, query_rows: int, context_rows: int,
                         fusion_multiplier: float = 1.0) -> torch.Tensor:
    """The attention-fusion additive bias from a retriever token-score block
    ``scores [B, context_rows, q_ret]`` (reference `rerank_model.py:276-319`):
    a ``[B, query_rows + context_rows]``-square bias with zero diagonal
    blocks and row-softmaxed cross blocks, times ``fusion_multiplier``. A
    retriever with fewer query tokens than the reranker (``q_ret <
    query_rows``) biases only its own: the extra rows and columns get 0."""
    B, _, q_ret = scores.shape
    if q_ret > query_rows:
        raise ValueError(f"{q_ret} retriever query tokens for {query_rows} reranker rows")
    upper_right = F.pad(torch.softmax(scores.transpose(1, 2), dim=-1),
                        (0, 0, 0, query_rows - q_ret))
    bottom_left = F.pad(torch.softmax(scores, dim=-1), (0, query_rows - q_ret))
    top = torch.cat([scores.new_zeros(B, query_rows, query_rows), upper_right], dim=2)
    bottom = torch.cat([bottom_left, scores.new_zeros(B, context_rows, context_rows)], dim=2)
    return torch.cat([top, bottom], dim=1) * fusion_multiplier
