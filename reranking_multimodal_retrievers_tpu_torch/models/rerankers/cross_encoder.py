"""Cross-encoder head: a shallow BERT over mapped late-interaction features
with two scalar heads over the CLS output (port of
``models/rerankers/cross_encoder.py::CrossEncoder``)."""

from __future__ import annotations

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
