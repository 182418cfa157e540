"""The reranker executor's input builders (port of the input side of
``executors/reranker_executor.py``): what a frozen retriever gives the
interaction rerankers and attention fusion. Each function takes the
retriever (an ``FLMRModelForRetrieval``) and the tokenised batch where the
JAX executor's methods take ``self``; the executor class is not ported yet.
Both run without autograd: the retriever is frozen.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


@torch.no_grad()
def interaction_inputs(retriever, query_input_ids, query_attention_mask, context_input_ids,
                       context_attention_mask, query_pixel_values: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """The frozen retriever's query and doc token matrices as an
    ``InteractionRerankModel``'s inputs (JAX ``reranker_executor.py:714-748``):
    ``query_late_interaction``, ``context_late_interaction``, ``query_mask``
    and ``context_mask`` (int32). ``query_pixel_values`` is None for a
    text-only reranker or a retriever without its vision encoder."""
    qout = retriever.query(query_input_ids, query_attention_mask, pixel_values=query_pixel_values)
    dout = retriever.doc(context_input_ids, context_attention_mask)
    return dict(query_late_interaction=qout.late_interaction_output,
                context_late_interaction=dout.late_interaction_output,
                query_mask=qout.query_mask,
                context_mask=dout.context_mask.to(torch.int32))


@torch.no_grad()
def fusion_inputs(retriever, query_input_ids, query_attention_mask, context_input_ids,
                  context_attention_mask, num_negative_examples: int,
                  query_pixel_values: Optional[torch.Tensor] = None,
                  fusion_multiplier: float = 1.0) -> Dict[str, object]:
    """PreFLMR attention fusion's inputs (JAX ``reranker_executor.py:674-712``):
    the retriever's masked token scores of each query against its (1 +
    ``num_negative_examples``) candidates, ``preflmr_scores [rows, Lc, Lq]``,
    and ``fusion_multiplier``."""
    out = retriever(query_input_ids=query_input_ids, query_attention_mask=query_attention_mask,
                    context_input_ids=context_input_ids,
                    context_attention_mask=context_attention_mask,
                    query_pixel_values=query_pixel_values,
                    num_negative_examples=num_negative_examples, use_in_batch_negatives=False)
    return {"preflmr_scores": out.scores_raw, "fusion_multiplier": fusion_multiplier}
