"""Late-interaction (ColBERT-style) MaxSim scoring in plain PyTorch.

Port of ``reranking_multimodal_retrievers_tpu/ops/maxsim.py``: the math under
kernel K1 (``ops/maxsim_cuda.py``), with the same conventions:

Q : [num_queries, L_q, dim]     query token embeddings (masked rows are zero)
D : [num_docs,    L_d, dim]     doc token embeddings (padded)
D_mask : [num_docs, L_d]        1/True for valid doc tokens

A masked doc token's score is replaced with ``MASK_FILL_VALUE`` (-9999, not
-inf), so a doc with no valid token totals about -9999 * L_q.
"""

from __future__ import annotations

import torch

MASK_FILL_VALUE = -9999.0


def colbert_score_reduce(scores_padded: torch.Tensor, d_mask: torch.Tensor):
    """Reduce a padded [num_docs, L_d, L_q] token-score tensor to per-doc
    scores. Returns ``(scores [num_docs], scores_masked [num_docs, L_d, L_q])``
    where masked doc-token rows of ``scores_masked`` hold -9999."""
    if d_mask.dim() == 3:
        d_mask = d_mask[..., 0]
    valid = d_mask.bool()[:, :, None]
    scores_masked = torch.where(
        valid, scores_padded,
        torch.tensor(MASK_FILL_VALUE, dtype=scores_padded.dtype,
                     device=scores_padded.device))
    per_query_token_max = scores_masked.max(dim=1).values  # [num_docs, L_q]
    return per_query_token_max.sum(dim=-1), scores_masked


def colbert_score(Q: torch.Tensor, D_padded: torch.Tensor, d_mask: torch.Tensor):
    """MaxSim of one query ([1, L_q, dim]) against every doc, or of aligned
    (query, doc) pairs ([num_docs, L_q, dim]). Products accumulate in fp32.

    Returns (scores [num_docs], scores_masked [num_docs, L_d, L_q])."""
    if Q.dim() != 3 or D_padded.dim() != 3:
        raise ValueError(f"expected 3-D Q and D, got {Q.shape}, {D_padded.shape}")
    Qf = Q.to(D_padded.dtype).float()  # the reference casts Q to D's dtype
    Df = D_padded.float()
    if Q.shape[0] == 1:
        scores = torch.einsum("nld,qd->nlq", Df, Qf[0])
    else:
        scores = torch.einsum("nld,nqd->nlq", Df, Qf)
    return colbert_score_reduce(scores, d_mask)
