"""Late-interaction (ColBERT-style) MaxSim scoring in plain PyTorch.

Port of ``reranking_multimodal_retrievers_tpu/ops/maxsim.py``: the math under
kernel K1 (``ops/maxsim_cuda.py``), with the same conventions:

Q : [num_queries, L_q, dim]     query token embeddings (masked rows are zero)
D : [num_docs,    L_d, dim]     doc token embeddings (padded)
D_mask : [num_docs, L_d]        1/True for valid doc tokens

A masked doc token's score is replaced with ``MASK_FILL_VALUE`` (-9999, not
-inf), so a doc with no valid token totals about -9999 * L_q.

Everything here is differentiable and accumulates in fp32: the training
scores (``colbert_score`` on aligned pairs, ``in_batch_maxsim_scores``) run
here, outside any kernel, as in the JAX package. Maxima are ``amax``, whose
gradient is shared evenly between tied entries, as ``jnp.max``'s is.
"""

from __future__ import annotations

import torch

MASK_FILL_VALUE = -9999.0


def colbert_score_reduce(scores_padded: torch.Tensor, d_mask: torch.Tensor):
    """Reduce a padded [num_docs, L_d, L_q] token-score tensor to per-doc
    scores. Returns ``(scores [num_docs], scores_masked [num_docs, L_d, L_q])``
    where masked doc-token rows of ``scores_masked`` hold -9999."""
    scores_masked = _masked(scores_padded, d_mask)
    per_query_token_max = scores_masked.amax(dim=1)  # [num_docs, L_q]
    return per_query_token_max.sum(dim=-1), scores_masked


def _masked(scores_padded: torch.Tensor, d_mask: torch.Tensor) -> torch.Tensor:
    """Masked doc-token rows of a [num_docs, L_d, L_q] block set to -9999."""
    if d_mask.dim() == 3:
        d_mask = d_mask[..., 0]
    return torch.where(d_mask.bool()[:, :, None], scores_padded,
                       scores_padded.new_tensor(MASK_FILL_VALUE))


def flipr_score_reduce(scores_padded: torch.Tensor, d_mask: torch.Tensor,
                       query_maxlen: int, K2: int = 8):
    """The FLIPR interaction (Baleen): the top ``query_maxlen // 2``
    per-token maxima over the first ``query_maxlen`` query columns, plus the
    top ``K2`` over the rest, which count only when there are at least
    ``K2`` of them (the reference adds nothing otherwise). Returns
    ``(scores [num_docs], scores_masked)`` like :func:`colbert_score_reduce`."""
    if scores_padded.shape[-1] < query_maxlen:
        raise ValueError(f"flipr needs at least query_maxlen={query_maxlen} query "
                         f"columns, got {tuple(scores_padded.shape)}")
    scores_masked = _masked(scores_padded, d_mask)
    per_tok = scores_masked.amax(dim=1)  # [num_docs, L_q]
    A = per_tok[:, :query_maxlen].topk(query_maxlen // 2, dim=-1).values.sum(dim=-1)
    if K2 <= per_tok.shape[1] - query_maxlen:
        A = A + per_tok[:, query_maxlen:].topk(K2, dim=-1).values.sum(dim=-1)
    return A, scores_masked


def colbert_score(Q: torch.Tensor, D_padded: torch.Tensor, d_mask: torch.Tensor,
                  interaction: str = "colbert", query_maxlen: int = 32, K2: int = 8):
    """MaxSim of one query ([1, L_q, dim]) against every doc, or of aligned
    (query, doc) pairs ([num_docs, L_q, dim]). Products accumulate in fp32;
    ``interaction`` is ``"colbert"`` (sum of per-token maxima) or
    ``"flipr"`` (:func:`flipr_score_reduce`).

    Returns (scores [num_docs], scores_masked [num_docs, L_d, L_q])."""
    if Q.dim() != 3 or D_padded.dim() != 3:
        raise ValueError(f"expected 3-D Q and D, got {Q.shape}, {D_padded.shape}")
    if interaction not in ("colbert", "flipr"):
        raise ValueError(f"interaction must be 'colbert' or 'flipr', got {interaction!r}")
    Qf = Q.to(D_padded.dtype).float()  # the reference casts Q to D's dtype
    Df = D_padded.float()
    if Q.shape[0] == 1:
        scores = torch.einsum("nld,qd->nlq", Df, Qf[0])
    else:
        scores = torch.einsum("nld,nqd->nlq", Df, Qf)
    if interaction == "flipr":
        return flipr_score_reduce(scores, d_mask, query_maxlen, K2)
    return colbert_score_reduce(scores, d_mask)


def in_batch_maxsim_scores(Q: torch.Tensor, D: torch.Tensor, d_mask: torch.Tensor):
    """All-pairs MaxSim scores for in-batch-negative training: every query
    ``Q [B_q, L_q, dim]`` against every doc ``D [B_d, L_d, dim]`` with
    ``d_mask [B_d, L_d]``. Returns ``[B_q, B_d]`` fp32."""
    if d_mask.dim() == 3:
        d_mask = d_mask[..., 0]
    scores = torch.einsum("qld,btd->qbtl", Q.float(), D.float())
    scores = torch.where(d_mask.bool()[None, :, :, None], scores,
                         scores.new_tensor(MASK_FILL_VALUE))
    return scores.amax(dim=2).sum(dim=-1)


def padded_maxsim(scores_padded: torch.Tensor, d_mask: torch.Tensor) -> torch.Tensor:
    """Per-doc MaxSim totals from a padded [num_docs, L_d, L_q] score tensor."""
    return colbert_score_reduce(scores_padded, d_mask)[0]


def segmented_maxsim(packed_scores: torch.Tensor, doclens: torch.Tensor,
                     num_docs: int) -> torch.Tensor:
    """Per-doc MaxSim totals from a packed ``[total_doc_tokens, L_q]`` score
    matrix whose docs have ``doclens [num_docs]`` tokens each, in order.
    Rows past ``sum(doclens)`` are ignored; a doc of length 0 scores 0."""
    total = packed_scores.shape[0]
    ends = torch.cumsum(doclens, 0)
    # rows past the last doc get segment num_docs, a trash segment
    seg = torch.searchsorted(ends, torch.arange(total, device=packed_scores.device),
                             right=True)
    valid = (seg < num_docs)[:, None]
    data = torch.where(valid, packed_scores.float(),
                       packed_scores.new_tensor(MASK_FILL_VALUE, dtype=torch.float32))
    per_doc = data.new_full((num_docs + 1, data.shape[1]), float("-inf"))
    per_doc = per_doc.scatter_reduce(0, seg[:, None].expand_as(data), data, reduce="amax",
                                     include_self=True)[:num_docs]
    per_doc = torch.where(doclens[:, None] > 0, per_doc, per_doc.new_zeros(()))
    return per_doc.sum(dim=-1)
