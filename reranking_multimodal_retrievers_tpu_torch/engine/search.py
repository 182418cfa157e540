"""Exact MaxSim search over a device-resident token index (port of
``engine/search.py`` on one device: ``_local_search``, ``make_search_fn``,
``search_exhaustive`` and ``Searcher``).

Scoring goes through kernel K1 (``ops/maxsim_cuda.py``) over doc slabs, then
``torch.topk``. The JAX package's Mosaic limits (the 2^23-token slab assert,
the VMEM tile budget and the %8/%128 alignment gate) do not apply: the
kernel takes any shape, and slabs only bound the size of one launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.maxsim import MASK_FILL_VALUE
from ..ops.maxsim_cuda import maxsim_scores
from .index import TokenIndex

SLAB_DOCS = 32768  # docs scored per kernel launch


def _local_search(Q, D, M, *, k: int, score_dtype=torch.float32,
                  unpadded: bool = False):
    """Score every doc of ``D`` against the queries and return the top-k
    ``(values [B, k], indices [B, k])``.

    ``unpadded=True`` (every real doc has exactly L_d real tokens) drops the
    per-token mask from the kernel; whole-padding docs (all-False mask rows)
    are still kept out of the top-k by a per-doc pass."""
    M_kernel = None if unpadded else M
    scores = torch.cat([
        maxsim_scores(Q, D[s:s + SLAB_DOCS],
                      None if M_kernel is None else M_kernel[s:s + SLAB_DOCS],
                      score_dtype=score_dtype)
        for s in range(0, D.shape[0], SLAB_DOCS)
    ], dim=1)
    if unpadded:
        scores = torch.where(M.any(dim=1)[None, :], scores,
                             torch.tensor(MASK_FILL_VALUE * Q.shape[1], device=scores.device))
    return torch.topk(scores, k, dim=1)


def make_search_fn(n_padded_docs: int, k: int, score_dtype=torch.float32,
                   unpadded: bool = False):
    """The search program for an index of ``n_padded_docs`` docs:
    ``fn(Q, D, M) -> (values [B, k], indices [B, k])``."""
    k_eff = min(k, n_padded_docs)

    def search_fn(Q, D, M):
        with torch.inference_mode():
            return _local_search(Q, D, M, k=k_eff, score_dtype=score_dtype,
                                 unpadded=unpadded)

    return search_fn


def search_exhaustive(index: TokenIndex, Q, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Search the index with a batch of query matrices ``Q [B, L_q, dim]``
    (masked rows zeroed). Returns ``(scores [B, k] fp32, doc_indices [B, k])``
    as numpy; padding docs never win (their score is about -9999 * L_q)."""
    fn = make_search_fn(index.num_padded_docs, k)
    Q = torch.as_tensor(Q).to(device=index.embeddings.device, dtype=index.embeddings.dtype)
    vals, idx = fn(Q, index.embeddings, index.mask)
    return vals.cpu().numpy(), idx.cpu().numpy()


@dataclass
class Searcher:
    """Hold an index and its search program and map results to doc ids."""

    index: TokenIndex
    k: int = 100

    def __post_init__(self):
        self._fn = make_search_fn(self.index.num_padded_docs, self.k)

    def search(self, Q):
        """Returns (doc_ids list[list[str]], scores [B, k] numpy)."""
        emb = self.index.embeddings
        vals, idx = self._fn(torch.as_tensor(Q).to(device=emb.device, dtype=emb.dtype),
                             emb, self.index.mask)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        n = self.index.num_docs
        ids = [[self.index.doc_ids[j] for j in row if j < n][: self.k] for row in idx]
        return ids, vals
