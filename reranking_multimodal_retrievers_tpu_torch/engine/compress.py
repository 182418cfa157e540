"""Training-free token pooling for the device-resident token index (port of
``engine/compress.py``).

Each document's token embeddings are merged into ``L_d / factor`` pooled
vectors by per-doc spherical k-means, shrinking the index (and the exact
search's work) by ``factor`` at a small recall cost. It composes with the
int8 residual codec (``engine/codec.py``): pooling cuts tokens, the codec
bytes per token.

The k-means runs on every doc of a batch at once: batched fp32 products
(TF32 off), ``argmax``, a one-hot segment mean. Centroids are
re-normalised each round (norm floor 1e-6, where ``engine/kmeans.py`` uses
1e-12, as in the JAX package), so pooled MaxSim stays a dot product of unit
vectors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..device import fp32_matmul
from .index import TokenIndex


def _norm(c: torch.Tensor) -> torch.Tensor:
    return c / torch.linalg.vector_norm(c, dim=-1, keepdim=True).clamp_min(1e-6)


def _assign(x, cent, mask, L_p: int, m):
    """The masked one-hot assignment ``[N, L, L_p]`` of each token to its
    nearest centroid (padding tokens to none)."""
    sim = torch.einsum("nld,npd->nlp", x, cent)  # cosine on the sphere
    sim = torch.where(mask[..., None], sim, float("-inf"))
    return F.one_hot(sim.argmax(dim=-1), L_p).float() * m


def pool_doc_tokens(emb: torch.Tensor, mask: torch.Tensor, factor: int = 2,
                    iters: int = 4):
    """Pool each doc's tokens into ``L_d // factor`` unit-norm vectors.

    Args:
      emb: [N, L_d, dim] (bf16/fp32) L2-normalised token embeddings.
      mask: [N, L_d] bool token validity.
      factor: pooling factor (must divide L_d).
      iters: spherical k-means refinement rounds.

    Returns:
      (pooled [N, L_p, dim] in emb's dtype, pooled_mask [N, L_p] bool)
    """
    N, L, dim = emb.shape
    if L % factor:
        raise ValueError(f"factor {factor} must divide doc length {L}")
    L_p = L // factor
    mask = mask.bool()
    x = emb.float()
    m = mask.float()[..., None]  # [N, L, 1]
    xm = x * m
    # strided init keeps positional spread; renormalised to the sphere
    cent = _norm(x[:, ::factor, :])
    with fp32_matmul():
        for _ in range(iters):
            onehot = _assign(x, cent, mask, L_p, m)
            sums = torch.einsum("nlp,nld->npd", onehot, xm)
            counts = onehot.sum(dim=1)[..., None]  # [N, L_p, 1]
            cent = _norm(torch.where(counts > 0, sums / counts.clamp_min(1.0), cent))
        # the final assignment decides each pooled slot's validity, and the
        # mean is recomputed from it (cent lags one E-step)
        onehot = _assign(x, cent, mask, L_p, m)
        counts = onehot.sum(dim=1)  # [N, L_p]
        sums = torch.einsum("nlp,nld->npd", onehot, xm)
    pooled_mask = counts > 0
    pooled = torch.where(pooled_mask[..., None], sums / counts.clamp_min(1.0)[..., None], 0.0)
    pooled = _norm(pooled) * pooled_mask[..., None]
    return pooled.to(emb.dtype), pooled_mask


def pool_index(index: TokenIndex, factor: int = 2, iters: int = 4,
               batch: Optional[int] = None) -> TokenIndex:
    """A pooled copy of a :class:`TokenIndex` (``factor``x fewer doc tokens)
    on the index's device, with the index's mesh (each rank pools its block).

    ``batch`` bounds the working set of one call (``[batch, L_d, L_p]``
    similarities and the fp32 copy of the batch); defaults to the whole
    index."""
    emb, mask = index.embeddings, index.mask
    N, L, dim = emb.shape
    batch = N if batch is None or batch >= N else batch
    pooled = torch.empty(N, L // factor, dim, dtype=emb.dtype, device=emb.device)
    pmask = torch.empty(N, L // factor, dtype=torch.bool, device=emb.device)
    with torch.inference_mode():
        for s in range(0, N, batch):
            pooled[s:s + batch], pmask[s:s + batch] = pool_doc_tokens(
                emb[s:s + batch], mask[s:s + batch], factor=factor, iters=iters)
    return TokenIndex(embeddings=pooled.to(torch.bfloat16).contiguous(),
                      mask=pmask.contiguous(), doc_ids=list(index.doc_ids), mesh=index.mesh)
