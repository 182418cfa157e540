"""Two-stage compressed search, the PLAID-role approximate path (port of
``engine/plaid.py``).

  stage 1: MaxSim of every doc of the COMPRESSED index (centroid + int8
           residual, decompressed a slab at a time) in bf16 products with
           fp32 results -> top-``n_candidates``
  stage 2: gather those candidates' tokens, decompress in fp32, exact fp32
           MaxSim -> final top-k

On CUDA, stage 1 decompresses a slab of docs in fp32, rounds it to bf16 and
scores it with kernel K1 (``ops/maxsim_cuda.py``) under the slab's mask;
whole-padding docs then get ``MASK_FILL_VALUE * L_q``
(``search.guard_padding_docs``). That is the JAX package's function: its
einsum replaces a masked token's score by -9999 where K1 adds -9999 to it,
which differs only for a doc with no valid token, and the guard gives such a
doc exactly JAX's total. It also never builds the JAX einsum's
``[B, chunk, L_d, L_q]`` fp32 block. On the CPU, and with
``stage1_bf16=False`` anywhere, stage 1 is the plain version: the einsum
of the (bf16-rounded) operands upcast to fp32, whose products are then
exact, with JAX's where-mask, max and sum, over ``chunk`` docs at a time.
Stage 2 is fp32 with TF32 off, split over queries so that its gathered
tokens and scores stay near ``STAGE2_BLOCK_BYTES``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import fp32_matmul
from ..ops.maxsim import MASK_FILL_VALUE
from ..ops.maxsim_cuda import maxsim_scores
from .codec import CompressedTokenIndex, decompress
from .search import SLAB_DOCS, guard_padding_docs

STAGE2_BLOCK_BYTES = 2 << 30  # decompressed candidates + their token scores per block


def _masked_maxsim(Q, D, mask, pattern: str):
    """JAX's stage-1/2 reduction: ``einsum(pattern)`` in fp32 to
    ``[..., C, L_d, L_q]``, masked token scores replaced by -9999, max over
    doc tokens, sum over query tokens."""
    s = torch.einsum(pattern, Q, D)
    s = torch.where(mask[..., None], s, MASK_FILL_VALUE)
    return s.amax(dim=-2).sum(dim=-1)


def stage1_plain(Q, codes, residuals, centroids, scales, mask, chunk: int,
                 bf16: bool = True):
    """Stage-1 scores ``[B, N]`` fp32 by the JAX package's einsum, ``chunk``
    docs at a time; with ``bf16`` both operands are rounded to bf16 first."""
    def rounded(x):
        return x.to(torch.bfloat16).float() if bf16 else x

    Qf = rounded(Q.float())
    N = codes.shape[0]
    out = torch.empty(Q.shape[0], N, dtype=torch.float32, device=Q.device)
    with fp32_matmul():
        for s in range(0, N, chunk):
            D = rounded(decompress(codes[s:s + chunk], residuals[s:s + chunk],
                                   centroids, scales))
            out[:, s:s + chunk] = _masked_maxsim(Qf, D, mask[s:s + chunk][None],
                                                 "bqd,cld->bclq")
    return out


def stage1_k1(Q, codes, residuals, centroids, scales, mask, slab: int = SLAB_DOCS):
    """Stage-1 scores ``[B, N]`` fp32 through K1: each slab of ``slab`` docs
    decompressed in fp32, rounded to bf16 and scored under its mask; then
    whole-padding docs get JAX's total."""
    Qb = Q.to(torch.bfloat16).contiguous()
    N = codes.shape[0]
    scores = torch.cat([
        maxsim_scores(Qb, decompress(codes[s:s + slab], residuals[s:s + slab], centroids,
                                     scales).to(torch.bfloat16),
                      mask[s:s + slab].contiguous())
        for s in range(0, N, slab)
    ], dim=1)
    return guard_padding_docs(scores, mask, Q.shape[1])


def stage1_scores(Q, codes, residuals, centroids, scales, mask, chunk: int,
                  stage1_bf16: bool = True):
    """Stage 1 on Q's device: through K1 on CUDA in bf16, else the plain
    version."""
    if stage1_bf16 and Q.device.type == "cuda":
        return stage1_k1(Q, codes, residuals, centroids, scales, mask)
    return stage1_plain(Q, codes, residuals, centroids, scales, mask, chunk, bf16=stage1_bf16)


def stage2_top_k(Q, stage1, codes, residuals, centroids, scales, mask,
                 n_candidates: int, k: int):
    """The top-``n_candidates`` of the stage-1 scores re-scored exactly in
    fp32 (TF32 off), a block of queries at a time; returns the top-k
    ``(values [B, k], doc indices [B, k])``."""
    _, cand_ids = torch.topk(stage1, n_candidates, dim=1)  # [B, n_cand]
    B, L_q, dim = Q.shape
    L_d = codes.shape[1]
    Qf = Q.float()
    stage2 = torch.empty(B, n_candidates, dtype=torch.float32, device=Q.device)
    per = max(1, STAGE2_BLOCK_BYTES // (n_candidates * L_d * (dim + L_q) * 4))
    with fp32_matmul():
        for b in range(0, B, per):
            c = cand_ids[b:b + per]
            D = decompress(codes[c], residuals[c], centroids, scales)
            stage2[b:b + per] = _masked_maxsim(Qf[b:b + per], D, mask[c], "bqd,bcld->bclq")
    vals, pos = torch.topk(stage2, k, dim=1)
    return vals, torch.gather(cand_ids, 1, pos)


def _two_stage_search(Q, codes, residuals, centroids, scales, mask,
                      n_candidates: int, k: int, chunk: int,
                      stage1_bf16: bool = True):
    arrays = (codes, residuals, centroids, scales, mask)
    # stage-1 scores only pick candidates; stage 2 re-scores them
    stage1 = stage1_scores(Q, *arrays, chunk, stage1_bf16)
    return stage2_top_k(Q, stage1, *arrays, n_candidates, k)


class CompressedSearcher:
    """Search a :class:`CompressedTokenIndex` (PLAID-role two-stage) on the
    index's device."""

    def __init__(self, index: CompressedTokenIndex, k: int = 100,
                 n_candidates: int = 1024, chunk: int = 256,
                 stage1_bf16: bool = True):
        self.index = index
        self.k = k
        N = index.codes.shape[0]
        self.n_candidates = min(n_candidates, N)
        c = min(chunk, N)
        while N % c:
            c -= 1
        self.chunk = c
        self.stage1_bf16 = stage1_bf16

    def search(self, Q) -> Tuple[np.ndarray, np.ndarray]:
        """``Q [B, L_q, dim]`` (numpy or tensor) -> (scores [B, k] fp32,
        doc indices [B, k]) as numpy."""
        idx = self.index
        with torch.inference_mode():
            vals, ids = _two_stage_search(
                torch.as_tensor(Q).to(idx.codes.device), idx.codes, idx.residuals,
                idx.centroids, idx.scales, idx.mask,
                n_candidates=self.n_candidates,
                k=min(self.k, self.n_candidates),
                chunk=self.chunk,
                stage1_bf16=self.stage1_bf16,
            )
        return vals.cpu().numpy(), ids.cpu().numpy()
