"""Kernel K1: all-pairs MaxSim totals, and its plain PyTorch version.

Replaces ``reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py::
maxsim_scores_pallas``. The CUDA kernel is ``csrc/maxsim.cu``; its header says
what bounds it on an H100 and how its design answers that.

:func:`maxsim_scores` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors (or raises: there is no fallback).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._grad import refuse_grad
from .maxsim import MASK_FILL_VALUE

# bytes of fp32 token scores the plain version materialises per doc chunk
_PLAIN_CHUNK_BYTES = 256 << 20
_TRAIN_HINT = ("training scores go through ops/maxsim.py (colbert_score, "
               "in_batch_maxsim_scores), as in the JAX package")


def maxsim_scores_reference(Q: torch.Tensor, D: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K1 with its exact semantics, chunked over docs so
    that no chunk's token-score block exceeds about 256 MB.

    Args:
      Q: [B, L_q, dim] query tokens (zero rows for masked query tokens).
      D: [N, L_d, dim] doc tokens, same dtype as Q.
      mask: [N, L_d] bool doc-token validity, or None for an unpadded corpus.
      score_dtype: dtype of the token scores for the mask add and the max
        (fp32 or bf16); dot products accumulate and totals sum in fp32.

    Returns:
      [B, N] fp32 totals.
    """
    B, L_q, dim = Q.shape
    N, L_d, _ = D.shape
    Qf = Q.float().reshape(B * L_q, dim)
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(1, B * L_q * L_d * 4))
    out = torch.empty(B, N, dtype=torch.float32, device=Q.device)
    for c0 in range(0, N, chunk):
        c1 = min(N, c0 + chunk)
        s = (Qf @ D[c0:c1].float().reshape(-1, dim).T).view(B, L_q, c1 - c0, L_d)
        s = s.to(score_dtype)
        if mask is not None:
            bias = torch.where(mask[c0:c1], 0.0, MASK_FILL_VALUE).to(score_dtype)
            s = s + bias
        out[:, c0:c1] = s.amax(dim=-1).float().sum(dim=1)
    return out


def maxsim_scores(Q: torch.Tensor, D: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """All-pairs MaxSim totals ``[B, N]`` fp32 (see
    :func:`maxsim_scores_reference` for the arguments).

    On CUDA, Q and D must be contiguous bf16 with ``dim % 8 == 0`` and
    16-byte-aligned data (the kernel reads them by TMA); the mask is a
    contiguous bool [N, L_d]. Any B, L_q, N and L_d are taken, and dims up
    to 256 (the block keeps its query rows in shared memory).

    There is no backward: with grad enabled, a Q or D that requires grad
    raises ``NotImplementedError`` on the CPU and on CUDA alike."""
    refuse_grad("maxsim_scores", Q, D, hint=_TRAIN_HINT)
    if Q.device.type == "cpu" and D.device.type == "cpu":
        return maxsim_scores_reference(Q, D, mask, score_dtype)
    if Q.device.type != "cuda" or D.device != Q.device:
        raise ValueError(f"Q and D must share one CUDA device: {Q.device}, {D.device}")
    if Q.dim() != 3 or D.dim() != 3 or Q.shape[2] != D.shape[2]:
        raise ValueError(f"expected Q [B, L_q, dim] and D [N, L_d, dim]: {Q.shape}, {D.shape}")
    if Q.dtype != torch.bfloat16 or D.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA MaxSim kernel takes bf16 Q and D, got {Q.dtype}, {D.dtype}")
    if score_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"score_dtype must be float32 or bfloat16, got {score_dtype}")
    B, L_q, dim = Q.shape
    N, L_d, _ = D.shape
    if dim % 8 or L_q == 0 or L_d == 0:
        raise ValueError(f"need dim % 8 == 0 and non-empty token axes: {Q.shape}, {D.shape}")
    if not (Q.is_contiguous() and D.is_contiguous()):
        raise ValueError("Q and D must be contiguous")
    if Q.data_ptr() % 16 or D.data_ptr() % 16:
        raise ValueError("Q and D must start on a 16-byte boundary")
    if mask is not None:
        if mask.shape != (N, L_d) or mask.dtype != torch.bool or not mask.is_contiguous():
            raise ValueError(f"mask must be a contiguous bool [N, L_d], got {mask.dtype} {tuple(mask.shape)}")
        if mask.device != Q.device:
            raise ValueError(f"mask on {mask.device}, queries on {Q.device}")
    if B == 0 or N == 0:
        return torch.zeros(B, N, dtype=torch.float32, device=Q.device)
    lib = _lib()
    # the kernel launches on the current device: make it the tensors' own
    with torch.cuda.device(Q.device):
        splits = lib.maxsim_splits(B, L_q, dim)
        if splits < 1:
            raise ValueError(f"dim {dim} is too wide for the kernel's shared memory")
        # [S, B, N]: S > 1 only when a query has more rows than a block holds
        out = torch.empty(splits, B, N, dtype=torch.float32, device=Q.device)
        err = lib.maxsim_scores_bf16(
            Q.data_ptr(), D.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), B, L_q, N, L_d, dim, int(score_dtype == torch.bfloat16),
            torch.cuda.current_stream(Q.device).cuda_stream)
    _build.check(err, "maxsim_scores")
    maxsim_scores.launches += 1
    return out[0] if splits == 1 else out.sum(dim=0)


maxsim_scores.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("maxsim")
    if lib.maxsim_scores_bf16.argtypes is None:
        lib.maxsim_splits.argtypes = [ctypes.c_int] * 3
        lib.maxsim_splits.restype = ctypes.c_int
        lib.maxsim_scores_bf16.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.maxsim_scores_bf16.restype = ctypes.c_int
    return lib
