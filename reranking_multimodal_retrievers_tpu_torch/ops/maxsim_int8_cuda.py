"""Kernel K3: all-pairs MaxSim totals over int8 codes, and its plain PyTorch
version.

Replaces ``reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py::
maxsim_scores_pallas_int8``. The CUDA kernel is ``csrc/maxsim_int8.cu``; its
header says what bounds it on an H100 and how its design answers that.

The math, the same as the TPU kernel's and as ``engine/search.py::
_xla_chunk_scores_int8`` for every doc with a valid token:

    acc[b, i, n, j] = Qq[b, i] . Dq[n, j]                  (s8 x s8 -> s32)
    per_tok[b, i, n] = max_j (acc[b, i, n, j] + bias[n, j])   (int32)
    out[b, n] = (sum_i float(per_tok[b, i, n]) * q_scales[b, i]) * d_scales[n]

with ``bias = 0`` for a valid doc token and ``-(1 << 25)`` for a masked one,
added before the max. A whole-padding doc totals about
``-2^25 * sum(q_scales) * d_scales``.

:func:`maxsim_scores_int8` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (or raises: there is no fallback).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._grad import refuse_grad

MASK_BIAS_INT8 = -(1 << 25)
# bytes of the fp64 token-score block the plain version materialises per
# doc chunk
_PLAIN_CHUNK_BYTES = 256 << 20


def maxsim_scores_int8_reference(Qq: torch.Tensor, q_scales: torch.Tensor,
                                 Dq: torch.Tensor, d_scales: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K3, chunked over docs.

    The int8 dot products run as an fp64 matmul, which is exact here
    (products of at most 127^2, sums far below 2^53) on the CPU and on CUDA
    alike, and are then held in int32.

    Args:
      Qq: [B, L_q, dim] int8 query codes (zero rows for masked query tokens).
      q_scales: [B, L_q] fp32 per-query-token scales.
      Dq: [N, L_d, dim] int8 doc codes.
      d_scales: [N] fp32 per-doc scales.
      mask: [N, L_d] bool doc-token validity, or None for an unpadded corpus.

    Returns:
      [B, N] fp32 totals.
    """
    B, L_q, dim = Qq.shape
    N, L_d, _ = Dq.shape
    Qf = Qq.reshape(B * L_q, dim).double()
    qs = q_scales.float().reshape(B, L_q, 1)
    ds = d_scales.float()
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(1, B * L_q * L_d * 8))
    out = torch.empty(B, N, dtype=torch.float32, device=Qq.device)
    for c0 in range(0, N, chunk):
        c1 = min(N, c0 + chunk)
        acc = (Qf @ Dq[c0:c1].reshape(-1, dim).double().T).to(torch.int32)
        acc = acc.view(B, L_q, c1 - c0, L_d)
        if mask is not None:
            bias = torch.where(mask[c0:c1], 0, MASK_BIAS_INT8).to(torch.int32)
            acc = acc + bias
        per_tok = acc.amax(dim=-1).float()  # [B, L_q, chunk]
        # summed along a contiguous L_q axis, so that a doc's total does not
        # depend on the chunk it falls in
        terms = (per_tok * qs).transpose(1, 2).contiguous()
        out[:, c0:c1] = terms.sum(dim=-1) * ds[c0:c1]
    return out


def maxsim_scores_int8(Qq: torch.Tensor, q_scales: torch.Tensor, Dq: torch.Tensor,
                       d_scales: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-pairs int8 MaxSim totals ``[B, N]`` fp32 (see
    :func:`maxsim_scores_int8_reference` for the arguments).

    On CUDA, Qq and Dq must be contiguous int8 with ``dim % 32 == 0`` (the
    depth of one ``wgmma`` k-step) and 16-byte-aligned data (the kernel
    reads them by TMA); the scales contiguous fp32; the mask a contiguous
    bool [N, L_d]. Any B, L_q, N and L_d are taken, and dims up to 512 (the
    block keeps its query rows in shared memory).

    There is no backward: with grad enabled, an input that requires grad
    raises ``NotImplementedError`` on the CPU and on CUDA alike."""
    refuse_grad("maxsim_scores_int8", Qq, q_scales, Dq, d_scales,
                hint="int8 codes serve retrieval only")
    if Qq.device.type == "cpu" and Dq.device.type == "cpu":
        return maxsim_scores_int8_reference(Qq, q_scales, Dq, d_scales, mask)
    if Qq.device.type != "cuda" or Dq.device != Qq.device:
        raise ValueError(f"Qq and Dq must share one CUDA device: {Qq.device}, {Dq.device}")
    if Qq.dim() != 3 or Dq.dim() != 3 or Qq.shape[2] != Dq.shape[2]:
        raise ValueError(f"expected Qq [B, L_q, dim] and Dq [N, L_d, dim]: {Qq.shape}, {Dq.shape}")
    if Qq.dtype != torch.int8 or Dq.dtype != torch.int8:
        raise TypeError(f"the int8 MaxSim kernel takes int8 codes, got {Qq.dtype}, {Dq.dtype}")
    B, L_q, dim = Qq.shape
    N, L_d, _ = Dq.shape
    if dim % 32 or L_q == 0 or L_d == 0:
        raise ValueError(f"need dim % 32 == 0 and non-empty token axes: {Qq.shape}, {Dq.shape}")
    if not (Qq.is_contiguous() and Dq.is_contiguous()):
        raise ValueError("Qq and Dq must be contiguous")
    if Qq.data_ptr() % 16 or Dq.data_ptr() % 16:
        raise ValueError("Qq and Dq must start on a 16-byte boundary")
    for name, s, shape in (("q_scales", q_scales, (B, L_q)), ("d_scales", d_scales, (N,))):
        if (tuple(s.shape) != shape or s.dtype != torch.float32 or not s.is_contiguous()
                or s.device != Qq.device):
            raise ValueError(f"{name} must be a contiguous fp32 {shape} on {Qq.device}, "
                             f"got {s.dtype} {tuple(s.shape)} on {s.device}")
    if mask is not None:
        if mask.shape != (N, L_d) or mask.dtype != torch.bool or not mask.is_contiguous():
            raise ValueError(f"mask must be a contiguous bool [N, L_d], got {mask.dtype} {tuple(mask.shape)}")
        if mask.device != Qq.device:
            raise ValueError(f"mask on {mask.device}, queries on {Qq.device}")
    if B == 0 or N == 0:
        return torch.zeros(B, N, dtype=torch.float32, device=Qq.device)
    lib = _lib()
    # the kernel launches on the current device: make it the tensors' own
    with torch.cuda.device(Qq.device):
        splits = lib.maxsim_int8_splits(B, L_q, dim)
        if splits < 1:
            raise ValueError(f"dim {dim} is too wide for the kernel's shared memory")
        # [S, B, N]: S > 1 only when a query has more rows than a block holds
        out = torch.empty(splits, B, N, dtype=torch.float32, device=Qq.device)
        err = lib.maxsim_scores_int8(
            Qq.data_ptr(), q_scales.data_ptr(), Dq.data_ptr(), d_scales.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, L_q, N, L_d, dim, torch.cuda.current_stream(Qq.device).cuda_stream)
    _build.check(err, "maxsim_scores_int8")
    maxsim_scores_int8.launches += 1
    return out[0] if splits == 1 else out.sum(dim=0)


maxsim_scores_int8.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("maxsim_int8")
    if lib.maxsim_scores_int8.argtypes is None:
        lib.maxsim_int8_splits.argtypes = [ctypes.c_int] * 3
        lib.maxsim_int8_splits.restype = ctypes.c_int
        lib.maxsim_scores_int8.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.maxsim_scores_int8.restype = ctypes.c_int
    return lib
