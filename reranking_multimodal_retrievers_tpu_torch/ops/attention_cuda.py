"""Kernel K2: fused multi-head self-attention, and its plain PyTorch version.

Replaces ``reranking_multimodal_retrievers_tpu/ops/attention_pallas.py::
fused_self_attention``. The CUDA kernel is ``csrc/attention.cu``; its header
says what bounds it on an H100 and how its design answers that.

:func:`fused_self_attention` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (or raises: there is no fallback).
The T5 per-head bias and the OPT causal mask are not ported yet and raise
``NotImplementedError`` on every device; the kernel takes head_dim 64.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e9
KERNEL_HEAD_DIM = 64

# bytes of fp32 scores the plain version materialises per batch chunk
_PLAIN_CHUNK_BYTES = 512 << 20


def fused_self_attention_reference(q, k, v, mask_bias=None, *, num_heads: int,
                                   sm_scale: float) -> torch.Tensor:
    """Plain version of K2, the counterpart of the JAX package's
    ``fused_self_attention_reference``: fp32 scores and softmax, the
    probabilities cast to V's dtype, fp32 P.V accumulation, output in Q's
    dtype. Chunked over the batch so that no chunk's [b, heads, L, L] fp32
    score block exceeds about 512 MB.

    q/k/v: [B, L, num_heads * head_dim]; mask_bias: optional [B, L] additive
    key bias (0 keep / -1e9 drop)."""
    B, L, HD = q.shape
    hd = HD // num_heads
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(1, num_heads * L * L * 4))
    out = torch.empty_like(q)
    for b0 in range(0, B, chunk):
        b1 = min(B, b0 + chunk)
        qh, kh, vh = (x[b0:b1].reshape(b1 - b0, L, num_heads, hd) for x in (q, k, v))
        s = torch.einsum("bqnd,bknd->bnqk", qh.float(), kh.float()) * sm_scale
        if mask_bias is not None:
            s = s + mask_bias[b0:b1, None, None, :].float()
        p = torch.softmax(s, dim=-1).to(vh.dtype)
        o = torch.einsum("bnqk,bknd->bqnd", p.float(), vh.float())
        out[b0:b1] = o.reshape(b1 - b0, L, HD).to(q.dtype)
    return out


def fused_self_attention(q, k, v, mask_bias=None, head_bias=None, *,
                         num_heads: int, sm_scale: float,
                         causal: bool = False) -> torch.Tensor:
    """softmax(Q K^T * sm_scale + key bias) V over heads packed in the last
    dim. q/k/v: [B, L, num_heads * head_dim]; mask_bias: optional [B, L]
    additive key bias. Returns [B, L, num_heads * head_dim] in q's dtype.

    On CUDA, q/k/v are bf16 with head_dim 64, unit stride in the last dim
    and row/batch strides that are multiples of 8 elements; any L is taken.
    """
    if head_bias is not None or causal:
        raise NotImplementedError(
            "head_bias (T5) and causal (OPT) attention are not ported yet")
    if q.device.type == "cpu":
        return fused_self_attention_reference(
            q, k, v, mask_bias, num_heads=num_heads, sm_scale=sm_scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must share one CUDA device: {q.device}, {k.device}, {v.device}")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be equal [B, L, heads*hd]: {q.shape}, {k.shape}, {v.shape}")
    B, L, HD = q.shape
    if HD != num_heads * KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA attention kernel takes head_dim {KERNEL_HEAD_DIM}; got "
            f"{HD} channels over {num_heads} heads")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the CUDA attention kernel takes bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    for x in (q, k, v):
        if x.stride(2) != 1 or x.stride(1) % 8 or x.stride(0) % 8 or x.data_ptr() % 16:
            raise ValueError(f"unsupported q/k/v layout: strides {x.stride()}")
    bias = None
    if mask_bias is not None:
        if mask_bias.shape != (B, L):
            raise ValueError(f"mask_bias must be [B, L], got {tuple(mask_bias.shape)}")
        bias = mask_bias.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty(B, L, HD, dtype=q.dtype, device=q.device)
    if B == 0 or L == 0:
        return out
    err = _lib().attention_hd64_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, L, num_heads, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fused_self_attention")
    fused_self_attention.launches += 1
    return out


fused_self_attention.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    if lib.attention_hd64_bf16.argtypes is None:
        lib.attention_hd64_bf16.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 6
            + [ctypes.c_float, ctypes.c_void_p])
        lib.attention_hd64_bf16.restype = ctypes.c_int
    return lib
