"""Kernel K2: fused multi-head self-attention, and its plain PyTorch version.

Replaces ``reranking_multimodal_retrievers_tpu/ops/attention_pallas.py::
fused_self_attention``. The CUDA kernels are ``csrc/attention.cu`` (bf16)
and ``csrc/attention_f32.cu`` (fp32, 3xTF32 on the tensor cores); their
headers say what bounds them on an H100 and how their designs answer that.

:func:`fused_self_attention` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (or raises: there is no fallback).
Both take the key-padding bias (BERT), the per-head bias (the T5
relative-position bias, bf16 or fp32) and the causal mask (OPT); the kernel
takes head_dim 64 and 80.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._grad import refuse_grad

NEG_INF = -1e9
KERNEL_HEAD_DIMS = (64, 80)

# the kernel's return codes from this value up: a tensor map it could not
# build (csrc/attention.cu::attention_bf16)
_ERR_TENSOR_MAP = 10000
# bytes of fp32 scores the plain version materialises per batch chunk
_PLAIN_CHUNK_BYTES = 512 << 20


def head_pack_feasible(num_heads: int, head_dim: int) -> bool:
    """The JAX package's gate for its fused attention kernel
    (``ops/platform.py::head_pack_feasible``): whether a group of heads
    whose packed width is a multiple of 128 lanes divides ``num_heads``
    (hd 64 -> 2 heads, hd 80 -> 8). T5 keeps this gate off the card, to
    fuse where the JAX package does; K2 packs no heads, so on the card it
    is not asked, and the kernel raises for a head_dim it does not take."""
    hpb = max(1, -(-128 // head_dim))
    while (hpb * head_dim) % 128 != 0 or num_heads % hpb != 0:
        hpb += 1
        if hpb > num_heads:
            return False
    return True


def causal_bias(L: int, device=None) -> torch.Tensor:
    """[L, L] fp32: -1e9 where key > query, else 0 (the TPU kernel's
    in-register causal mask)."""
    pos = torch.arange(L, device=device)
    return torch.where(pos[None, :] > pos[:, None], NEG_INF, 0.0)


def fused_self_attention_reference(q, k, v, mask_bias=None, head_bias=None, *,
                                   num_heads: int, sm_scale: float,
                                   causal: bool = False) -> torch.Tensor:
    """Plain version of K2, the counterpart of the JAX package's
    ``fused_self_attention_reference`` plus its kernel's causal mask: fp32
    scores ``QK^T * sm_scale + key bias + head bias + causal``, fp32 softmax,
    the probabilities cast to V's dtype, fp32 P.V accumulation, output in
    Q's dtype. Chunked over the batch so that no chunk's [b, heads, L, L]
    fp32 score block exceeds about 512 MB.

    q/k/v: [B, L, num_heads * head_dim]; mask_bias: optional [B, L] additive
    key bias (0 keep / -1e9 drop); head_bias: optional [num_heads, L, L]
    additive bias shared over the batch; causal: add -1e9 where key > query.
    """
    B, L, HD = q.shape
    hd = HD // num_heads
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(1, num_heads * L * L * 4))
    out = torch.empty_like(q)
    cb = causal_bias(L, q.device) if causal else None
    for b0 in range(0, B, chunk):
        b1 = min(B, b0 + chunk)
        qh, kh, vh = (x[b0:b1].reshape(b1 - b0, L, num_heads, hd) for x in (q, k, v))
        s = torch.einsum("bqnd,bknd->bnqk", qh.float(), kh.float()) * sm_scale
        if mask_bias is not None:
            s = s + mask_bias[b0:b1, None, None, :].float()
        if head_bias is not None:
            s = s + head_bias[None].float()
        if cb is not None:
            s = s + cb
        p = torch.softmax(s, dim=-1).to(vh.dtype)
        o = torch.einsum("bnqk,bknd->bqnd", p.float(), vh.float())
        out[b0:b1] = o.reshape(b1 - b0, L, HD).to(q.dtype)
    return out


def _check_head_bias(head_bias, num_heads: int, L: int, device) -> None:
    if head_bias.shape != (num_heads, L, L):
        raise ValueError(f"head_bias must be [heads, L, L] = {(num_heads, L, L)}, "
                         f"got {tuple(head_bias.shape)}")
    if head_bias.device != device:
        raise ValueError(f"head_bias on {head_bias.device}, q on {device}")
    if device.type == "cuda":
        if head_bias.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"the CUDA attention kernel takes a bf16 or fp32 head_bias, "
                            f"got {head_bias.dtype}")
        if not head_bias.is_contiguous():
            raise ValueError(f"head_bias must be contiguous: strides {head_bias.stride()}")


def fused_self_attention(q, k, v, mask_bias=None, head_bias=None, *,
                         num_heads: int, sm_scale: float,
                         causal: bool = False) -> torch.Tensor:
    """softmax(Q K^T * sm_scale + key bias [+ head bias] [+ causal]) V over
    heads packed in the last dim. q/k/v: [B, L, num_heads * head_dim];
    mask_bias: optional [B, L] additive key bias; head_bias: optional
    [num_heads, L, L] additive bias; causal: -1e9 where key > query.
    Returns [B, L, num_heads * head_dim] in q's dtype.

    On CUDA, fp32 q/k/v go to :func:`fused_self_attention_f32` with every
    option; otherwise q/k/v are bf16 with head_dim 64 or 80, unit stride in
    the last dim and row/batch strides that are multiples of 8 elements (the
    kernel reads them by TMA through tensor maps built per call); head_bias
    is a contiguous bf16 or fp32 tensor on the same device, passed to the
    kernel in its own dtype (a bf16 one at L % 8 == 0 also by TMA, any other
    read directly); any L is taken.

    There is no backward: with grad enabled, an input that requires grad
    raises ``NotImplementedError`` on the CPU and on CUDA alike.
    """
    refuse_grad("fused_self_attention", q, k, v, mask_bias, head_bias,
                hint="or train with use_pallas_attention=False, as the JAX package does")
    if q.device.type not in ("cpu", "cuda") or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must share one CPU or CUDA device: "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be equal [B, L, heads*hd]: {q.shape}, {k.shape}, {v.shape}")
    B, L, HD = q.shape
    if head_bias is not None:
        _check_head_bias(head_bias, num_heads, L, q.device)
    if q.device.type == "cpu":
        return fused_self_attention_reference(
            q, k, v, mask_bias, head_bias, num_heads=num_heads, sm_scale=sm_scale,
            causal=causal)
    if HD % num_heads or HD // num_heads not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"the CUDA attention kernel takes head_dim {KERNEL_HEAD_DIMS}; got "
            f"{HD} channels over {num_heads} heads")
    hd = HD // num_heads
    if q.dtype == k.dtype == v.dtype == torch.float32:
        return _launch_f32(q, k, v, mask_bias, head_bias, num_heads, sm_scale, causal)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the CUDA attention kernels take bf16 or fp32, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
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
    # the kernel launches on the current device: make it the tensors' own
    with torch.cuda.device(q.device):
        err = _lib().attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if head_bias is None else head_bias.data_ptr(),
            int(head_bias is not None and head_bias.dtype == torch.bfloat16), out.data_ptr(),
            B, L, num_heads, hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(sm_scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err >= _ERR_TENSOR_MAP:
        raise RuntimeError(f"fused_self_attention: no TMA tensor map for these tensors "
                           f"(cuTensorMapEncodeTiled: {err - _ERR_TENSOR_MAP}, where 10000 "
                           f"means the driver has no such entry point)")
    _build.check(err, "fused_self_attention")
    fused_self_attention.launches += 1
    return out


fused_self_attention.launches = 0


def fused_self_attention_f32(q, k, v, mask_bias=None, head_bias=None, *, num_heads: int,
                             sm_scale: float, causal: bool = False) -> torch.Tensor:
    """K2's fp32 path on CUDA (``csrc/attention_f32.cu``): softmax(Q K^T *
    sm_scale + key bias [+ head bias] [+ causal]) V for fp32 q/k/v
    ``[B, L, num_heads * head_dim]`` with head_dim 64 or 80, an optional
    [B, L] key bias, an optional contiguous bf16 or fp32 [num_heads, L, L]
    head bias and the causal mask; returns fp32 ``[B, L, num_heads *
    head_dim]``. The kernel copies q/k/v in 16-byte pieces, so each needs
    unit stride in the last dim, batch and row strides that are multiples of
    4 elements and 16-byte-aligned data (views of one fused projection at
    these widths are). Called by :func:`fused_self_attention` for fp32 CUDA
    tensors; it takes CUDA tensors only."""
    refuse_grad("fused_self_attention_f32", q, k, v, mask_bias, head_bias,
                hint="or train with use_pallas_attention=False, as the JAX package does")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must share one CUDA device: {q.device}, {k.device}, "
                         f"{v.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError(f"fp32 q/k/v expected, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be equal [B, L, heads*hd]: {q.shape}, {k.shape}, {v.shape}")
    B, L, HD = q.shape
    if HD % num_heads or HD // num_heads not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"the CUDA attention kernel takes head_dim {KERNEL_HEAD_DIMS}; got "
            f"{HD} channels over {num_heads} heads")
    if head_bias is not None:
        _check_head_bias(head_bias, num_heads, L, q.device)
    return _launch_f32(q, k, v, mask_bias, head_bias, num_heads, sm_scale, causal)


fused_self_attention_f32.launches = 0


def _launch_f32(q, k, v, mask_bias, head_bias, num_heads, sm_scale, causal):
    """The fp32 kernel's launch, on inputs checked by either caller but for
    the layout its 16-byte copies need."""
    for x in (q, k, v):
        if x.stride(2) != 1 or x.stride(1) % 4 or x.stride(0) % 4 or x.data_ptr() % 16:
            raise ValueError(f"unsupported q/k/v layout for 16-byte copies: strides "
                             f"{x.stride()}, data at {x.data_ptr() % 16} bytes past 16")
    B, L, HD = q.shape
    bias = None
    if mask_bias is not None:
        if mask_bias.shape != (B, L):
            raise ValueError(f"mask_bias must be [B, L], got {tuple(mask_bias.shape)}")
        bias = mask_bias.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty(B, L, HD, dtype=torch.float32, device=q.device)
    if B == 0 or L == 0:
        return out
    # the kernel launches on the current device: make it the tensors' own
    with torch.cuda.device(q.device):
        err = _lib_f32().attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if head_bias is None else head_bias.data_ptr(),
            int(head_bias is not None and head_bias.dtype == torch.bfloat16), out.data_ptr(),
            B, L, num_heads, HD // num_heads, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(sm_scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err < 0:
        raise ValueError(f"fused_self_attention_f32: shape refused by the kernel ({err})")
    _build.check(err, "fused_self_attention_f32")
    fused_self_attention_f32.launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    if lib.attention_bf16.argtypes is None:
        lib.attention_bf16.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
            + [ctypes.c_int64] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.attention_bf16.restype = ctypes.c_int
    return lib


def _lib_f32() -> ctypes.CDLL:
    lib = _build.load("attention_f32")
    if lib.attention_f32.argtypes is None:
        lib.attention_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
            + [ctypes.c_int64] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.attention_f32.restype = ctypes.c_int
    return lib
