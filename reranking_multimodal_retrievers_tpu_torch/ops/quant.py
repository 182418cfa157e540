"""W8A8 int8 matmuls (port of ``ops/quant.py``).

The scheme is the JAX package's: weights are quantized symmetrically per
output channel and activations symmetrically per row (per token), both with
``scale = max(amax, 1e-8) / 127`` and round-half-to-even; the product
accumulates in int32 and is rescaled by ``row_scale x col_scale`` in fp32.
Weights are quantized on every call, so a bf16 checkpoint loads unchanged
into :class:`Int8Linear`.

The int32 product is ``torch._int_mm``: on the CPU an exact int32 product,
on CUDA cuBLASLt's int8 GEMM. That call wants more than 16 rows, ``k`` and
``n`` multiples of 8 and a column-major second operand, so a call with fewer
rows or other widths is zero-padded (exact) rather than routed to bf16.

The backward is the JAX ``int8_dot``'s straight-through one: the exact fp32
cotangents of ``x @ w``, so :class:`Int8Linear` trains (quantization-aware
training), as the JAX ``Int8Dense`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

QUANT_EPS = 1e-8


def symmetric_scale(amax: torch.Tensor, eps: float = QUANT_EPS) -> torch.Tensor:
    """``max(amax, eps) / 127`` in fp32, as a true division. (On CUDA,
    PyTorch turns a division by a Python number into a multiplication by its
    reciprocal, which can differ in the last bit; a 0-d tensor divisor, made
    on the device with no host copy, keeps the scales bitwise those of the
    JAX package.)"""
    amax = amax.float()
    return amax.clamp_min(eps) / amax.new_full((), 127.0)


def quantize_rows(x: torch.Tensor, eps: float = QUANT_EPS):
    """Symmetric per-row int8 over the last axis.

    Returns ``(q, scale)``: ``q`` int8 of ``x.shape``, ``scale`` fp32 of
    ``x.shape[:-1] + (1,)``, with ``q * scale ~ x``."""
    xf = x.float()
    scale = symmetric_scale(xf.abs().amax(dim=-1, keepdim=True), eps)
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_cols(w: torch.Tensor, eps: float = QUANT_EPS):
    """Symmetric per-output-channel int8 for an ``[in, out]`` matrix.
    Returns ``(q [in, out] int8, scale [1, out] fp32)``."""
    q, scale = quantize_rows(w.t(), eps)
    return q.t(), scale.t()


def _int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a [m, k] @ b_t.T`` in exact int32, for int8 ``a`` and a contiguous
    int8 ``b_t [n, k]``. On CUDA, rows are padded to 17 and ``k``, ``n`` to
    multiples of 8 with zeros, as ``_int_mm`` requires there."""
    m, k = a.shape
    n = b_t.shape[0]
    if a.device.type != "cuda":
        return torch._int_mm(a, b_t.t())
    pad_m, pad_k, pad_n = max(0, 17 - m), (-k) % 8, (-n) % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b_t = F.pad(b_t, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:m, :n] if (pad_m or pad_n) else out


class _Int8Dot(torch.autograd.Function):
    """W8A8 forward, straight-through backward (JAX ``quant.py:83-102``):
    ``dx = g @ w.T`` and ``dw = x.T @ g`` in fp32, cast to x's and w's
    dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        lead, k = x.shape[:-1], x.shape[-1]
        xq, xs = quantize_rows(x.reshape(-1, k))
        wq, ws = quantize_rows(w.t())  # per output channel: [out, in], [out, 1]
        y = _int_mm(xq, wq).float() * xs * ws.reshape(1, -1)
        return y.reshape(*lead, w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g32 = g.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g32 @ w.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x.float().reshape(-1, x.shape[-1]).t()
                  @ g32.reshape(-1, g.shape[-1])).to(w.dtype)
        return dx, dw


def int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` W8A8 for ``x [..., in]`` and ``w [in, out]`` (the JAX
    package's contract); fp32 ``[..., out]``. ``w`` may be the transpose of
    an ``nn.Linear`` weight, whose rows are then quantized as they lie. The
    gradient is straight-through: that of the fp32 ``x @ w``."""
    return _Int8Dot.apply(x, w)


class Int8Linear(nn.Linear):
    """Drop-in for ``nn.Linear`` whose matmul runs W8A8. Same ``weight`` /
    ``bias`` parameters, so an ``nn.Linear`` state dict loads unchanged, and
    trainable through the straight-through gradient of :func:`int8_dot`.
    The output dtype is that of ``x`` promoted with the weight's, as
    ``nn.Linear`` gives for matching dtypes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_dot(x, self.weight.t())
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))
