"""LoRA adapters for linear layers (port of ``models/lora.py``).

The reference wraps its decoder LMs with ``peft.LoraConfig(r=8,
lora_alpha=32)`` on the q and v projections. :class:`LoRALinear` is an
``nn.Linear`` (same ``weight``/``bias``) with the low-rank update added:

    out = x W^T + b + (alpha / r) (x A^T) B^T,  A: [r, in], B: [out, r]

``lora_a`` and ``lora_b`` are stored as linear weights (``[r, in]`` and
``[out, r]``, the transposes of the JAX package's ``[in, r]`` and
``[r, out]``). ``lora_b`` starts at zero (``models/init.py``), so a fresh
adapter is a no-op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LoRALinear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, r: int, alpha: float = 32.0,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        if r <= 0:
            raise ValueError(f"LoRALinear needs a rank r > 0, got {r}")
        self.r = r
        self.alpha = alpha
        self.lora_a = nn.Parameter(torch.empty(r, in_features))
        self.lora_b = nn.Parameter(torch.empty(out_features, r))

    @property
    def scaling(self) -> float:
        return self.alpha / self.r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        lo = F.linear(F.linear(x, self.lora_a.to(x.dtype)), self.lora_b.to(x.dtype))
        return y + self.scaling * lo


def linear(in_features: int, out_features: int, *, r: int = 0, alpha: float = 32.0,
           bias: bool = True, dense=nn.Linear) -> nn.Linear:
    """A :class:`LoRALinear` when ``r > 0``, else ``dense(in, out, bias=bias)``."""
    if r > 0:
        return LoRALinear(in_features, out_features, r, alpha, bias=bias)
    return dense(in_features, out_features, bias=bias)


LORA_PARAM_PATTERNS = ("lora_a", "lora_b")
