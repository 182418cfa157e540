"""The kernels' refusal of a gradient they cannot give.

K1, K2 and K3 have no backward, as their Pallas counterparts have none in
the JAX package (``jax.grad`` through ``pallas_call`` raises "Linearization
failed ... does not support reverse-mode autodiff"). A wrapper that filled a
fresh tensor and returned it without a ``grad_fn`` would cut the graph with
no error: a model trained through it would get no gradient into the layers
before the kernel. So each wrapper calls :func:`refuse_grad` first, on the
CPU (where it would take its differentiable plain version) and on CUDA alike.
"""

from __future__ import annotations

from typing import Optional

import torch


def refuse_grad(name: str, *tensors: Optional[torch.Tensor], hint: str) -> None:
    """Raise ``NotImplementedError`` if grad mode is on and any of
    ``tensors`` (``None`` entries are skipped) requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward, as the JAX package's Pallas kernel has none "
            f"(jax.grad through it raises 'Linearization failed'). Run it under "
            f"torch.no_grad() or torch.inference_mode(); {hint}")
