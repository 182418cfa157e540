"""Building a model on its device with weights drawn from an explicit
``torch.Generator``.

A public model builds its submodules on the ``meta`` device (no memory, no
draws from the global RNG), then :func:`materialize_` allocates them on the
target device and draws every weight from the caller's generator.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator, std: float) -> None:
    """LayerNorms to (1, 0), every ``bias`` to 0, every other parameter to
    N(0, std) drawn from ``generator``."""
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if isinstance(m, nn.LayerNorm):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif name == "bias":
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)


def materialize_(module: nn.Module, device: DeviceLike, dtype: torch.dtype,
                 generator: Optional[torch.Generator], std: float) -> nn.Module:
    """Allocate ``module`` (built on ``meta``) on ``device``, draw its weights
    and cast it to ``dtype``. A no-op for ``device="meta"``, which a parent
    passes for a submodule it will materialise itself."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return module
    module.to_empty(device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    init_weights_(module, generator, std)
    return module.to(dtype)
