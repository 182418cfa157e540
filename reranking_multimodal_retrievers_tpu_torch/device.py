"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``torch.device(device)``, raising if it names CUDA and no GPU is
    visible. Nothing falls back to the CPU silently: the CPU is used only when
    the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def platform_device() -> torch.device:
    """The device of an entry point that takes none (the CLI, and the data
    nodes that run a model in ``--mode prepare_data``): ``cpu`` when
    ``RMRT_PLATFORM=cpu`` (the JAX CLI's own switch), else the CUDA card;
    raises when ``RMRT_PLATFORM`` names another platform, or no card is
    visible."""
    plat = os.environ.get("RMRT_PLATFORM")
    if plat == "cpu":
        return torch.device("cpu")
    if plat:
        raise ValueError(f"RMRT_PLATFORM={plat!r}: this package runs on the CUDA card, "
                         "or on the CPU with RMRT_PLATFORM=cpu")
    return resolve_device("cuda")


def is_on(tensor: torch.Tensor, device: torch.device) -> bool:
    """Whether ``tensor`` lies on ``device``; a CUDA device without an index
    (``"cuda"``) means the current card, as allocation on it does."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return tensor.device == device


@contextmanager
def fp32_matmul():
    """Run the enclosed fp32 products in full fp32 on CUDA: TF32 off in
    cuBLAS for the duration (restored after), where the JAX package asks
    for fp32 results."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
