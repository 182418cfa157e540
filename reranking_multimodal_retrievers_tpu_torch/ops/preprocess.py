"""CLIP image preprocessing on the device: resize, center crop, normalise
(port of ``ops/preprocess.py``).

The host path (``data/image_io.py::CLIPImageProcessor``) decodes and
resizes each image on the CPU, rounding each resize pass to 8 bits as PIL
does. Here a batch of one resolution is uploaded once and preprocessed on
its device: the JAX package's function, whose resize is
``jax.image.resize`` (antialiased scale-and-translate). That resize is
reproduced as JAX computes it: for each resized axis an ``[in, out]`` weight
matrix (the Keys cubic, triangle or Lanczos kernel, stretched by the
downscale factor, each output column normalised to sum 1, columns whose
sample falls outside the image zeroed), applied as an fp32 product with
TF32 off. Only the columns of the center crop are built, so the two
products compute the cropped ``s x s`` pixels alone. An axis whose size
does not change is not resampled (``jax.image.resize`` skips it);
``nearest`` gathers, as JAX's ``_resize_nearest``. No rounding to 8 bits
between the passes: the two paths differ by design, by up to about two
8-bit levels.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, fp32_matmul, platform_device, resolve_device

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_EPS32 = float(np.finfo(np.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _lanczos(radius: float):
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        den = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
        out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


KERNELS = {"bicubic": _keys_cubic, "cubic": _keys_cubic, "tricubic": _keys_cubic,
           "linear": _triangle, "bilinear": _triangle, "trilinear": _triangle,
           "triangle": _triangle, "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}
METHODS = tuple(KERNELS) + ("nearest",)


def resize_weights(in_size: int, out_size: int, method: str,
                   device: DeviceLike = "cpu") -> torch.Tensor:
    """``[in_size, out_size]`` fp32 weights of ``jax.image.resize`` along
    one axis (``compute_weight_mat`` with ``antialias=True``, translation 0)."""
    kernel = KERNELS[method]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def nearest_indices(in_size: int, out_size: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """The source index of each output position (``_resize_nearest``): XLA
    folds its ``* in / out`` into one product by the fp32 ratio, which
    floors differently where the exact position is an integer."""
    pos = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * (in_size / out_size)
    return torch.floor(pos).long()


def scaled_size(height: int, width: int, image_size: int) -> Tuple[int, int]:
    """CLIP's shortest-side resize: ``max(s, round(side * s / min(H, W)))``
    each (Python's ``round``)."""
    scale = image_size / min(height, width)
    return max(image_size, round(height * scale)), max(image_size, round(width * scale))


class _Plan:
    """How one input resolution becomes the ``s x s`` crop: per axis either
    a slice of the input (size unchanged), a weight matrix restricted to
    the crop's columns, or nearest indices of the crop."""

    def __init__(self, height: int, width: int, image_size: int, method: str,
                 device: torch.device):
        if method not in METHODS:
            raise ValueError(f"unknown resize method {method!r}; one of {METHODS}")
        s = image_size
        nh, nw = scaled_size(height, width, s)
        self.axes = []
        for size, new in ((height, nh), (width, nw)):
            start = (new - s) // 2  # the center crop's first row / column
            if size == new:
                self.axes.append(("slice", start))
            elif method == "nearest":
                self.axes.append(("gather", nearest_indices(size, new, device)[start:start + s]))
            else:
                w = resize_weights(size, new, method, device)[:, start:start + s]
                self.axes.append(("matmul", w.contiguous()))
        self.size = s

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, C, H, W]`` fp32 -> ``[B, C, s, s]``."""
        s = self.size
        (kind_h, h), (kind_w, w) = self.axes
        with fp32_matmul():
            if kind_h == "slice":
                x = x[:, :, h:h + s]
            elif kind_h == "gather":
                x = x.index_select(2, h)
            else:
                x = torch.matmul(h.t(), x)
            if kind_w == "slice":
                x = x[:, :, :, w:w + s]
            elif kind_w == "gather":
                x = x.index_select(3, w)
            else:
                x = torch.matmul(x, w)
        return x


def _to_unit(images: torch.Tensor) -> torch.Tensor:
    """fp32 in [0, 1]: uint8 over 255; a float batch over 255 when its
    largest value (over the whole batch) exceeds 2, else as it is."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        return x / 255.0
    return torch.where(x.max() > 2.0, x / 255.0, x)


def _run(images: torch.Tensor, plan: _Plan) -> torch.Tensor:
    x = _to_unit(images).permute(0, 3, 1, 2)
    x = plan(x).clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)[:, None, None]
    return ((x - mean) / std).contiguous()


def _as_tensor(images: Union[torch.Tensor, np.ndarray],
               device: Optional[torch.device]) -> torch.Tensor:
    if isinstance(images, torch.Tensor):
        return images if device is None else images.to(device)
    arr = np.ascontiguousarray(images)
    return torch.from_numpy(arr).to(platform_device() if device is None else device)


def preprocess_images(images: Union[torch.Tensor, np.ndarray], image_size: int = 224,
                      method: str = "bicubic") -> torch.Tensor:
    """``[B, H, W, 3]`` uint8 or float (0-255 or 0-1) -> ``[B, 3, s, s]``
    normalised fp32 on the images' device: resize so the shortest side is
    ``image_size``, center crop, clip to [0, 1], normalise by CLIP's mean
    and std. A numpy batch goes to the platform device first (the card, or
    the CPU under ``RMRT_PLATFORM=cpu``)."""
    x = _as_tensor(images, None)
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"images {tuple(x.shape)}: want [B, H, W, 3]")
    return _run(x, _Plan(x.shape[1], x.shape[2], image_size, method, x.device))


class CLIPImageProcessorDevice:
    """The host ``CLIPImageProcessor``'s role on the device: a ``[B, H, W,
    3]`` batch (or a list of same-shape ``[H, W, 3]`` arrays) is uploaded
    once as it is (uint8 stays uint8) and preprocessed there; returns
    ``[B, 3, s, s]`` fp32 on ``device`` (the card by default, the CPU under
    ``RMRT_PLATFORM=cpu``). The weights of each input resolution are built
    once and kept."""

    def __init__(self, image_size: int = 224, method: str = "bicubic",
                 device: Optional[DeviceLike] = None):
        if method not in METHODS:
            raise ValueError(f"unknown resize method {method!r}; one of {METHODS}")
        self.image_size = image_size
        self.method = method
        self.device = platform_device() if device is None else resolve_device(device)
        self._plans: Dict[Tuple[int, int], _Plan] = {}

    def __call__(self, images: Union[torch.Tensor, np.ndarray, Sequence]) -> torch.Tensor:
        if isinstance(images, (list, tuple)):
            images = np.stack([np.asarray(im) for im in images])
        x = _as_tensor(images, self.device)
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"images {tuple(x.shape)}: want [B, H, W, 3]")
        key = (x.shape[1], x.shape[2])
        if key not in self._plans:
            self._plans[key] = _Plan(*key, self.image_size, self.method, self.device)
        return _run(x, self._plans[key])
