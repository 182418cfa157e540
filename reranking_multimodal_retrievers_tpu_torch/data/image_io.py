"""Image files and CLIP preprocessing without PIL (the card's machine has
none).

- :func:`write_png` writes an 8-bit RGB PNG with ``zlib`` and ``struct``
  (every scanline with filter 0).
- :func:`read_image` reads an 8-bit non-interlaced PNG itself (grey, RGB,
  palette, grey+alpha, RGBA, all five scanline filters) and returns an RGB
  ``uint8 [H, W, 3]`` array, alpha dropped as PIL's ``convert("RGB")``
  drops it. Any other format (a JPEG, as real M2KR images are, or a
  16-bit or interlaced PNG) is read by PIL, imported inside that branch:
  the choice is made on the file's header, before any reading.
- :class:`CLIPImageProcessor` turns images into CLIP pixel values
  ``[N, 3, s, s]`` fp32: shortest side resized to ``s`` (bicubic with
  antialiasing), centre crop, ``/255``, CLIP's mean and std. An image
  already ``s x s`` is only normalised, which is bitwise what the PIL path
  of the JAX package (``data/loaders.py::CLIPImageProcessorNP``) gives:
  PIL returns such an image unchanged from ``resize``. A real resize runs
  PIL's two passes (``torch.nn.functional.interpolate``, bicubic,
  antialiased, the kernel PIL uses) in fp32 where PIL runs them in fixed
  point: a pixel differs where a sum falls near a half, by at most two
  8-bit levels (about 1% of the pixels of a 64 -> 224 upscale of noise).
"""

from __future__ import annotations

import os
import struct
import tempfile
import zlib
from typing import List, Sequence

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write ``image`` (``uint8 [H, W, 3]``) as an 8-bit RGB PNG. The file
    is written beside ``path`` and renamed into place, so a reader in
    another process never sees half of it."""
    arr = np.ascontiguousarray(image)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 [H, W, 3], got {arr.dtype} {arr.shape}")
    h, w, _ = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)
    data = (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)), suffix=".png.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _png_header(data: bytes):
    """(width, height, bit depth, colour type, interlace) of a PNG."""
    kind, ihdr = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError("PNG without IHDR first")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr[:13])
    return w, h, depth, ctype, interlace


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum along the row, per byte of a pixel
            cur = np.zeros(stride, np.uint8)
            cur_w = line.astype(np.uint64)
            for c in range(bpp):
                cur[c::bpp] = (np.cumsum(cur_w[c::bpp]) & 0xFF).astype(np.uint8)
        elif ftype == 2:  # Up
            cur = (line.astype(np.uint16) + prev).astype(np.uint8)
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur_l = bytearray(stride)
            up = prev.tolist()
            for i, x in enumerate(line.tolist()):
                a = cur_l[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur_l[i] = (x + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur_l[i] = (x + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_l), np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype} at row {y}")
        out[y] = cur
        prev = cur
    return out


def _read_png(data: bytes) -> np.ndarray:
    w, h, depth, ctype, _ = _png_header(data)
    chans = _CHANNELS[ctype]
    idat, palette = [], None
    for kind, body in _chunks(data):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * chans, chans)
    px = rows.reshape(h, w, chans)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _is_own_png(data: bytes) -> bool:
    """An 8-bit, non-interlaced PNG of a colour type this module reads."""
    if not data.startswith(PNG_SIGNATURE):
        return False
    _, _, depth, ctype, interlace = _png_header(data)
    return depth == 8 and interlace == 0 and ctype in _CHANNELS


def read_image(path: str) -> np.ndarray:
    """The image at ``path`` as RGB ``uint8 [H, W, 3]``."""
    with open(path, "rb") as f:
        data = f.read()
    if _is_own_png(data):
        return _read_png(data)
    from PIL import Image  # other formats: JPEG (real M2KR images), 16-bit PNG, ...

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def _as_uint8(img) -> np.ndarray:
    arr = np.asarray(img)
    if np.issubdtype(arr.dtype, np.floating):
        # float images are [0, 1]-scaled, as in the JAX package
        arr = np.clip(arr * 255.0, 0, 255)
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    return arr[..., :3]


def resize_bicubic(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """``uint8 [H, W, 3]`` resized to ``[height, width, 3]`` as PIL's
    ``BICUBIC`` does it: bicubic (a = -0.5) with antialiasing when
    shrinking, the horizontal pass first, each pass rounded and clipped to
    8 bits (PIL's passes run in fixed point, these in fp32)."""
    x = torch.from_numpy(np.ascontiguousarray(arr)).permute(2, 0, 1)[None].float()
    for size in ((x.shape[2], width), (height, width)):
        if tuple(x.shape[2:]) != size:
            x = torch.nn.functional.interpolate(x, size=size, mode="bicubic",
                                                align_corners=False, antialias=True)
            x = x.round().clamp(0, 255)
    return x[0].permute(1, 2, 0).to(torch.uint8).numpy()


class CLIPImageProcessor:
    """CLIP preprocessing of a list of images (``uint8``/float arrays of
    ``[H, W, 3]``) into fp32 pixel values ``[N, 3, s, s]`` (numpy)."""

    MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

    def __init__(self, image_size: int = 224):
        self.image_size = image_size

    def __call__(self, images: Sequence) -> np.ndarray:
        out: List[np.ndarray] = []
        s = self.image_size
        for img in images:
            arr = _as_uint8(img)
            h, w = arr.shape[:2]
            scale = s / min(w, h)
            nw, nh = max(s, round(w * scale)), max(s, round(h * scale))
            if (nw, nh) != (w, h):
                arr = resize_bicubic(arr, nh, nw)
            left, top = (nw - s) // 2, (nh - s) // 2
            arr = arr[top:top + s, left:left + s]
            x = np.asarray(arr, np.float32) / 255.0
            x = (x - self.MEAN) / self.STD
            out.append(x.transpose(2, 0, 1))
        return np.stack(out)
