"""Image files and CLIP preprocessing without PIL (the card's machine has
none).

- :func:`write_png` writes an 8-bit RGB PNG with ``zlib`` and ``struct``
  (every scanline with filter 0).
- :func:`read_image` reads an 8-bit non-interlaced PNG itself (grey, RGB,
  palette, grey+alpha, RGBA, all five scanline filters) and returns an RGB
  ``uint8 [H, W, 3]`` array, alpha dropped as PIL's ``convert("RGB")``
  drops it. It also decodes a sequential Huffman JPEG itself (baseline or
  extended, 8-bit, 1 or 3 components, any integer sampling factors,
  restart markers), as the real M2KR images are: :func:`decode_jpeg`.
  Any other format (a progressive, arithmetic-coded or CMYK JPEG, a
  16-bit or interlaced PNG) is read by PIL, imported inside that branch:
  the choice is made on the file's header, before any decoding, and a
  file this module takes is never retried with PIL.
- :func:`decode_jpeg` gives the pixels PIL's ``Image.open(...).convert(
  "RGB")`` gives through libjpeg-turbo's defaults, bit for bit: the
  ``islow`` integer IDCT (``jidctint.c``) with its range-limit table,
  "fancy" triangle upsampling of h2v1, h1v2 and h2v2 chroma
  (``jdsample.c``; box replication of other ratios, and of h2 chroma
  planes of at most two columns) with the edge rows replicated, and the
  fixed-point YCbCr -> RGB tables of ``jdcolor.c``. Its Huffman decoding is
  pure Python, the rest numpy over all blocks at once.
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
from typing import Dict, List, Sequence, Tuple

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


# ------------------------------------------------------------------- JPEG
# natural (row-major) position of the k-th coefficient in zigzag order
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_SOF_SEQUENTIAL = (0xC0, 0xC1)  # baseline, extended sequential (Huffman)
_SOF_OTHER = (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)


def _segments(data: bytes):
    """(marker, payload start, payload end) of each marker segment up to the
    first SOS (whose payload is its header)."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: no marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        yield marker, pos + 4, pos + 2 + length
        pos += 2 + length


def _jpeg_frame(data: bytes):
    """(width, height, [(id, h, v, tq)]) of a JPEG this module decodes, else
    None: SOF0/SOF1 at 8 bits with 1 or 3 components whose sampling factors
    divide the largest."""
    if not data.startswith(b"\xff\xd8"):
        return None
    for marker, a, b in _segments(data):
        if marker in _SOF_OTHER:
            return None
        if marker in _SOF_SEQUENTIAL:
            precision, h, w, nc = struct.unpack(">BHHB", data[a:a + 6])
            comps = [tuple(data[a + 6 + 3 * i:a + 9 + 3 * i]) for i in range(nc)]
            comps = [(cid, hv >> 4, hv & 15, tq) for cid, hv, tq in comps]
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            if (precision != 8 or nc not in (1, 3) or h == 0
                    or any(hmax % c[1] or vmax % c[2] for c in comps)):
                return None
            return w, h, comps
        if marker == 0xDA:
            return None
    return None


def _huffman_lut(counts: bytes, symbols: bytes) -> List[int]:
    """A 16-bit lookahead table: entry = symbol << 5 | code length."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            lut[lo:hi] = [(symbols[k] << 5) | length] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return lut


def _entropy_segments(data: bytes, start: int):
    """The scan's entropy-coded bytes from ``start``, unstuffed and split at
    its restart markers, and the position of the marker that ends it."""
    segs, cur, i = [], bytearray(), start
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= len(data):
            cur += data[i:]
            segs.append(bytes(cur))
            return segs, len(data)
        cur += data[i:j]
        nxt = data[j + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            i = j + 2
        elif 0xD0 <= nxt <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            i = j + 2
        elif nxt == 0xFF:
            i = j + 1
        else:
            segs.append(bytes(cur))
            return segs, j


def _decode_units(seg: bytes, units, flats, preds) -> None:
    """Huffman-decode ``units`` [(component, dc lut, ac lut, coefficient
    offset)] in order from one restart interval ``seg`` into the flat
    coefficient lists (natural order), DC predictors in ``preds``."""
    zz = _ZIGZAG.tolist()
    acc, nbits, p, n = 0, 0, 0, len(seg)
    for c, dc, ac, base in units:
        flat = flats[c]
        while nbits < 16:
            acc = ((acc & ((1 << nbits) - 1)) << 8) | (seg[p] if p < n else 0)
            p += 1
            nbits += 8
        e = dc[(acc >> (nbits - 16)) & 0xFFFF]
        nbits -= e & 31
        s = e >> 5
        if s:
            while nbits < s:
                acc = ((acc & ((1 << nbits) - 1)) << 8) | (seg[p] if p < n else 0)
                p += 1
                nbits += 8
            v = (acc >> (nbits - s)) & ((1 << s) - 1)
            nbits -= s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            preds[c] += v
        flat[base] = preds[c]
        k = 1
        while k < 64:
            while nbits < 16:
                acc = ((acc & ((1 << nbits) - 1)) << 8) | (seg[p] if p < n else 0)
                p += 1
                nbits += 8
            e = ac[(acc >> (nbits - 16)) & 0xFFFF]
            nbits -= e & 31
            rs = e >> 5
            s = rs & 15
            if s:
                k += rs >> 4
                while nbits < s:
                    acc = ((acc & ((1 << nbits) - 1)) << 8) | (seg[p] if p < n else 0)
                    p += 1
                    nbits += 8
                v = (acc >> (nbits - s)) & ((1 << s) - 1)
                nbits -= s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                if k < 64:
                    flat[base + zz[k]] = v
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break


# jidctint.c's constants (CONST_BITS 13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172
# the IDCT's range limit: index (x & 1023) of a descaled output x
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(0, 128)]).astype(np.uint8)


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """One pass of jidctint.c's islow butterfly; (tmp10..13, tmp0..3)."""
    z1 = (x2 + x6) * _F0541
    tmp2 = z1 - x6 * _F1847
    tmp3 = z1 + x2 * _F0765
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return (t10 + t3, t11 + t2, t12 + t1, t13 + t0, t13 - t0, t12 - t1, t11 - t2, t10 - t3)


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """[N, 64] dequantized coefficients (natural order) -> [N, 8, 8] uint8,
    as ``jpeg_idct_islow`` computes them."""
    blk = coef.reshape(-1, 8, 8).astype(np.int64)
    # pass 1: columns, DESCALE by CONST_BITS - PASS1_BITS = 11
    ws = np.stack([(o + 1024) >> 11 for o in _idct_1d(*[blk[:, i, :] for i in range(8)])], 1)
    # pass 2: rows, DESCALE by CONST_BITS + PASS1_BITS + 3 = 18
    out = np.stack([(o + (1 << 17)) >> 18 for o in _idct_1d(*[ws[:, :, i] for i in range(8)])], 2)
    return _IDCT_LIMIT[out & 1023]


def _edge(a: np.ndarray, axis: int, before: bool) -> np.ndarray:
    idx = 0 if before else a.shape[axis] - 1
    return np.take(a, [idx], axis=axis)


def _fancy_h2(a: np.ndarray, bias_even: int, bias_odd: int, shift: int, three: np.ndarray):
    """Horizontal triangle: out[2j] = (3a[j] + a[j-1] + be) >> s,
    out[2j+1] = (3a[j] + a[j+1] + bo) >> s, the edges replicated; ``three``
    is 3a (or the column sums' 3x)."""
    left = np.concatenate([_edge(a, 1, True), a[:, :-1]], 1)
    right = np.concatenate([a[:, 1:], _edge(a, 1, False)], 1)
    out = np.empty((a.shape[0], 2 * a.shape[1]), np.int64)
    out[:, 0::2] = (three + left + bias_even) >> shift
    out[:, 1::2] = (three + right + bias_odd) >> shift
    return out


def _upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """A chroma plane (its real rows and columns) upsampled by (hr, vr) as
    libjpeg-turbo's ``jdsample.c`` does with fancy upsampling on."""
    a = plane.astype(np.int64)
    w = a.shape[1]
    if (hr, vr) == (2, 1) and w > 2:
        return _fancy_h2(a, 1, 2, 2, 3 * a)
    if (hr, vr) == (1, 2):
        above = np.concatenate([_edge(a, 0, True), a[:-1]], 0)
        below = np.concatenate([a[1:], _edge(a, 0, False)], 0)
        out = np.empty((2 * a.shape[0], w), np.int64)
        out[0::2] = (3 * a + above + 1) >> 2
        out[1::2] = (3 * a + below + 2) >> 2
        return out
    if (hr, vr) == (2, 2) and w > 2:
        above = np.concatenate([_edge(a, 0, True), a[:-1]], 0)
        below = np.concatenate([a[1:], _edge(a, 0, False)], 0)
        out = np.empty((2 * a.shape[0], 2 * w), np.int64)
        for v, other in ((0, above), (1, below)):
            cs = 3 * a + other
            out[v::2] = _fancy_h2(cs, 8, 7, 4, 3 * cs)
        return out
    return np.repeat(np.repeat(a, vr, 0), hr, 1)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ``ycc_rgb_convert``: SCALEBITS 16 fixed-point tables."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (91881 * x + half) >> 16          # FIX(1.40200)
    cb_b = (116130 * x + half) >> 16         # FIX(1.77200)
    cr_g = -46802 * x                        # -FIX(0.71414)
    cb_g = -22554 * x + half                 # -FIX(0.34414), + ONE_HALF
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A sequential Huffman JPEG (see :func:`_jpeg_frame`) as RGB ``uint8
    [H, W, 3]``, bitwise as PIL decodes it through libjpeg-turbo."""
    frame = _jpeg_frame(data)
    if frame is None:
        raise ValueError("not a sequential 8-bit JPEG of 1 or 3 components")
    width, height, comps = frame
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], List[int]] = {}
    flats = [[0] * (mcuy * c[2] * mcux * c[1] * 64) for c in comps]
    index = {c[0]: i for i, c in enumerate(comps)}
    restart, adobe, jfif = 0, None, False
    pos = 2
    while pos < len(data):
        marker = data[pos + 1]
        if data[pos] != 0xFF or marker == 0xD9:
            break
        if marker == 0xFF:
            pos += 1
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        a, b = pos + 4, pos + 2 + length
        if marker == 0xDB:  # quantization tables
            while a < b:
                pq, tq = data[a] >> 4, data[a] & 15
                vals = np.frombuffer(data[a + 1:a + 1 + 64 * (pq + 1)], ">u2" if pq else "u1")
                natural = np.zeros(64, np.int64)
                natural[_ZIGZAG] = vals
                qt[tq] = natural
                a += 1 + 64 * (pq + 1)
        elif marker == 0xC4:  # Huffman tables
            while a < b:
                tc, th = data[a] >> 4, data[a] & 15
                counts = data[a + 1:a + 17]
                total = sum(counts)
                huff[(tc, th)] = _huffman_lut(counts, data[a + 17:a + 17 + total])
                a += 17 + total
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", data[a:a + 2])
        elif marker == 0xE0 and data[a:a + 5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and data[a:a + 5] == b"Adobe" and b - a >= 12:
            adobe = data[a + 11]
        elif marker == 0xDA:  # a scan
            ns = data[a]
            scan = [(index[data[a + 1 + 2 * i]], data[a + 2 + 2 * i] >> 4,
                     data[a + 2 + 2 * i] & 15) for i in range(ns)]
            units = []
            if ns == 1:
                c, td, ta = scan[0]
                _, h, v, _ = comps[c]
                bx = -(-(-(-width * h // hmax)) // 8)
                by = -(-(-(-height * v // vmax)) // 8)
                stride = mcux * h
                for r in range(by):
                    for col in range(bx):
                        units.append([(c, huff[(0, td)], huff[(1, ta)], (r * stride + col) * 64)])
            else:
                for my in range(mcuy):
                    for mx in range(mcux):
                        mcu = []
                        for c, td, ta in scan:
                            _, h, v, _ = comps[c]
                            stride = mcux * h
                            for yy in range(v):
                                for xx in range(h):
                                    row, col = my * v + yy, mx * h + xx
                                    mcu.append((c, huff[(0, td)], huff[(1, ta)],
                                                (row * stride + col) * 64))
                        units.append(mcu)
            segs, pos = _entropy_segments(data, b)
            per = restart or len(units)
            for s, seg in enumerate(segs):
                group = units[s * per:(s + 1) * per]
                if not group:
                    break
                _decode_units(seg, [u for mcu in group for u in mcu], flats,
                              [0] * len(comps))
            continue
        pos = b
    planes = []
    for (cid, h, v, tq), flat in zip(comps, flats):
        nby, nbx = mcuy * v, mcux * h
        coef = np.asarray(flat, np.int64).reshape(-1, 64) * qt[tq]
        px = _idct_islow(coef).reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3)
        px = px.reshape(nby * 8, nbx * 8)
        cw, ch = -(-width * h // hmax), -(-height * v // vmax)
        planes.append(_upsample(px[:ch, :cw], hmax // h, vmax // v)[:height, :width])
    if len(comps) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    ids = tuple(c[0] for c in comps)
    rgb = (not jfif) and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def read_image(path: str) -> np.ndarray:
    """The image at ``path`` as RGB ``uint8 [H, W, 3]``."""
    with open(path, "rb") as f:
        data = f.read()
    if _is_own_png(data):
        return _read_png(data)
    if _jpeg_frame(data) is not None:
        return decode_jpeg(data)
    # other formats: progressive or CMYK JPEG, 16-bit PNG, ...
    from PIL import Image

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
