"""Image files and CLIP preprocessing without PIL (the card's machine has
none).

- :func:`write_png` writes an 8-bit RGB PNG with ``zlib`` and ``struct``
  (every scanline with filter 0).
- :func:`read_image` reads every PNG itself (grey, RGB, palette,
  grey+alpha, RGBA at each bit depth the format allows, Adam7 or not, all
  five scanline filters) and returns an RGB ``uint8 [H, W, 3]`` array as
  PIL's ``convert("RGB")`` gives it: alpha and ``tRNS`` dropped, grey
  below 8 bits scaled, 16-bit grey clipped at 255 (PIL's mode ``I;16``),
  other 16-bit samples' high byte. It also decodes every 8-bit JPEG PIL
  reads itself (Huffman- or arithmetic-coded DCT, sequential or
  progressive, and lossless): :func:`decode_jpeg`, GIFs, BMPs and TIFFs through
  ``data/image_codecs.py`` and WebPs (lossy, lossless, with alpha, the
  first frame of an animation) through ``data/webp.py`` (a variant either
  does not take raises, naming it). Any other format (an arithmetic-coded
  lossless JPEG, a lossless one with subsampled or 2 components) is read by PIL, imported
  inside that branch, and raises naming the format where PIL is absent: the
  choice is made on the file's header, before any decoding, and a file this
  module takes is never retried with PIL. A 12-bit (or any other than
  8-bit) JPEG raises naming its precision, with or without PIL: PIL 12.1
  refuses it too ("cannot identify image file").
- :func:`decode_jpeg` takes sequential (baseline or extended) and
  progressive files, Huffman- or arithmetic-coded (``data/jpeg_coding.py``,
  with the DAC marker's conditioning), of 1, 3 or 4 components, any integer sampling
  factors and restart markers, and gives the pixels PIL's
  ``Image.open(...).convert("RGB")`` gives through libjpeg-turbo's
  defaults, bit for bit: ``jdphuff.c``'s four progressive decoders (EOB
  runs, refinement correction bits), block smoothing of the coefficients
  a progressive file leaves unrefined (``jdcoefct.c``, libjpeg-turbo's
  5 x 5 estimates), the ``islow`` integer IDCT (``jidctint.c``) with its
  range-limit table, "fancy" triangle upsampling of h2v1, h1v2 and h2v2
  chroma (``jdsample.c``; box replication of other ratios, and of h2
  chroma planes of at most two columns) with the edge rows replicated, the
  fixed-point YCbCr -> RGB and YCCK -> CMYK tables of ``jdcolor.c``, and
  PIL's inversion of Adobe CMYK and its CMYK -> RGB. Its Huffman decoding
  is pure Python, the rest numpy over all blocks at once. It also takes
  Huffman-coded lossless files (SOF3) of 1, 3 or 4 components without
  subsampling: predictors 1-7, the point transform and restart intervals
  of whole rows (``data/jpeg_coding.py``), then the same colour path.
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

import io
import os
import struct
import tempfile
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .image_codecs import codec_format, decode_codec
from .jpeg_coding import arith_interval, lossless_interval
from .webp import decode_webp, webp_variant

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


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


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, at: int = 0) -> np.ndarray:
    """Undo the per-scanline filters (None, Sub, Up, Average, Paeth) of
    ``h`` rows of ``stride`` bytes starting at ``raw[at]``."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        start = at + y * (stride + 1)
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


def _samples(rows: np.ndarray, w: int, chans: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> ``[h, w, chans]`` samples (``uint16``): 16-bit
    big-endian, 8-bit, or 1/2/4-bit packed most significant bit first."""
    h, n = rows.shape[0], w * chans
    if depth == 16:
        vals = np.frombuffer(rows.tobytes(), ">u2").reshape(h, -1)[:, :n]
    elif depth == 8:
        vals = rows[:, :n]
    else:
        bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth)
        vals = bits.astype(np.uint16) @ (np.uint16(1) << np.arange(depth - 1, -1, -1,
                                                                     dtype=np.uint16))
    return vals.astype(np.uint16).reshape(h, w, chans)


def _read_png(data: bytes) -> np.ndarray:
    w, h, depth, ctype, interlace = _png_header(data)
    chans = _CHANNELS[ctype]
    idat, palette = [], None
    for kind, body in _chunks(data):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    raw = zlib.decompress(b"".join(idat))
    bpp = max(1, chans * depth // 8)
    if not interlace:
        px = _samples(_unfilter(raw, h, -(-w * chans * depth // 8), bpp), w, chans, depth)
    else:  # Adam7: seven passes, each a sub-image of its own rows and filters
        px, at = np.zeros((h, w, chans), np.uint16), 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            stride = -(-pw * chans * depth // 8)
            px[y0::dy, x0::dx] = _samples(_unfilter(raw, ph, stride, bpp, at), pw, chans, depth)
            at += ph * (stride + 1)
    return _png_rgb(px, depth, ctype, palette)


def _png_rgb(px: np.ndarray, depth: int, ctype: int, palette: np.ndarray) -> np.ndarray:
    """Samples as PIL's ``convert("RGB")`` gives them: a palette looked up
    (entries past PLTE black), grey below 8 bits scaled to 0-255, 16-bit
    grey (PIL's mode ``I;16``) clipped at 255, other 16-bit samples' high
    byte; alpha and ``tRNS`` dropped."""
    if ctype == 3:
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[px[..., 0]]
    if ctype in (0, 4):
        g = px[..., 0]
        if depth == 16:
            g = np.minimum(g, 255) if ctype == 0 else g >> 8
        elif depth < 8:
            g = g * (255 // ((1 << depth) - 1))
        return np.repeat(g.astype(np.uint8)[..., None], 3, axis=2)
    rgb = px[..., :3] >> 8 if depth == 16 else px[..., :3]
    return np.ascontiguousarray(rgb.astype(np.uint8))


def _is_own_png(data: bytes) -> bool:
    """A PNG of a colour type and bit depth the format allows."""
    if not data.startswith(PNG_SIGNATURE):
        return False
    _, _, depth, ctype, interlace = _png_header(data)
    return depth in _PNG_DEPTHS.get(ctype, ()) and interlace in (0, 1)


# ------------------------------------------------------------------- JPEG
# natural (row-major) position of the k-th coefficient in zigzag order
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_SOF_SEQUENTIAL = (0xC0, 0xC1)  # baseline, extended sequential (Huffman)
_SOF_PROGRESSIVE = 0xC2
_SOF_LOSSLESS = 0xC3
_SOF_ARITH, _SOF_ARITH_PROGRESSIVE = 0xC9, 0xCA
_SOF_NAMES = {0xC3: "a lossless JPEG", 0xC5: "a differential JPEG", 0xC6: "a differential JPEG",
              0xC7: "a differential lossless JPEG", 0xC9: "an arithmetic-coded JPEG",
              0xCA: "an arithmetic-coded progressive JPEG",
              0xCB: "an arithmetic-coded lossless JPEG", 0xCD: "a differential JPEG",
              0xCE: "a differential JPEG", 0xCF: "a differential JPEG"}


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


def _sof(data: bytes):
    """(marker, precision, width, height, [(id, h, v, tq)]) of a JPEG's
    frame header, or None."""
    if not data.startswith(b"\xff\xd8"):
        return None
    for marker, a, b in _segments(data):
        if marker in _SOF_SEQUENTIAL or marker == _SOF_PROGRESSIVE or marker in _SOF_NAMES:
            precision, h, w, nc = struct.unpack(">BHHB", data[a:a + 6])
            comps = [tuple(data[a + 6 + 3 * i:a + 9 + 3 * i]) for i in range(nc)]
            return marker, precision, w, h, [(cid, hv >> 4, hv & 15, tq) for cid, hv, tq in comps]
        if marker == 0xDA:
            return None
    return None


def _jpeg_frame(data: bytes):
    """(width, height, [(id, h, v, tq)], progressive, coding) of a JPEG this
    module decodes, else None: a sequential (SOF0/SOF1/SOF9) or progressive
    (SOF2/SOF10) frame, ``coding`` "huffman" or "arithmetic", at 8 bits
    with 1, 3 or 4 components whose sampling factors divide the largest; or
    a Huffman-coded lossless frame (SOF3, ``coding`` "lossless") at 8 bits
    with 1, 3 or 4 components, none subsampled."""
    sof = _sof(data)
    if sof is None:
        return None
    marker, precision, w, h, comps = sof
    coding = {0xC0: "huffman", 0xC1: "huffman", 0xC2: "huffman", _SOF_ARITH: "arithmetic",
              _SOF_ARITH_PROGRESSIVE: "arithmetic", _SOF_LOSSLESS: "lossless"}.get(marker)
    if coding is None:
        return None
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    if (precision != 8 or len(comps) not in (1, 3, 4) or h == 0
            or any(hmax % c[1] or vmax % c[2] for c in comps)):
        return None
    if coding == "lossless" and (hmax, vmax) != (1, 1):
        return None
    return w, h, comps, marker in (_SOF_PROGRESSIVE, _SOF_ARITH_PROGRESSIVE), coding


def image_format(data: bytes) -> str:
    """What a file's header says it is, in words (for errors)."""
    sof = _sof(data)
    if sof is not None:
        marker, precision, _, _, comps = sof
        if marker in _SOF_NAMES:
            return _SOF_NAMES[marker]
        if precision != 8:
            return f"a {precision}-bit JPEG"
        return (f"a JPEG of {len(comps)} components with sampling factors "
                f"{[(c[1], c[2]) for c in comps]}")
    if data.startswith(b"\xff\xd8"):
        return "a JPEG without a frame header"
    if data.startswith(PNG_SIGNATURE):
        return "a PNG of bit depth {2} and colour type {3}".format(*_png_header(data))
    codec = codec_format(data)
    if codec is not None:
        return codec
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        try:
            return webp_variant(data)
        except ValueError:
            return "a WebP"
    return f"an unknown format (header {data[:8].hex()})"


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


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, clip: bool = True) -> np.ndarray:
    """jdcolor.c's ``ycc_rgb_convert``: SCALEBITS 16 fixed-point tables
    (unclipped for YCCK, whose conversion subtracts from 255 first)."""
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
    out = np.stack([r, g, b], -1)
    return np.clip(out, 0, 255).astype(np.uint8) if clip else out


class _Bits:
    """A bit reader over one restart interval's unstuffed bytes (zeros past
    its end, as libjpeg pads a truncated segment)."""

    __slots__ = ("seg", "p", "n", "acc", "nbits")

    def __init__(self, seg: bytes):
        self.seg, self.p, self.n, self.acc, self.nbits = seg, 0, len(seg), 0, 0

    def _fill(self) -> None:
        acc, nbits, p = self.acc & ((1 << self.nbits) - 1), self.nbits, self.p
        while nbits < 16:
            acc = (acc << 8) | (self.seg[p] if p < self.n else 0)
            p += 1
            nbits += 8
        self.acc, self.nbits, self.p = acc, nbits, p

    def huff(self, lut: List[int]) -> int:
        if self.nbits < 16:
            self._fill()
        e = lut[(self.acc >> (self.nbits - 16)) & 0xFFFF]
        self.nbits -= e & 31
        return e >> 5

    def bits(self, s: int) -> int:
        if self.nbits < s:
            self._fill()
        self.nbits -= s
        return (self.acc >> self.nbits) & ((1 << s) - 1)

    def extend(self, s: int) -> int:
        v = self.bits(s)
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _progressive_interval(seg: bytes, units, flats, ss: int, se: int, ah: int, al: int) -> None:
    """One restart interval of a progressive scan (``jdphuff.c``'s four
    decoders): ``units`` [(component, Huffman table, coefficient offset)]
    in order. DC predictors and the EOB run start at zero."""
    bits, zz = _Bits(seg), _ZIGZAG.tolist()
    if ss == 0:
        if ah == 0:  # DC first
            preds: Dict[int, int] = {}
            for c, lut, base in units:
                s = bits.huff(lut)
                preds[c] = preds.get(c, 0) + (bits.extend(s) if s else 0)
                flats[c][base] = preds[c] << al
        else:  # DC refine: one bit a block
            p1 = 1 << al
            for c, _, base in units:
                if bits.bits(1):
                    flats[c][base] |= p1
        return
    eobrun = 0
    if ah == 0:  # AC first
        for c, lut, base in units:
            if eobrun:
                eobrun -= 1
                continue
            flat, k = flats[c], ss
            while k <= se:
                rs = bits.huff(lut)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    flat[base + zz[k]] = bits.extend(s) << al
                elif r == 15:
                    k += 15
                else:
                    eobrun = (1 << r) + (bits.bits(r) if r else 0) - 1
                    break
                k += 1
        return
    p1, m1 = 1 << al, -1 << al  # AC refine
    for c, lut, base in units:
        flat, k = flats[c], ss
        if not eobrun:
            while k <= se:
                rs = bits.huff(lut)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if bits.bits(1) else m1
                elif r != 15:
                    eobrun = (1 << r) + (bits.bits(r) if r else 0)
                    break
                # pass r zero coefficients, correcting the nonzero ones on the way
                while k <= se:
                    at = base + zz[k]
                    if flat[at]:
                        if bits.bits(1) and not flat[at] & p1:
                            flat[at] += p1 if flat[at] >= 0 else m1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s and k <= se:
                    flat[base + zz[k]] = s
                k += 1
        if eobrun:  # the rest of the band: correction bits only
            while k <= se:
                at = base + zz[k]
                if flat[at] and bits.bits(1) and not flat[at] & p1:
                    flat[at] += p1 if flat[at] >= 0 else m1
                k += 1
            eobrun -= 1


def _smooth_columns(nbx: int) -> np.ndarray:
    """The block columns read as the 5 DC columns around each of ``nbx``
    block columns: the neighbours, the edge column repeated past either
    side."""
    return np.clip(np.arange(nbx)[:, None] + np.arange(-2, 3)[None, :], 0, nbx - 1)


def _smooth_rows(hib: int, v: int, imcu_rows: int) -> np.ndarray:
    """The block rows read as the 5 DC rows around each of ``hib`` block
    rows, as ``decompress_smooth_data`` indexes them per iMCU row (in the
    last iMCU row's count; it may read the padding rows of an iMCU row)."""
    out = []
    for r in range(hib):
        m, br = divmod(r, v)
        rows = v if m < imcu_rows - 1 else (hib % v or v)
        at, last = m * rows + br, rows * imcu_rows
        prev = r - 1 if at > 0 else r
        nxt = r + 1 if at < last - 1 else r
        out.append([r - 2 if at > 1 else prev, prev, r, nxt, r + 2 if at < last - 2 else nxt])
    return np.array(out, np.int64)


# positions (natural order) of the coefficients block smoothing estimates
_Q01, _Q10, _Q20, _Q11, _Q02, _Q03, _Q12, _Q21, _Q30 = 1, 8, 16, 9, 2, 3, 10, 17, 24
# weights of the 5 x 5 DCs (row-major, DC01..DC25) for each estimate:
# (coefficient bit index, position, weights without / with DC interpolation)
_SMOOTH = [
    (1, _Q01, {11: -7, 12: 50, 14: -50, 15: 7},
     {1: -1, 2: -1, 4: 1, 5: 1, 6: -3, 7: 13, 9: -13, 10: 3, 11: -3, 12: 38, 14: -38, 15: 3,
      16: -3, 17: 13, 19: -13, 20: 3, 21: -1, 22: -1, 24: 1, 25: 1}),
    (2, _Q10, {3: -7, 8: 50, 18: -50, 23: 7},
     {1: -1, 2: -3, 3: -3, 4: -3, 5: -1, 6: -1, 7: 13, 8: 38, 9: 13, 10: -1, 16: 1, 17: -13,
      18: -38, 19: -13, 20: 1, 21: 1, 22: 3, 23: 3, 24: 3, 25: 1}),
    (3, _Q20, {3: -1, 8: 13, 13: -24, 18: 13, 23: -1},
     {3: 1, 7: 2, 8: 7, 9: 2, 12: -5, 13: -14, 14: -5, 17: 2, 18: 7, 19: 2, 23: 1}),
    (4, _Q11, {10: 1, 16: 1, 17: -10, 19: 10, 2: -1, 20: -1, 22: 1, 24: -1, 4: 1, 6: -1, 7: 10,
               9: -10},
     {1: -1, 5: 1, 7: 9, 9: -9, 17: -9, 19: 9, 21: 1, 25: -1}),
    (5, _Q02, {11: -1, 12: 13, 13: -24, 14: 13, 15: -1},
     {7: 2, 8: -5, 9: 2, 11: 1, 12: 7, 13: -14, 14: 7, 15: 1, 17: 2, 18: -5, 19: 2}),
    (6, _Q03, None, {7: 1, 9: -1, 12: 2, 14: -2, 17: 1, 19: -1}),
    (7, _Q12, None, {7: 1, 8: -3, 9: 1, 17: -1, 18: 3, 19: -1}),
    (8, _Q21, None, {7: 1, 9: -1, 12: -3, 14: 3, 17: 1, 19: -1}),
    (9, _Q30, None, {7: 1, 8: 2, 9: 1, 17: -1, 18: -2, 19: -1}),
]
_SMOOTH_DC = {1: -2, 2: -6, 3: -8, 4: -6, 5: -2, 6: -6, 7: 6, 8: 42, 9: 6, 10: -6, 11: -8,
              12: 42, 13: 152, 14: 42, 15: -8, 16: -6, 17: 6, 18: 42, 19: 6, 20: -6, 21: -2,
              22: -6, 23: -8, 24: -6, 25: -2}


def _smoothing_ok(coef_bits, qts) -> bool:
    """``jdcoefct.c``'s ``smoothing_ok``: every DC partly known, no zero
    quantizer among the ten it divides by, and some low coefficient not
    fully known (never sent: -1, or its last point transform above 0)."""
    useful = False
    for bits, qt in zip(coef_bits, qts):
        if bits[0] < 0 or not all(qt[p] for p in (0, _Q01, _Q10, _Q20, _Q11, _Q02, _Q03, _Q12,
                                                   _Q21, _Q30)):
            return False
        useful = useful or any(bits[k] != 0 for k in range(1, 10))
    return useful


def _smooth(coef: np.ndarray, bits: List[int], qt: np.ndarray, hib: int, wib: int, v: int,
            imcu_rows: int) -> None:
    """Block smoothing of one component's quantized coefficients ``[rows,
    cols, 64]`` in place, as libjpeg-turbo (2.1 and later) does it: each
    zero low coefficient not known to be exact gets an estimate from the
    5 x 5 DCs around its block; with no AC data at all, the DC too."""
    rows, cols = _smooth_rows(hib, v, imcu_rows), _smooth_columns(wib)
    dc = coef[:, :, 0].astype(np.int64)
    grid = dc[rows[:, :, None, None], cols[None, None, :, :]]  # [hib, 5, wib, 5]
    dcs = {1 + 5 * i + j: grid[:, i, :, j] for i in range(5) for j in range(5)}
    change_dc = all(bits[k] == -1 for k in range(1, 10))
    q00 = int(qt[0])
    out = coef[:hib, :wib]
    ws = out.astype(np.int64)

    def estimate(weights, q):
        num = q00 * sum(w * dcs[i] for i, w in weights.items())
        pred = ((q << 7) + np.abs(num)) // (q << 8)
        return pred, num < 0

    for bit, pos, plain, interp in _SMOOTH:
        al = bits[bit]
        weights = interp if change_dc else plain
        if al == 0 or weights is None:
            continue
        pred, neg = estimate(weights, int(qt[pos]))
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(neg, -pred, pred)
        ws[..., pos] = np.where(out[..., pos] == 0, pred, ws[..., pos])
    if change_dc:
        pred, neg = estimate(_SMOOTH_DC, q00)
        ws[..., 0] = np.where(neg, -pred, pred)
    out[...] = ws


def _cmyk_to_rgb(c, m, y, k, ycck: bool) -> np.ndarray:
    """Four decoded planes as PIL gives them: libjpeg's YCCK -> CMYK
    (``jdcolor.c``) for an Adobe transform of 2, PIL's inversion of Adobe
    CMYK (mode ``CMYK;I``), then its ``convert("RGB")`` (``Convert.c``
    ``cmyk2rgb``: ``255 - K`` less ``255 - K`` times the ink, over 255)."""
    planes = [p.astype(np.int64) for p in (c, m, y, k)]
    if ycck:
        rgb = _ycc_to_rgb(*planes[:3], clip=False)
        planes[:3] = [np.clip(255 - rgb[..., i], 0, 255) for i in range(3)]
    nk = planes[3]  # 255 - PIL's K, whose planes are the decoded ones inverted
    out = []
    for p in planes[:3]:
        t = (255 - p) * nk + 128
        out.append(np.clip(nk - (((t >> 8) + t) >> 8), 0, 255))
    return np.stack(out, -1).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """An 8-bit JPEG (see :func:`_jpeg_frame`): Huffman- or arithmetic-coded
    DCT, sequential or progressive, or Huffman-coded lossless, of 1, 3 or 4
    components, as RGB ``uint8 [H, W, 3]``, bitwise as PIL decodes it
    through libjpeg-turbo (block smoothing of a progressive file whose scans
    leave low coefficients unrefined included)."""
    frame = _jpeg_frame(data)
    if frame is None:
        raise ValueError(f"not an 8-bit JPEG of 1, 3 or 4 components this module decodes: "
                         f"{image_format(data)}")
    width, height, comps, progressive, coding = frame
    arithmetic = coding == "arithmetic"
    dc_lu: Dict[int, Tuple[int, int]] = {}  # the DAC marker's conditioning
    ac_k: Dict[int, int] = {}
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    qt: Dict[int, np.ndarray] = {}
    latched: Dict[int, np.ndarray] = {}  # each component's table, fixed at its first scan
    huff: Dict[Tuple[int, int], List[int]] = {}
    flats = [[0] * (mcuy * c[2] * mcux * c[1] * 64) for c in comps]
    if coding == "lossless":
        flats = [np.zeros((height, width), np.int64) for _ in comps]
    coef_bits = [[-1] * 64 for _ in comps]
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
        elif marker == 0xCC:  # arithmetic conditioning
            for i in range(a, b - 1, 2):
                tc, tb, cs = data[i] >> 4, data[i] & 15, data[i + 1]
                if tc == 0:
                    dc_lu[tb] = (cs & 15, cs >> 4)
                else:
                    ac_k[tb] = cs
        elif marker == 0xE0 and data[a:a + 5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and data[a:a + 5] == b"Adobe" and b - a >= 12:
            adobe = data[a + 11]
        elif marker == 0xDA:  # a scan
            ns = data[a]
            scan = [(index[data[a + 1 + 2 * i]], data[a + 2 + 2 * i] >> 4,
                     data[a + 2 + 2 * i] & 15) for i in range(ns)]
            ss, se, ahl = data[a + 1 + 2 * ns:a + 4 + 2 * ns]
            ah, al = ahl >> 4, ahl & 15
            if coding == "lossless":
                if _jpeg_colour(comps, adobe, jfif) in ("ycbcr", "ycck"):
                    raise NotImplementedError(
                        "a lossless JPEG in YCbCr or YCCK, which libjpeg-turbo (and so PIL "
                        "12.1) does not convert to RGB either")
                pos = _lossless_scan(data, b, scan, huff, flats, width, height, restart, ss, al)
                continue
            if not progressive:
                ss, se, ah, al = 0, 63, 0, 0
            for c, _, _ in scan:
                latched.setdefault(c, qt[comps[c][3]].copy())
                for k in range(ss, se + 1):
                    coef_bits[c][k] = al

            def unit(c, td, ta, offset):
                if arithmetic:
                    return (c, td, ta, offset)
                if not progressive:
                    return (c, huff[(0, td)], huff[(1, ta)], offset)
                return (c, huff.get((0, td) if ss == 0 else (1, ta)), offset)

            units = []
            if ns == 1:  # non-interleaved: the component's own blocks, no MCU padding
                c, td, ta = scan[0]
                _, h, v, _ = comps[c]
                bx = -(-(-(-width * h // hmax)) // 8)
                by = -(-(-(-height * v // vmax)) // 8)
                stride = mcux * h
                for r in range(by):
                    for col in range(bx):
                        units.append([unit(c, td, ta, (r * stride + col) * 64)])
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
                                    mcu.append(unit(c, td, ta, (row * stride + col) * 64))
                        units.append(mcu)
            segs, pos = _entropy_segments(data, b)
            per = restart or len(units)
            for s, seg in enumerate(segs):
                group = [u for mcu in units[s * per:(s + 1) * per] for u in mcu]
                if not group:
                    break
                if arithmetic:
                    arith_interval(seg, group, flats, _ZIGZAG.tolist(), ss=ss, se=se, ah=ah,
                                   al=al, progressive=progressive, dc_lu=dc_lu, ac_k=ac_k)
                elif progressive:
                    _progressive_interval(seg, group, flats, ss, se, ah, al)
                else:
                    _decode_units(seg, group, flats, [0] * len(comps))
            continue
        pos = b
    if coding == "lossless":
        return _jpeg_rgb([f.astype(np.uint8) for f in flats], comps, adobe, jfif)
    tables = [latched.get(i, qt.get(c[3])) for i, c in enumerate(comps)]
    smooth = progressive and _smoothing_ok(coef_bits, tables)
    planes = []
    for i, ((cid, h, v, tq), flat) in enumerate(zip(comps, flats)):
        nby, nbx = mcuy * v, mcux * h
        cw, ch = -(-width * h // hmax), -(-height * v // vmax)
        coef = np.asarray(flat, np.int64).reshape(nby, nbx, 64)
        if smooth:
            _smooth(coef, coef_bits[i], tables[i], -(-ch // 8), -(-cw // 8), v, mcuy)
        px = _idct_islow(coef.reshape(-1, 64) * tables[i]).reshape(nby, nbx, 8, 8)
        px = px.transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
        planes.append(_upsample(px[:ch, :cw], hmax // h, vmax // v)[:height, :width])
    return _jpeg_rgb(planes, comps, adobe, jfif)


def _jpeg_colour(comps, adobe, jfif) -> str:
    """The colour space libjpeg-turbo gives a frame: "grey", "cmyk" or
    "ycck" (by the Adobe transform: 0 is CMYK, any other YCCK; no marker,
    CMYK), "rgb" or "ycbcr" (by the JFIF and Adobe markers and the ids)."""
    if len(comps) == 1:
        return "grey"
    if len(comps) == 4:
        return "ycck" if adobe is not None and adobe != 0 else "cmyk"
    ids = tuple(c[0] for c in comps)
    rgb = (not jfif) and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
    return "rgb" if rgb else "ycbcr"


def _jpeg_rgb(planes, comps, adobe, jfif) -> np.ndarray:
    """Full-size component planes to RGB as libjpeg-turbo and PIL convert
    them (:func:`_jpeg_colour`): grey repeated, CMYK/YCCK, RGB or YCbCr."""
    colour = _jpeg_colour(comps, adobe, jfif)
    if colour == "grey":
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    if colour in ("cmyk", "ycck"):
        return _cmyk_to_rgb(*planes, ycck=colour == "ycck")
    if colour == "rgb":
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def _lossless_scan(data: bytes, start: int, scan, huff, samples, width: int, height: int,
                   restart: int, predictor: int, pt: int) -> int:
    """One Huffman-coded lossless scan from its entropy-coded data at
    ``start`` into ``samples``; returns the position after it. A restart
    interval that is not a whole number of rows raises."""
    segs, end = _entropy_segments(data, start)
    units_per_row = width
    per = restart or units_per_row * height
    if per % units_per_row:
        raise NotImplementedError("a lossless JPEG whose restart interval is not a whole "
                                  "number of rows")
    rows_per = per // units_per_row
    comps = [(c, huff[(0, td)]) for c, td, _ in scan]
    for i, seg in enumerate(segs):
        rows = range(i * rows_per, min(height, (i + 1) * rows_per))
        if not rows:
            break
        lossless_interval(seg, comps, samples, rows, width, predictor, pt, 8)
    return end


def _decode_own(data: bytes, name: str):
    """The pixels of a file this module decodes itself (PNG, the JPEGs of
    :func:`_jpeg_frame`, GIF, BMP, TIFF, WebP), else None. A JPEG of
    another precision than 8 bits raises: PIL refuses it too."""
    if _is_own_png(data):
        return _read_png(data)
    if _jpeg_frame(data) is not None:
        return decode_jpeg(data)
    sof = _sof(data)
    if sof is not None and sof[1] != 8:
        raise NotImplementedError(f"{name}: {image_format(data)}, which neither this module "
                                  "nor PIL reads")
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        try:
            return decode_webp(data)
        except NotImplementedError as e:
            raise NotImplementedError(f"{name}: {e}") from e
    try:
        return decode_codec(data)
    except NotImplementedError as e:
        raise NotImplementedError(f"{name}: {e}") from e


def _pil_rgb(source, data: bytes, name: str) -> np.ndarray:
    """What is left (an arithmetic, 12-bit or lossless JPEG), through PIL;
    naming the format where PIL is absent."""
    try:
        from PIL import Image
    except ImportError as e:
        raise NotImplementedError(f"{name}: {image_format(data)}, which this module does not "
                                  "decode, and PIL is not installed") from e

    with Image.open(source) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def decode_image(data: bytes, name: str = "image") -> np.ndarray:
    """An image file's bytes as RGB ``uint8 [H, W, 3]``: PNGs, the JPEGs of
    :func:`_jpeg_frame`, GIFs, BMPs and TIFFs (``data/image_codecs.py``) and
    WebPs (``data/webp.py``; a variant it does not take raises, naming it)
    decoded here, the rest by PIL, chosen by the header (``name`` says which
    file in errors)."""
    got = _decode_own(data, name)
    return got if got is not None else _pil_rgb(io.BytesIO(data), data, name)


def read_image(path: str) -> np.ndarray:
    """The image at ``path`` as RGB ``uint8 [H, W, 3]``, as
    :func:`decode_image` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    got = _decode_own(data, path)
    return got if got is not None else _pil_rgb(path, data, path)


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
