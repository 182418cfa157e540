"""WebP decoding without PIL (the card's machine has none), bitwise as PIL
12.1 with libwebp 1.6 gives ``np.asarray(Image.open(f).convert("RGB"))``.

:func:`decode_webp` takes a RIFF ``WEBP`` file:

- ``VP8L`` (lossless): the prefix codes (simple and normal), meta prefix
  codes over tiles, the colour cache, LZ77 copies with the 120 plane codes,
  and the four transforms (predictor, cross colour, subtract green, colour
  indexing with pixel bundling), undone in reverse order.
- ``VP8 `` (lossy, key frames): the boolean decoder, segments, the token
  probabilities, intra prediction (16x16, 4x4 and chroma modes with
  libwebp's border samples: 127 above the first row, 129 left of the first
  column), dequantisation, the inverse DCT and WHT, the simple and normal
  loop filters, and YUV 4:2:0 to RGB as libwebp upsamples it ("fancy"
  upsampling) and converts it (14-bit fixed point).
- ``VP8X``: an ``ALPH`` chunk beside a lossy frame (raw or VP8L-compressed,
  with its horizontal, vertical or gradient filter), and animations: the
  first frame on a transparent black canvas, as libwebp's animation decoder
  (which PIL opens every WebP with) gives it.

PIL's RGB drops the alpha channel, so the RGB of a frame is independent of
its alpha; :func:`decode_webp_rgba` returns it too. :func:`webp_variant`
names a file's sub-format. A file this module cannot decode bit for bit as
libwebp does raises ``NotImplementedError`` naming it.

Lossless pixels, prediction and the loop filter are decoded in Python, a
pixel, a block or an edge at a time (the edges in numpy); the colour
transforms and the upsampling run in numpy over whole planes.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np


class WebPError(ValueError):
    """A malformed WebP file."""


# ----------------------------------------------------------------- container
def _chunks(data: bytes, pos: int, end: int) -> List[Tuple[bytes, int, int]]:
    """(fourcc, payload start, payload size) of the RIFF chunks in
    ``data[pos:end]``."""
    out = []
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + size > end:
            raise WebPError(f"a {tag!r} chunk of {size} bytes runs past the file")
        out.append((tag, pos + 8, size))
        pos += 8 + size + (size & 1)
    return out


def _u24(data: bytes, pos: int) -> int:
    return data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16


def _frame_chunks(data: bytes, chunks) -> Tuple[Optional[Tuple[int, int]], Tuple[bytes, int, int]]:
    """(ALPH payload (start, size) or None, the VP8/VP8L chunk) of a frame."""
    alph = None
    for tag, start, size in chunks:
        if tag == b"ALPH":
            alph = (start, size)
        elif tag in (b"VP8 ", b"VP8L"):
            return alph, (tag, start, size)
    raise WebPError("a WebP frame without a VP8 or VP8L chunk")


def _riff(data: bytes):
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise WebPError("not a RIFF WEBP file")
    (riff,) = struct.unpack_from("<I", data, 4)
    return _chunks(data, 12, min(len(data), 8 + riff))


def webp_variant(data: bytes) -> str:
    """The sub-format of a WebP file, in words."""
    chunks = _riff(data)
    tags = [c[0] for c in chunks]
    if tags[0] == b"VP8 ":
        return "a lossy WebP"
    if tags[0] == b"VP8L":
        return "a lossless WebP"
    if tags[0] == b"VP8X":
        if b"ANIM" in tags or b"ANMF" in tags:
            return "an animated WebP"
        if b"VP8L" in tags:
            return "a lossless WebP (extended)"
        return "a lossy WebP with alpha" if b"ALPH" in tags else "a lossy WebP (extended)"
    return f"a WebP whose first chunk is {tags[0]!r}"


def decode_webp_rgba(data: bytes) -> np.ndarray:
    """``uint8 [H, W, 4]``: the RGBA libwebp's animation decoder gives for
    the file's first frame (non-premultiplied; alpha 255 where the file has
    none)."""
    chunks = _riff(data)
    tag = chunks[0][0]
    if tag in (b"VP8 ", b"VP8L"):
        return _decode_frame(data, None, chunks[0])
    if tag != b"VP8X":
        raise WebPError(f"a WebP whose first chunk is {tag!r}")
    _, start, size = chunks[0]
    if size < 10:
        raise WebPError("a VP8X chunk of fewer than 10 bytes")
    flags = data[start]
    cw, ch = 1 + _u24(data, start + 4), 1 + _u24(data, start + 7)
    if flags & 0x02:  # animation: the first ANMF frame on the canvas
        frames = [c for c in chunks if c[0] == b"ANMF"]
        if not frames:
            raise WebPError("an animated WebP without frames")
        _, fs, fsize = frames[0]
        x, y = 2 * _u24(data, fs), 2 * _u24(data, fs + 3)
        fw, fh = 1 + _u24(data, fs + 6), 1 + _u24(data, fs + 9)
        alph, frame = _frame_chunks(data, _chunks(data, fs + 16, fs + fsize))
        rgba = _decode_frame(data, alph, frame)
        if rgba.shape[:2] != (fh, fw) or x + fw > cw or y + fh > ch:
            raise WebPError("an animation frame that does not fit its canvas")
        canvas = np.zeros((ch, cw, 4), np.uint8)
        canvas[y:y + fh, x:x + fw] = rgba
        return canvas
    alph, frame = _frame_chunks(data, chunks[1:])
    rgba = _decode_frame(data, alph, frame)
    if rgba.shape[:2] != (ch, cw):
        raise NotImplementedError(f"a WebP whose canvas ({cw}x{ch}) differs from its frame "
                                  f"({rgba.shape[1]}x{rgba.shape[0]})")
    return rgba


def decode_webp(data: bytes) -> np.ndarray:
    """``uint8 [H, W, 3]``: PIL's ``Image.open(f).convert("RGB")`` of a
    WebP file (its first frame, alpha dropped)."""
    return np.ascontiguousarray(decode_webp_rgba(data)[..., :3])


def _decode_frame(data: bytes, alph, frame) -> np.ndarray:
    tag, start, size = frame
    if tag == b"VP8L":
        argb, w, h = _vp8l_image(data[start:start + size])
        return _argb_to_rgba(argb, w, h)
    rgb = _vp8(data[start:start + size])
    alpha = np.full(rgb.shape[:2], 255, np.uint8)
    if alph is not None:
        alpha = _alpha_plane(data[alph[0]:alph[0] + alph[1]], rgb.shape[1], rgb.shape[0])
    return np.concatenate([rgb, alpha[..., None]], axis=2)


def _argb_to_rgba(argb: np.ndarray, w: int, h: int) -> np.ndarray:
    a = np.asarray(argb, np.uint32).reshape(h, w)
    return np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255, a >> 24], -1).astype(np.uint8)


# ------------------------------------------------------------------ VP8L
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# plane code -> (dy << 4) | (8 - dx), for distance codes 1..120
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c5845"
    "4b343c035759131d565a232d444c555b333d68026769121e666a222e545c434d656b323e"
    "78017779535d111f646c424e767a212f757b313f636d525e00747c414f1020626e30737d"
    "515f40727e616f50717f6070")
_PRIMARY = 10  # bits of a prefix code's first lookup table
_NUM_LITERALS, _NUM_LENGTHS, _NUM_DISTANCES = 256, 24, 40


class _Bits:
    """The LSB-first bits of a VP8L stream."""

    def __init__(self, buf: bytes):
        self.buf = bytes(buf) + bytes(16)
        self.end = len(buf) * 8
        self.pos = 0

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        if self.pos > self.end + 64:
            raise WebPError("a VP8L stream cut short")
        return (int.from_bytes(self.buf[p >> 3:(p >> 3) + 8], "little") >> (p & 7)) & ((1 << n) - 1)


class _Prefix:
    """A canonical prefix code read LSB-first: the symbol of the next bits
    from one table of ``_PRIMARY`` bits, longer codes from a dictionary."""

    def __init__(self, lengths):
        lengths = [int(x) for x in lengths]
        used = [s for s, n in enumerate(lengths) if n]
        if not used:
            raise WebPError("a VP8L prefix code without symbols")
        self.single = used[0] if len(used) == 1 else None
        if self.single is not None:
            return
        maxlen = max(lengths)
        counts = [0] * (maxlen + 1)
        for n in lengths:
            if n:
                counts[n] += 1
        left = 1
        for n in range(1, maxlen + 1):
            left = (left << 1) - counts[n]
            if left < 0:
                raise WebPError("an over-subscribed VP8L prefix code")
        if left:
            raise WebPError("an incomplete VP8L prefix code")
        code, nxt = 0, [0] * (maxlen + 2)
        for n in range(1, maxlen + 1):
            code = (code + counts[n - 1]) << 1 if n > 1 else 0
            nxt[n] = code
        bits = min(maxlen, _PRIMARY)
        self.bits, self.mask = bits, (1 << bits) - 1
        table = [0] * (1 << bits)
        self.long: Dict[Tuple[int, int], int] = {}
        self.maxlen = maxlen
        for s, n in enumerate(lengths):
            if not n:
                continue
            c = nxt[n]
            nxt[n] += 1
            rev = int(format(c, f"0{n}b")[::-1], 2)
            if n <= bits:
                for k in range(rev, 1 << bits, 1 << n):
                    table[k] = (s << 5) | n
            else:
                self.long[(n, rev)] = s
        self.table = table

    def read(self, br: _Bits) -> int:
        if self.single is not None:
            return self.single
        p = br.pos
        w = int.from_bytes(br.buf[p >> 3:(p >> 3) + 8], "little") >> (p & 7)
        e = self.table[w & self.mask]
        if e & 31:
            br.pos = p + (e & 31)
            return e >> 5
        for n in range(self.bits + 1, self.maxlen + 1):
            s = self.long.get((n, w & ((1 << n) - 1)))
            if s is not None:
                br.pos = p + n
                return s
        raise WebPError("a VP8L prefix code word that is no code")


def _code_lengths(br: _Bits, size: int) -> List[int]:
    """The code lengths of a normal prefix code of ``size`` symbols."""
    n = br.read(4) + 4
    cl = [0] * 19
    for i in range(n):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    lens_code = _Prefix(cl)
    if br.read(1):
        nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(nbits)
        if max_symbol > size:
            raise WebPError("a VP8L code length count past its alphabet")
    else:
        max_symbol = size
    out = [0] * size
    prev, s = 8, 0
    while s < size:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = lens_code.read(br)
        if c < 16:
            out[s] = c
            s += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            repeat = br.read(extra) + offset
            if s + repeat > size:
                raise WebPError("a VP8L code length repeat past its alphabet")
            value = prev if c == 16 else 0
            out[s:s + repeat] = [value] * repeat
            s += repeat
    return out


def _prefix_code(br: _Bits, size: int) -> _Prefix:
    if br.read(1):  # simple: one or two symbols
        count = br.read(1) + 1
        lengths = [0] * size
        first = br.read(8 if br.read(1) else 1)
        if first >= size:
            raise WebPError("a VP8L simple code symbol past its alphabet")
        lengths[first] = 1
        if count == 2:
            second = br.read(8)
            if second >= size:
                raise WebPError("a VP8L simple code symbol past its alphabet")
            lengths[second] = 1
        return _Prefix(lengths)
    return _Prefix(_code_lengths(br, size))


def _copy_amount(br: _Bits, sym: int) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _entropy_image(br: _Bits, xsize: int, ysize: int, level0: bool) -> List[int]:
    """One entropy-coded image of ``xsize`` x ``ysize`` ARGB pixels (its
    colour cache and, at level 0, its meta prefix codes)."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise WebPError(f"a VP8L colour cache of {cache_bits} bits")
    meta_bits, meta = 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = (xsize + (1 << meta_bits) - 1) >> meta_bits
        mh = (ysize + (1 << meta_bits) - 1) >> meta_bits
        meta = [(p >> 8) & 0xFFFF for p in _image_stream(br, mw, mh, False)]
        meta_w = mw
    ngroups = (max(meta) + 1) if meta else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    sizes = (_NUM_LITERALS + _NUM_LENGTHS + cache_size, 256, 256, 256, _NUM_DISTANCES)
    groups = [[_prefix_code(br, n) for n in sizes] for _ in range(ngroups)]
    total = xsize * ysize
    out: List[int] = []
    append = out.append
    cache = [0] * cache_size
    shift = 32 - cache_bits
    cached = 0  # pixels of out already in the cache
    x = y = 0
    group = groups[0]
    while len(out) < total:
        if meta is not None:
            group = groups[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        g = group[0].read(br)
        if g < _NUM_LITERALS:
            r = group[1].read(br)
            b = group[2].read(br)
            a = group[3].read(br)
            append((a << 24) | (r << 16) | (g << 8) | b)
            n = 1
        elif g < _NUM_LITERALS + _NUM_LENGTHS:
            length = _copy_amount(br, g - _NUM_LITERALS)
            code = _copy_amount(br, group[4].read(br))
            if code > 120:
                dist = code - 120
            else:
                p = _CODE_TO_PLANE[code - 1]
                dist = (p >> 4) * xsize + 8 - (p & 15)
                if dist < 1:
                    dist = 1
            if dist > len(out) or len(out) + length > total:
                raise WebPError("a VP8L copy outside its image")
            start = len(out) - dist
            if dist >= length:
                out.extend(out[start:start + length])
            else:
                for i in range(length):
                    append(out[start + i])
            n = length
        else:
            key = g - _NUM_LITERALS - _NUM_LENGTHS
            if key >= cache_size:
                raise WebPError("a VP8L colour cache index past its cache")
            # the cache holds every pixel before this one
            for px in out[cached:]:
                cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            cached = len(out)
            append(cache[key])
            n = 1
        x += n
        while x >= xsize:
            x -= xsize
            y += 1
    if br.pos > br.end:
        raise WebPError("a VP8L stream cut short")
    return out


def _image_stream(br: _Bits, xsize: int, ysize: int, level0: bool) -> List[int]:
    """An image stream: at level 0 its transforms, then its entropy-coded
    image, the transforms undone; a sub-image (level 1) has none."""
    transforms = []
    width = xsize
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise WebPError("a VP8L transform given twice")
            seen.add(kind)
            if kind in (0, 1):  # predictor, cross colour: a sub-image of blocks
                bits = br.read(3) + 2
                bw = (width + (1 << bits) - 1) >> bits
                bh = (ysize + (1 << bits) - 1) >> bits
                transforms.append((kind, width, bits, _image_stream(br, bw, bh, False)))
            elif kind == 2:
                transforms.append((kind, width, 0, None))
            else:  # colour indexing
                ncolors = br.read(8) + 1
                bits = 0 if ncolors > 16 else 1 if ncolors > 4 else 2 if ncolors > 2 else 3
                palette = _image_stream(br, ncolors, 1, False)
                transforms.append((kind, width, bits, palette))
                width = (width + (1 << bits) - 1) >> bits
    pixels = _entropy_image(br, width, ysize, level0)
    for kind, w, bits, sub in reversed(transforms):
        pixels = _undo_transform(kind, w, ysize, bits, sub, pixels)
    return pixels


def _channels(p: np.ndarray) -> np.ndarray:
    """uint32 ARGB -> int64 [..., 4] (a, r, g, b)."""
    p = np.asarray(p, np.uint32)
    return np.stack([(p >> 24) & 255, (p >> 16) & 255, (p >> 8) & 255, p & 255],
                    -1).astype(np.int64)


def _pack(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.uint32) & 255
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | c[..., 3]


def _undo_transform(kind: int, w: int, h: int, bits: int, sub, pixels) -> List[int]:
    if kind == 2:  # subtract green: add it back to red and blue
        c = _channels(pixels)
        c[:, 1] += c[:, 2]
        c[:, 3] += c[:, 2]
        return _pack(c).tolist()
    if kind == 1:  # cross colour
        c = _channels(pixels).reshape(h, w, 4)
        bw = (w + (1 << bits) - 1) >> bits
        m = _channels(sub).reshape(-1, bw, 4)
        ys, xs = np.arange(h) >> bits, np.arange(w) >> bits
        blk = m[ys[:, None], xs[None, :]]  # [h, w, 4]: (a, r, g, b) of the block's code

        def s8(v):
            return ((v + 128) & 255) - 128

        g2r, g2b, r2b = s8(blk[..., 3]), s8(blk[..., 2]), s8(blk[..., 1])
        green = s8(c[..., 2])
        red = (c[..., 1] + ((g2r * green) >> 5)) & 255
        blue = (c[..., 3] + ((g2b * green) >> 5) + ((r2b * s8(red)) >> 5)) & 255
        c[..., 1], c[..., 3] = red, blue
        return _pack(c.reshape(-1, 4)).tolist()
    if kind == 3:  # colour indexing
        n = len(sub)
        pal = list(sub)
        for i in range(1, n):  # the palette is delta-coded
            a, b = pal[i], pal[i - 1]
            pal[i] = ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
                      | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))
        table = np.zeros(256, np.uint32)
        table[:n] = pal
        packed_w = (w + (1 << bits) - 1) >> bits
        g = ((np.asarray(pixels, np.uint32) >> 8) & 255).reshape(h, packed_w)
        if bits:
            per = 8 >> bits
            x = np.arange(w)
            idx = (g[:, x >> bits] >> ((x & ((1 << bits) - 1)) * per)) & ((1 << per) - 1)
        else:
            idx = g
        return table[idx].reshape(-1).tolist()
    return _undo_predictor(w, h, bits, sub, pixels)


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | \
        (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _select(t: int, l: int, tl: int) -> int:
    d = 0
    for s in (24, 16, 8, 0):
        a, b, c = (t >> s) & 255, (l >> s) & 255, (tl >> s) & 255
        d += abs(b - c) - abs(a - c)
    return t if d <= 0 else l


def _full(l: int, t: int, tl: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        out |= _clip255(((l >> s) & 255) + ((t >> s) & 255) - ((tl >> s) & 255)) << s
    return out


def _half(l: int, t: int, tl: int) -> int:
    a = _avg(l, t)
    out = 0
    for s in (24, 16, 8, 0):
        x, y = (a >> s) & 255, (tl >> s) & 255
        d = x - y
        out |= _clip255(x + (d // 2 if d >= 0 else -((-d) // 2))) << s
    return out


def _predict(mode: int, l: int, t: int, tl: int, tr: int) -> int:
    if mode == 1:
        return l
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg(_avg(l, tr), t)
    if mode == 6:
        return _avg(l, tl)
    if mode == 7:
        return _avg(l, t)
    if mode == 8:
        return _avg(tl, t)
    if mode == 9:
        return _avg(t, tr)
    if mode == 10:
        return _avg(_avg(l, tl), _avg(t, tr))
    if mode == 11:
        return _select(t, l, tl)
    if mode == 12:
        return _full(l, t, tl)
    if mode == 13:
        return _half(l, t, tl)
    return 0xFF000000  # 0, and 14 and 15 as libwebp reads them


def _undo_predictor(w: int, h: int, bits: int, sub, pixels) -> List[int]:
    out = list(pixels)
    bw = (w + (1 << bits) - 1) >> bits
    modes = [(p >> 8) & 15 for p in sub]
    # the first row: black, then left
    out[0] = _add(out[0], 0xFF000000)
    for x in range(1, w):
        out[x] = _add(out[x], out[x - 1])
    for y in range(1, h):
        row, up = y * w, (y - 1) * w
        out[row] = _add(out[row], out[up])  # the first column: top
        mrow = (y >> bits) * bw
        for x in range(1, w):
            i = row + x
            # top-right of the last column is the first pixel of this row
            pred = _predict(modes[mrow + (x >> bits)], out[i - 1], out[i - w], out[i - w - 1],
                            out[i - w + 1])
            out[i] = _add(out[i], pred)
    return out


def _vp8l_image(chunk: bytes) -> Tuple[List[int], int, int]:
    if len(chunk) < 5 or chunk[0] != 0x2F:
        raise WebPError("a VP8L chunk without its signature")
    br = _Bits(chunk[1:])
    w, h = br.read(14) + 1, br.read(14) + 1
    br.read(1)  # alpha_is_used: a hint only
    if br.read(3) != 0:
        raise NotImplementedError("a VP8L bitstream of a version other than 0")
    return _image_stream(br, w, h, True), w, h


def _unfilter(alpha: np.ndarray, method: int) -> np.ndarray:
    """Undo an ALPH filter (1 horizontal, 2 vertical, 3 gradient) as
    libwebp's unfilters do: the first row horizontally from 0, the first
    column from the pixel above."""
    h, w = alpha.shape
    out = np.zeros((h, w), np.uint8)
    a = alpha.astype(np.int64)
    for y in range(h):
        if y == 0 or method == 1:
            pred = 0 if y == 0 else int(out[y - 1, 0])
            row = (np.cumsum(a[y]) + pred) & 255
            out[y] = row
        elif method == 2:
            out[y] = (a[y] + out[y - 1]) & 255
        else:
            prev = out[y - 1].astype(np.int64)
            left = int(prev[0])
            top_left = left
            r = [0] * w
            for x in range(w):
                top = int(prev[x])
                g = left + top - top_left
                left = (int(a[y, x]) + (0 if g < 0 else 255 if g > 255 else g)) & 255
                top_left = top
                r[x] = left
            out[y] = r
    return out


def _alpha_plane(chunk: bytes, w: int, h: int) -> np.ndarray:
    if not chunk:
        raise WebPError("an empty ALPH chunk")
    head = chunk[0]
    method, filt = head & 3, (head >> 2) & 3
    if method == 0:
        if len(chunk) - 1 < w * h:
            raise WebPError("a raw ALPH chunk cut short")
        alpha = np.frombuffer(chunk, np.uint8, w * h, 1).reshape(h, w)
    elif method == 1:
        br = _Bits(chunk[1:])
        argb = np.asarray(_image_stream(br, w, h, True), np.uint32)
        alpha = ((argb >> 8) & 255).astype(np.uint8).reshape(h, w)
    else:
        raise NotImplementedError(f"an ALPH chunk of compression method {method}")
    return _unfilter(alpha, filt) if filt else alpha.copy()


# ------------------------------------------------------------------- VP8
# RFC 6386's dequantisation tables (libwebp's kDcTable, kAcTable)
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86,
    87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122,
    124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88,
    90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189,
    193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269,
    274, 279, 284)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# RFC 6386's coeff_update_probs, default_coeff_probs [4][8][3][11] and
# kf_bmode_probs [10][10][9], as libwebp keeps them
_COEF_UPDATE = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
_COEF_DEFAULT = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
_BMODE_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418")
BPS = 32  # the stride of libwebp's reconstruction work buffer
Y_OFF = BPS * 1 + 8
U_OFF = Y_OFF + BPS * 16 + BPS
V_OFF = U_OFF + 16
_SCAN = tuple((n & 3) * 4 + (n >> 2) * 4 * BPS for n in range(16))
B_DC, B_TM, B_VE, B_HE = 0, 1, 2, 3


class _Bool:
    """VP8's boolean decoder as libwebp keeps it (utils/bit_reader): the
    range stored less one, bytes taken one at a time into ``value`` below
    the current 8-bit window (``bits`` of them), zeros past the end; and
    libwebp's sign read, whose split is half the stored range and whose
    shift is always one (which differs from a 0x80 read when the range is
    255)."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.bits, self.range = 0, -8, 254

    def _load(self) -> None:
        while self.bits < 0:
            p = self.pos
            self.pos = p + 1
            self.value = (self.value << 8) | (self.data[p] if p < self.end else 0)
            self.bits += 8

    def get(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        pos = self.bits
        rng = self.range
        split = (rng * prob) >> 8
        if (self.value >> pos) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 7 ^ (rng.bit_length() - 1)
        self.range = (rng << shift) - 1
        self.bits = pos - shift
        return bit

    def sign(self) -> int:
        """1 for a negative coefficient (libwebp's VP8GetSigned)."""
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range >> 1
        self.bits = pos - 1
        if (self.value >> pos) > split:
            self.range = (self.range - 1) | 1
            self.value -= (split + 1) << pos
            return 1
        self.range |= 1
        return 0

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get(0x80)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.get(0x80) else v


def _clip8(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _avg3(a: int, b: int, c: int) -> int:
    return (a + 2 * b + c + 2) >> 2


def _pred4(w: list, d: int, mode: int) -> None:
    """libwebp's 4x4 luma predictors (dsp/dec.c) into the work buffer at d."""
    top = d - BPS
    if mode == B_DC:
        dc = 4
        for i in range(4):
            dc += w[top + i] + w[d - 1 + i * BPS]
        dc >>= 3
        for j in range(4):
            w[d + j * BPS:d + j * BPS + 4] = [dc] * 4
        return
    if mode == B_TM:
        tl = w[top - 1]
        for j in range(4):
            left = w[d - 1 + j * BPS] - tl
            r = d + j * BPS
            for i in range(4):
                w[r + i] = _clip8(w[top + i] + left)
        return
    if mode == B_VE:
        v = [_avg3(w[top + i - 1], w[top + i], w[top + i + 1]) for i in range(4)]
        for j in range(4):
            w[d + j * BPS:d + j * BPS + 4] = v
        return
    if mode == B_HE:
        A, B, C, D, E = (w[d - 1 - BPS], w[d - 1], w[d - 1 + BPS], w[d - 1 + 2 * BPS],
                         w[d - 1 + 3 * BPS])
        for j, v in enumerate((_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, E))):
            w[d + j * BPS:d + j * BPS + 4] = [v] * 4
        return
    I, J, K, L = w[d - 1], w[d - 1 + BPS], w[d - 1 + 2 * BPS], w[d - 1 + 3 * BPS]
    X = w[top - 1]
    A, B, C, D, E, F, G, H = w[top:top + 8]

    def put(x, y, v):
        w[d + x + y * BPS] = v

    if mode == 4:  # RD
        put(0, 3, _avg3(J, K, L))
        v = _avg3(I, J, K); put(1, 3, v); put(0, 2, v)
        v = _avg3(X, I, J); put(2, 3, v); put(1, 2, v); put(0, 1, v)
        v = _avg3(A, X, I); put(3, 3, v); put(2, 2, v); put(1, 1, v); put(0, 0, v)
        v = _avg3(B, A, X); put(3, 2, v); put(2, 1, v); put(1, 0, v)
        v = _avg3(C, B, A); put(3, 1, v); put(2, 0, v)
        put(3, 0, _avg3(D, C, B))
    elif mode == 5:  # VR
        v = (X + A + 1) >> 1; put(0, 0, v); put(1, 2, v)
        v = (A + B + 1) >> 1; put(1, 0, v); put(2, 2, v)
        v = (B + C + 1) >> 1; put(2, 0, v); put(3, 2, v)
        put(3, 0, (C + D + 1) >> 1)
        put(0, 3, _avg3(K, J, I))
        put(0, 2, _avg3(J, I, X))
        v = _avg3(I, X, A); put(0, 1, v); put(1, 3, v)
        v = _avg3(X, A, B); put(1, 1, v); put(2, 3, v)
        v = _avg3(A, B, C); put(2, 1, v); put(3, 3, v)
        put(3, 1, _avg3(B, C, D))
    elif mode == 6:  # LD
        put(0, 0, _avg3(A, B, C))
        v = _avg3(B, C, D); put(1, 0, v); put(0, 1, v)
        v = _avg3(C, D, E); put(2, 0, v); put(1, 1, v); put(0, 2, v)
        v = _avg3(D, E, F); put(3, 0, v); put(2, 1, v); put(1, 2, v); put(0, 3, v)
        v = _avg3(E, F, G); put(3, 1, v); put(2, 2, v); put(1, 3, v)
        v = _avg3(F, G, H); put(3, 2, v); put(2, 3, v)
        put(3, 3, _avg3(G, H, H))
    elif mode == 7:  # VL
        put(0, 0, (A + B + 1) >> 1)
        v = (B + C + 1) >> 1; put(1, 0, v); put(0, 2, v)
        v = (C + D + 1) >> 1; put(2, 0, v); put(1, 2, v)
        v = (D + E + 1) >> 1; put(3, 0, v); put(2, 2, v)
        put(0, 1, _avg3(A, B, C))
        v = _avg3(B, C, D); put(1, 1, v); put(0, 3, v)
        v = _avg3(C, D, E); put(2, 1, v); put(1, 3, v)
        v = _avg3(D, E, F); put(3, 1, v); put(2, 3, v)
        put(3, 2, _avg3(E, F, G))
        put(3, 3, _avg3(F, G, H))
    elif mode == 8:  # HD
        v = (I + X + 1) >> 1; put(0, 0, v); put(2, 1, v)
        v = (J + I + 1) >> 1; put(0, 1, v); put(2, 2, v)
        v = (K + J + 1) >> 1; put(0, 2, v); put(2, 3, v)
        put(0, 3, (L + K + 1) >> 1)
        put(3, 0, _avg3(A, B, C))
        put(2, 0, _avg3(X, A, B))
        v = _avg3(I, X, A); put(1, 0, v); put(3, 1, v)
        v = _avg3(J, I, X); put(1, 1, v); put(3, 2, v)
        v = _avg3(K, J, I); put(1, 2, v); put(3, 3, v)
        put(1, 3, _avg3(L, K, J))
    else:  # HU
        put(0, 0, (I + J + 1) >> 1)
        v = (J + K + 1) >> 1; put(2, 0, v); put(0, 1, v)
        v = (K + L + 1) >> 1; put(2, 1, v); put(0, 2, v)
        put(1, 0, _avg3(I, J, K))
        v = _avg3(J, K, L); put(3, 0, v); put(1, 1, v)
        v = _avg3(K, L, L); put(3, 1, v); put(1, 2, v)
        for x, y in ((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)):
            put(x, y, L)


def _pred_block(w: list, d: int, size: int, mode: int) -> None:
    """libwebp's 16x16 luma and 8x8 chroma predictors; ``mode`` 4, 5, 6 are
    DC without the top, without the left, without either."""
    top = d - BPS
    if mode == B_TM:
        tl = w[top - 1]
        for j in range(size):
            left = w[d - 1 + j * BPS] - tl
            r = d + j * BPS
            w[r:r + size] = [_clip8(w[top + i] + left) for i in range(size)]
        return
    if mode == B_VE:
        row = w[top:top + size]
        for j in range(size):
            w[d + j * BPS:d + j * BPS + size] = row
        return
    if mode == B_HE:
        for j in range(size):
            w[d + j * BPS:d + j * BPS + size] = [w[d - 1 + j * BPS]] * size
        return
    shift = 5 if size == 16 else 4
    if mode == B_DC:
        dc = sum(w[top:top + size]) + sum(w[d - 1 + j * BPS] for j in range(size))
        dc = (dc + size) >> shift
    elif mode == 4:  # no top
        dc = (sum(w[d - 1 + j * BPS] for j in range(size)) + (size >> 1)) >> (shift - 1)
    elif mode == 5:  # no left
        dc = (sum(w[top:top + size]) + (size >> 1)) >> (shift - 1)
    else:
        dc = 0x80
    for j in range(size):
        w[d + j * BPS:d + j * BPS + size] = [dc] * size


def _mul1(a: int) -> int:
    return ((a * 20091) >> 16) + a


def _mul2(a: int) -> int:
    return (a * 35468) >> 16


def _transform(c: list, w: list, d: int) -> None:
    """libwebp's TransformOne: the inverse DCT of 16 coefficients added to
    the 4x4 block at d."""
    tmp = [0] * 16
    for i in range(4):
        a = c[i] + c[8 + i]
        b = c[i] - c[8 + i]
        cc = _mul2(c[4 + i]) - _mul1(c[12 + i])
        dd = _mul1(c[4 + i]) + _mul2(c[12 + i])
        tmp[4 * i:4 * i + 4] = (a + dd, b + cc, b - cc, a - dd)
    for i in range(4):
        dc = tmp[i] + 4
        a = dc + tmp[8 + i]
        b = dc - tmp[8 + i]
        cc = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        dd = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        r = d + i * BPS
        w[r] = _clip8(w[r] + ((a + dd) >> 3))
        w[r + 1] = _clip8(w[r + 1] + ((b + cc) >> 3))
        w[r + 2] = _clip8(w[r + 2] + ((b - cc) >> 3))
        w[r + 3] = _clip8(w[r + 3] + ((a - dd) >> 3))


def _wht(dc: list, coeffs: list) -> None:
    """The inverse WHT of the 16 luma DC values into each block's coeffs[0]."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    for i in range(4):
        d0 = tmp[4 * i] + 3
        a0 = d0 + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d0 - tmp[4 * i + 3]
        coeffs[(4 * i) * 16] = (a0 + a1) >> 3
        coeffs[(4 * i + 1) * 16] = (a3 + a2) >> 3
        coeffs[(4 * i + 2) * 16] = (a0 - a1) >> 3
        coeffs[(4 * i + 3) * 16] = (a3 - a2) >> 3


def _large_value(br: _Bool, p) -> int:
    if not br.get(p[3]):
        return 2 if not br.get(p[4]) else 3 + br.get(p[5])
    if not br.get(p[6]):
        if not br.get(p[7]):
            return 5 + br.get(159)
        return 7 + 2 * br.get(165) + br.get(145)
    bit1 = br.get(p[8])
    bit0 = br.get(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in _CAT3456[cat]:
        v += v + br.get(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bool, bands, ctx: int, dq, n: int, out: list, base: int) -> int:
    """libwebp's GetCoeffs: the tokens of one block from position n, into
    out[base:base + 16] dequantised; returns the index after the last
    non-zero one (or n)."""
    p = bands[n][ctx]
    while n < 16:
        if not br.get(p[0]):
            return n
        while not br.get(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not br.get(p[2]):
            v = 1
            p = bands[n + 1][1]
        else:
            v = _large_value(br, p)
            p = bands[n + 1][2]
        if br.sign():
            v = -v
        out[base + _ZIGZAG[n]] = v * dq[1 if n > 0 else 0]
        n += 1
    return 16


def _clip(v: int, hi: int) -> int:
    return 0 if v < 0 else hi if v > hi else v


def _parse_header(data: bytes):
    if len(data) < 10:
        raise WebPError("a VP8 chunk of fewer than 10 bytes")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1:
        raise NotImplementedError("a VP8 frame that is not a key frame")
    if (bits >> 1) & 7 > 3:
        raise WebPError(f"a VP8 frame of profile {(bits >> 1) & 7}")
    if not (bits >> 4) & 1:
        raise WebPError("a VP8 frame not meant to be shown")
    part0 = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise WebPError("a VP8 key frame without its start code")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if 10 + part0 > len(data):
        raise WebPError("a VP8 first partition past its chunk")
    return w, h, part0


class _Header:
    pass


def _frame_header(br: _Bool, data: bytes, part0_end: int) -> _Header:
    """Segments, filter, partitions, quantisers and token probabilities
    (libwebp's VP8GetHeaders)."""
    hd = _Header()
    br.get(0x80)  # colour space
    br.get(0x80)  # clamping type
    hd.use_segment = br.get(0x80)
    hd.update_map, hd.absolute = 0, 1
    hd.quantizer, hd.strength = [0] * 4, [0] * 4
    hd.seg_proba = [255, 255, 255]
    if hd.use_segment:
        hd.update_map = br.get(0x80)
        if br.get(0x80):
            hd.absolute = br.get(0x80)
            hd.quantizer = [br.signed(7) if br.get(0x80) else 0 for _ in range(4)]
            hd.strength = [br.signed(6) if br.get(0x80) else 0 for _ in range(4)]
        if hd.update_map:
            hd.seg_proba = [br.value_bits(8) if br.get(0x80) else 255 for _ in range(3)]
    hd.simple = br.get(0x80)
    hd.level = br.value_bits(6)
    hd.sharpness = br.value_bits(3)
    hd.use_lf_delta = br.get(0x80)
    hd.ref_lf_delta, hd.mode_lf_delta = [0] * 4, [0] * 4
    if hd.use_lf_delta and br.get(0x80):
        for i in range(4):
            if br.get(0x80):
                hd.ref_lf_delta[i] = br.signed(6)
        for i in range(4):
            if br.get(0x80):
                hd.mode_lf_delta[i] = br.signed(6)
    hd.filter_type = 0 if hd.level == 0 else 1 if hd.simple else 2
    # token partitions
    last = (1 << br.value_bits(2)) - 1
    start = part0_end + 3 * last
    if start > len(data):
        raise WebPError("VP8 partition sizes past the chunk")
    parts = []
    for p in range(last):
        size = _u24(data, part0_end + 3 * p)
        size = min(size, len(data) - start)
        parts.append(_Bool(data, start, start + size))
        start += size
    parts.append(_Bool(data, start, len(data)))
    hd.parts = parts
    # quantisers
    q0 = br.value_bits(7)
    deltas = [br.signed(4) if br.get(0x80) else 0 for _ in range(5)]
    dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = deltas
    hd.dq = []
    for s in range(4):
        if hd.use_segment:
            q = hd.quantizer[s] + (0 if hd.absolute else q0)
        elif s > 0:
            hd.dq.append(hd.dq[0])
            continue
        else:
            q = q0
        y2_ac = (_AC_TABLE[_clip(q + dy2_ac, 127)] * 101581) >> 16
        hd.dq.append(((_DC_TABLE[_clip(q + dy1_dc, 127)], _AC_TABLE[_clip(q, 127)]),
                      (_DC_TABLE[_clip(q + dy2_dc, 127)] * 2, max(y2_ac, 8)),
                      (_DC_TABLE[_clip(q + duv_dc, 117)], _AC_TABLE[_clip(q + duv_ac, 127)])))
    br.get(0x80)  # refresh the entropy probabilities: a key frame has no other
    proba = []
    for t in range(4):
        bands = []
        for b in range(8):
            ctxs = []
            for c in range(3):
                at = ((t * 8 + b) * 3 + c) * 11
                ctxs.append([br.value_bits(8) if br.get(_COEF_UPDATE[at + i])
                             else _COEF_DEFAULT[at + i] for i in range(11)])
            bands.append(ctxs)
        # by coefficient position: band of n, and a sentinel past the last
        proba.append([bands[_BANDS[n]] for n in range(17)])
    hd.proba = proba
    hd.use_skip = br.get(0x80)
    hd.skip_p = br.value_bits(8) if hd.use_skip else 0
    return hd


def _filter_strengths(hd: _Header):
    """(limit, interior limit, hev threshold, inner) by segment and i4x4, as
    libwebp's PrecomputeFilterStrengths."""
    out = []
    for s in range(4):
        base = hd.strength[s] + (0 if hd.absolute else hd.level) if hd.use_segment else hd.level
        row = []
        for i4x4 in (0, 1):
            level = base
            if hd.use_lf_delta:
                level += hd.ref_lf_delta[0]
                if i4x4:
                    level += hd.mode_lf_delta[0]
            level = _clip(level, 63)
            if level > 0:
                ilevel = level
                if hd.sharpness > 0:
                    ilevel >>= 2 if hd.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - hd.sharpness)
                ilevel = max(ilevel, 1)
                row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0,
                            i4x4))
            else:
                row.append((0, 0, 0, i4x4))
        out.append(row)
    return out


def _intra_modes(br: _Bool, hd: _Header, top: list, left: list):
    """(segment, skip, is_i4x4, 16 luma modes or one, chroma mode) of one
    macroblock (libwebp's ParseIntraMode); ``top``/``left`` are the 4x4 mode
    contexts, updated."""
    if hd.update_map:
        p = hd.seg_proba
        seg = br.get(p[1]) if not br.get(p[0]) else br.get(p[2]) + 2
    else:
        seg = 0
    skip = br.get(hd.skip_p) if hd.use_skip else 0
    i4x4 = not br.get(145)
    if not i4x4:
        if br.get(156):
            ymode = B_TM if br.get(128) else B_HE
        else:
            ymode = B_VE if br.get(163) else B_DC
        top[:] = [ymode] * 4
        left[:] = [ymode] * 4
        modes = [ymode]
    else:
        modes = []
        for y in range(4):
            ymode = left[y]
            for x in range(4):
                at = (top[x] * 10 + ymode) * 9
                p = _BMODE_PROBA[at:at + 9]
                if not br.get(p[0]):
                    ymode = B_DC
                elif not br.get(p[1]):
                    ymode = B_TM
                elif not br.get(p[2]):
                    ymode = B_VE
                elif not br.get(p[3]):
                    if not br.get(p[4]):
                        ymode = B_HE
                    else:
                        ymode = 4 if not br.get(p[5]) else 5  # RD, VR
                elif not br.get(p[6]):
                    ymode = 6  # LD
                elif not br.get(p[7]):
                    ymode = 7  # VL
                else:
                    ymode = 8 if not br.get(p[8]) else 9  # HD, HU
                top[x] = ymode
            modes.extend(top)
            left[y] = ymode
    if not br.get(142):
        uvmode = B_DC
    elif not br.get(114):
        uvmode = B_VE
    else:
        uvmode = B_TM if br.get(183) else B_HE
    return seg, skip, i4x4, modes, uvmode


def _residuals(br: _Bool, hd: _Header, dq, i4x4: bool, nz, mb_x: int, coeffs: list):
    """libwebp's ParseResiduals: the 24 blocks' dequantised coefficients
    into ``coeffs`` (zeroed), the contexts ``nz`` updated; returns whether
    every coefficient is zero."""
    proba = hd.proba
    top, left = nz["top"][mb_x], nz["left"]
    any_nz = False
    if not i4x4:
        dc = [0] * 16
        ctx = top[1] + left[1]
        n = _coeffs(br, proba[1], ctx, dq[1], 0, dc, 0)
        top[1] = left[1] = 1 if n > 0 else 0
        if n > 1:
            _wht(dc, coeffs)
        else:
            dc0 = (dc[0] + 3) >> 3
            for i in range(16):
                coeffs[16 * i] = dc0
        first, ac = 1, proba[0]
        any_nz = any(coeffs[16 * i] for i in range(16))
    else:
        first, ac = 0, proba[3]
    tnz, lnz = top[0] & 0x0F, left[0] & 0x0F
    for y in range(4):
        l = lnz & 1
        for x in range(4):
            ctx = l + (tnz & 1)
            base = (4 * y + x) * 16
            n = _coeffs(br, ac, ctx, dq[0], first, coeffs, base)
            l = 1 if n > first else 0
            tnz = (tnz >> 1) | (l << 7)
            if n > first:
                any_nz = True
        tnz >>= 4
        lnz = (lnz >> 1) | (l << 7)
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        tnz = top[0] >> (4 + ch)
        lnz = left[0] >> (4 + ch)
        for y in range(2):
            l = lnz & 1
            for x in range(2):
                ctx = l + (tnz & 1)
                base = (16 + 2 * ch + 2 * y + x) * 16
                n = _coeffs(br, proba[2], ctx, dq[2], 0, coeffs, base)
                l = 1 if n > 0 else 0
                tnz = (tnz >> 1) | (l << 3)
                if n > 0:
                    any_nz = True
            tnz >>= 2
            lnz = (lnz >> 1) | (l << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    top[0], left[0] = out_t, out_l
    return not any_nz


def _reconstruct(w: list, mb, mb_x: int, mb_y: int, mb_w: int, tops, coeffs: list) -> None:
    """libwebp's ReconstructRow for one macroblock in the work buffer ``w``
    (its border samples already in place)."""
    seg, skip, i4x4, modes, uvmode = mb
    if mb_y > 0:
        ty, tu, tv = tops[mb_x]
        w[Y_OFF - BPS:Y_OFF - BPS + 16] = ty
        w[U_OFF - BPS:U_OFF - BPS + 8] = tu
        w[V_OFF - BPS:V_OFF - BPS + 8] = tv
    if i4x4:
        tr = Y_OFF - BPS + 16
        if mb_y > 0:
            w[tr:tr + 4] = [tops[mb_x][0][15]] * 4 if mb_x >= mb_w - 1 else tops[mb_x + 1][0][:4]
        for k in (1, 2, 3):  # the top-right samples, replicated below
            w[tr + 4 * k * BPS:tr + 4 * k * BPS + 4] = w[tr:tr + 4]
        for n in range(16):
            d = Y_OFF + _SCAN[n]
            _pred4(w, d, modes[n])
            _transform(coeffs[16 * n:16 * n + 16], w, d)
    else:
        mode = modes[0]
        if mode == B_DC:
            mode = (6 if mb_y == 0 else 5) if mb_x == 0 else (4 if mb_y == 0 else B_DC)
        _pred_block(w, Y_OFF, 16, mode)
        for n in range(16):
            _transform(coeffs[16 * n:16 * n + 16], w, Y_OFF + _SCAN[n])
    mode = uvmode
    if mode == B_DC:
        mode = (6 if mb_y == 0 else 5) if mb_x == 0 else (4 if mb_y == 0 else B_DC)
    _pred_block(w, U_OFF, 8, mode)
    _pred_block(w, V_OFF, 8, mode)
    for n in range(4):
        d = (n & 1) * 4 + (n >> 1) * 4 * BPS
        _transform(coeffs[(16 + n) * 16:(17 + n) * 16], w, U_OFF + d)
        _transform(coeffs[(20 + n) * 16:(21 + n) * 16], w, V_OFF + d)


def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _clip1(v):
    return np.clip(v, 0, 255)


def _edge(plane: np.ndarray, vertical: bool, r0: int, c0: int, n: int, pos: int):
    """The 8 samples across one edge at each of ``n`` places: columns
    ``pos - 4 .. pos + 3`` of rows ``r0 ..`` (a vertical edge) or rows
    ``pos - 4 .. pos + 3`` of columns ``c0 ..`` (a horizontal one), as
    int64 [8, n], and the index to write them back."""
    if vertical:
        idx = (slice(r0, r0 + n), slice(pos - 4, pos + 4))
        return plane[idx].astype(np.int64).T, idx
    idx = (slice(pos - 4, pos + 4), slice(c0, c0 + n))
    return plane[idx].astype(np.int64), idx


def _put(plane, idx, px, vertical):
    plane[idx] = (px.T if vertical else px).astype(np.uint8)


def _filter2(px, mask):
    p1, p0, q0, q1 = px[2], px[3], px[4], px[5]
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    px[3] = np.where(mask, _clip1(p0 + a2), p0)
    px[4] = np.where(mask, _clip1(q0 - a1), q0)


def _filter4(px, mask):
    p1, p0, q0, q1 = px[2], px[3], px[4], px[5]
    a = 3 * (q0 - p0)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    px[2] = np.where(mask, _clip1(p1 + a3), p1)
    px[3] = np.where(mask, _clip1(p0 + a2), p0)
    px[4] = np.where(mask, _clip1(q0 - a1), q0)
    px[5] = np.where(mask, _clip1(q1 - a3), q1)


def _filter6(px, mask):
    p2, p1, p0, q0, q1, q2 = px[1], px[2], px[3], px[4], px[5], px[6]
    a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    a1 = (27 * a + 63) >> 7
    a2 = (18 * a + 63) >> 7
    a3 = (9 * a + 63) >> 7
    px[1] = np.where(mask, _clip1(p2 + a3), p2)
    px[2] = np.where(mask, _clip1(p1 + a2), p1)
    px[3] = np.where(mask, _clip1(p0 + a1), p0)
    px[4] = np.where(mask, _clip1(q0 - a1), q0)
    px[5] = np.where(mask, _clip1(q1 - a2), q1)
    px[6] = np.where(mask, _clip1(q2 - a3), q2)


def _simple_edge(plane, vertical, r0, c0, pos, thresh):
    px, idx = _edge(plane, vertical, r0, c0, 16, pos)
    mask = 4 * np.abs(px[3] - px[4]) + np.abs(px[2] - px[5]) <= 2 * thresh + 1
    _filter2(px, mask)
    _put(plane, idx, px, vertical)


def _complex_edge(plane, vertical, r0, c0, n, pos, thresh, ithresh, hev_t, mb_edge):
    px, idx = _edge(plane, vertical, r0, c0, n, pos)
    d = np.abs(np.diff(px, axis=0))  # |p3-p2|, |p2-p1|, |p1-p0|, |p0-q0|, |q0-q1|, ...
    mask = (4 * d[3] + np.abs(px[2] - px[5]) <= 2 * thresh + 1)
    mask &= (d[0] <= ithresh) & (d[1] <= ithresh) & (d[2] <= ithresh)
    mask &= (d[4] <= ithresh) & (d[5] <= ithresh) & (d[6] <= ithresh)
    hev = (d[2] > hev_t) | (d[4] > hev_t)
    before = px.copy()
    _filter2(px, mask & hev)
    rest = before
    if mb_edge:
        _filter6(rest, mask & ~hev)
    else:
        _filter4(rest, mask & ~hev)
    px = np.where(hev[None, :], px, rest)
    _put(plane, idx, px, vertical)


def _loop_filter(Y, U, V, mb_w: int, mb_h: int, finfo, filter_type: int) -> None:
    """libwebp's DoFilter for every macroblock in raster order."""
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            limit, ilevel, hev_t, inner = finfo[mb_y][mb_x]
            if limit == 0:
                continue
            y0, x0 = 16 * mb_y, 16 * mb_x
            if filter_type == 1:
                if mb_x > 0:
                    _simple_edge(Y, True, y0, x0, x0, limit + 4)
                if inner:
                    for k in (4, 8, 12):
                        _simple_edge(Y, True, y0, x0, x0 + k, limit)
                if mb_y > 0:
                    _simple_edge(Y, False, y0, x0, y0, limit + 4)
                if inner:
                    for k in (4, 8, 12):
                        _simple_edge(Y, False, y0, x0, y0 + k, limit)
                continue
            u0, v0 = 8 * mb_y, 8 * mb_x
            if mb_x > 0:
                _complex_edge(Y, True, y0, x0, 16, x0, limit + 4, ilevel, hev_t, True)
                for P in (U, V):
                    _complex_edge(P, True, u0, v0, 8, v0, limit + 4, ilevel, hev_t, True)
            if inner:
                for k in (4, 8, 12):
                    _complex_edge(Y, True, y0, x0, 16, x0 + k, limit, ilevel, hev_t, False)
                for P in (U, V):
                    _complex_edge(P, True, u0, v0, 8, v0 + 4, limit, ilevel, hev_t, False)
            if mb_y > 0:
                _complex_edge(Y, False, y0, x0, 16, y0, limit + 4, ilevel, hev_t, True)
                for P in (U, V):
                    _complex_edge(P, False, u0, v0, 8, u0, limit + 4, ilevel, hev_t, True)
            if inner:
                for k in (4, 8, 12):
                    _complex_edge(Y, False, y0, x0, 16, y0 + k, limit, ilevel, hev_t, False)
                for P in (U, V):
                    _complex_edge(P, False, u0, v0, 8, u0 + 4, limit, ilevel, hev_t, False)


def _upsample(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """A chroma plane [(H+1)/2, (W+1)/2] to [H, W] as libwebp's fancy
    upsampler does: each output row from its nearer chroma row ("near")
    and the other neighbour ("far"; the same row at the top and, for an
    even height, the bottom), 9-3-3-1 between the two columns about it."""
    c = plane.astype(np.int64)
    rows = np.arange(height)
    near = rows // 2
    far = np.where(rows % 2 == 1, near + 1, near - 1)
    far = np.clip(far, 0, c.shape[0] - 1)
    N, F = c[near], c[far]
    out = np.empty((height, width), np.int64)
    out[:, 0] = (3 * N[:, 0] + F[:, 0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        n0, n1, f0, f1 = N[:, :pairs], N[:, 1:pairs + 1], F[:, :pairs], F[:, 1:pairs + 1]
        d12 = (n0 + 3 * n1 + 3 * f0 + f1 + 8) >> 3
        d03 = (3 * n0 + n1 + f0 + 3 * f1 + 8) >> 3
        out[:, 1:2 * pairs:2] = (d12 + n0) >> 1
        out[:, 2:2 * pairs + 1:2] = (d03 + n1) >> 1
    if not width & 1:
        out[:, width - 1] = (3 * N[:, pairs] + F[:, pairs] + 2) >> 2
    return out


def _yuv_to_rgb(y, u, v) -> np.ndarray:
    """libwebp's VP8YUVToR/G/B (14-bit fixed point, 6 fractional bits)."""
    def mult_hi(x, c):
        return (x * c) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    yy = mult_hi(y, 19077)
    r = clip8(yy + mult_hi(v, 26149) - 14234)
    g = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(yy + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _vp8(data: bytes) -> np.ndarray:
    """A VP8 key frame as RGB ``uint8 [H, W, 3]``."""
    width, height, part0 = _parse_header(data)
    br = _Bool(data, 10, 10 + part0)
    hd = _frame_header(br, data, 10 + part0)
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    strengths = _filter_strengths(hd) if hd.filter_type else None
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.uint8)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    V = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    finfo = [[None] * mb_w for _ in range(mb_h)]
    intra_top = [B_DC] * (4 * mb_w)
    nz = {"top": [[0, 0] for _ in range(mb_w)]}
    tops = [None] * mb_w  # the unfiltered bottom rows of the row above
    w = [0] * (BPS * 17 + BPS * 9)
    for mb_y in range(mb_h):
        token_br = hd.parts[mb_y & (len(hd.parts) - 1)]
        left_modes = [B_DC] * 4
        nz["left"] = [0, 0]
        # the left border (129) and the top-left sample
        for j in range(16):
            w[Y_OFF + j * BPS - 1] = 129
        for j in range(8):
            w[U_OFF + j * BPS - 1] = 129
            w[V_OFF + j * BPS - 1] = 129
        if mb_y > 0:
            w[Y_OFF - BPS - 1] = w[U_OFF - BPS - 1] = w[V_OFF - BPS - 1] = 129
        else:
            w[Y_OFF - BPS - 1:Y_OFF - BPS + 20] = [127] * 21
            w[U_OFF - BPS - 1:U_OFF - BPS + 8] = [127] * 9
            w[V_OFF - BPS - 1:V_OFF - BPS + 8] = [127] * 9
        row_tops = [None] * mb_w
        for mb_x in range(mb_w):
            mb = _intra_modes(br, hd, intra_top[4 * mb_x:4 * mb_x + 4], left_modes)
            seg, skip, i4x4, modes, uvmode = mb
            if i4x4:
                intra_top[4 * mb_x:4 * mb_x + 4] = modes[12:16]
            else:
                intra_top[4 * mb_x:4 * mb_x + 4] = [modes[0]] * 4
            coeffs = [0] * 384
            if not skip:
                skip = _residuals(token_br, hd, hd.dq[seg], i4x4, nz, mb_x, coeffs)
            else:
                nz["top"][mb_x][0] = nz["left"][0] = 0
                if not i4x4:
                    nz["top"][mb_x][1] = nz["left"][1] = 0
            if strengths is not None:
                limit, ilevel, hev_t, inner = strengths[seg][int(i4x4)]
                finfo[mb_y][mb_x] = (limit, ilevel, hev_t, inner or not skip)
            if mb_x > 0:  # rotate the left samples in from the previous block
                for j in range(-1, 16):
                    r = Y_OFF + j * BPS
                    w[r - 4:r] = w[r + 12:r + 16]
                for j in range(-1, 8):
                    for off in (U_OFF, V_OFF):
                        r = off + j * BPS
                        w[r - 4:r] = w[r + 4:r + 8]
            _reconstruct(w, mb, mb_x, mb_y, mb_w, tops, coeffs)
            row_tops[mb_x] = (w[Y_OFF + 15 * BPS:Y_OFF + 15 * BPS + 16],
                              w[U_OFF + 7 * BPS:U_OFF + 7 * BPS + 8],
                              w[V_OFF + 7 * BPS:V_OFF + 7 * BPS + 8])
            y0, x0 = 16 * mb_y, 16 * mb_x
            Y[y0:y0 + 16, x0:x0 + 16] = np.array(
                [w[Y_OFF + j * BPS:Y_OFF + j * BPS + 16] for j in range(16)], np.uint8)
            U[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = np.array(
                [w[U_OFF + j * BPS:U_OFF + j * BPS + 8] for j in range(8)], np.uint8)
            V[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = np.array(
                [w[V_OFF + j * BPS:V_OFF + j * BPS + 8] for j in range(8)], np.uint8)
        tops = row_tops
    if hd.filter_type:
        _loop_filter(Y, U, V, mb_w, mb_h, finfo, hd.filter_type)
    cw, ch = (width + 1) // 2, (height + 1) // 2
    u = _upsample(U[:ch, :cw], height, width)
    v = _upsample(V[:ch, :cw], height, width)
    return _yuv_to_rgb(Y[:height, :width].astype(np.int64), u, v)
