"""GIF, BMP and TIFF decoders without PIL, each giving what PIL 12.1's
``Image.open(path).convert("RGB")`` gives, bit for bit (the JAX package
reads every image so, JAX ``data/loaders.py:41``). ``data/image_io.py``'s
``read_image`` chooses them by the file's header.

- GIF: the first frame. LZW with clear and end codes, interlaced rows, the
  global or the frame's own palette (no palette: the index is the grey
  level), a frame smaller than the logical screen at an offset (the screen
  grows to hold a frame that overhangs it). Outside the frame PIL leaves
  index 0, or the transparency index where the frame has one; the
  transparency itself is dropped. A stream that ends before the frame is
  whole (cut short, or at an early end code) raises, as PIL raises.
- BMP: ``BITMAPCOREHEADER`` and the ``BITMAPINFOHEADER`` family (40, 52,
  56, 64, 108, 124 bytes); 1, 4 and 8-bit palettes (an index past the
  palette is black), 16-bit 555 and, by ``BI_BITFIELDS``, 565 (a 5-bit
  channel scaled ``v * 255 // 31``, a 6-bit one ``v * 255 // 63``), 24 and
  32 bits (the fourth byte ignored, or the channel masks PIL takes);
  RLE8 and RLE4 as PIL's own decoder reads them (its delta escape skips
  two more bytes, and absolute runs realign on the file offset's parity);
  rows bottom-up or top-down.
- TIFF: baseline, little- and big-endian, the first image; strips or
  tiles, chunky or planar; uncompressed, PackBits, LZW (and the pre-6.0
  bit order libtiff still reads), Adobe and old Deflate; the horizontal
  predictor under LZW and Deflate (libtiff applies it to nothing else);
  1-bit and 8-bit grey, min-is-white or min-is-black, 16-bit grey (PIL's
  ``I;16``: clipped at 255; min-is-white ignored little-endian, refused
  big-endian, as PIL refuses it), 8-bit RGB and RGB with
  an extra sample (unassociated alpha or none dropped, associated alpha
  divided out as PIL does; planar only with unassociated alpha, the one
  planar layout PIL reads right), 8-bit palette (a 16-bit colormap's high
  byte), 8-bit CMYK. Anything else raises ``NotImplementedError`` naming
  it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np


class TruncatedImageError(OSError):
    """The file ends before its image does (PIL: "image file is truncated")."""


# --- LZW ---------------------------------------------------------------------

def _lzw_decode(data: bytes, min_size: int, msb: bool, early: int, limit: int
                ) -> Tuple[bytes, bool]:
    """Up to ``limit`` bytes of an LZW stream with clear code ``1 <<
    min_size`` and end code one more: the bits MSB- or LSB-first, the code
    width growing when the next free code reaches ``(1 << width) - early``.
    Returns the bytes and whether the end code was read."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(clear)] + [b"", b""]
    size, prev = min_size + 1, None
    acc = nbits = pos = 0
    n = len(data)
    while len(out) < limit:
        while nbits < size:
            if pos >= n:
                return bytes(out), False
            if msb:
                acc = (acc << 8) | data[pos]
            else:
                acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        if msb:
            nbits -= size
            code = (acc >> nbits) & ((1 << size) - 1)
            acc &= (1 << nbits) - 1
        else:
            code = acc & ((1 << size) - 1)
            acc >>= size
            nbits -= size
        if code == clear:
            del table[clear + 2:]
            size, prev = min_size + 1, None
            continue
        if code == end:
            return bytes(out), True
        if prev is None:
            if code >= len(table):
                raise ValueError(f"LZW: code {code} after a clear")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                new = prev + entry[:1]
            elif code == len(table):
                entry = new = prev + prev[:1]
            else:
                raise ValueError(f"LZW: code {code} past the table's {len(table)}")
            if len(table) < 4096:
                table.append(new)
        out += entry
        prev = entry
        if len(table) + early >= (1 << size) and size < 12:
            size += 1
    return bytes(out[:limit]), False


# --- GIF ---------------------------------------------------------------------

def _sub_blocks(data: bytes, pos: int) -> Tuple[bytes, int, bool]:
    """The data of the sub-blocks at ``pos``, the position after them and
    whether their terminator was reached."""
    parts = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos, True
        parts.append(data[pos:pos + n])
        pos += n
    return b"".join(parts), pos, False


def decode_gif(data: bytes) -> np.ndarray:
    """The first frame of a GIF as RGB ``uint8 [H, W, 3]``."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF")
    sw, sh = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos, palette = 13, None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        palette = data[pos:pos + n]
        pos += n
    transparency = None
    while True:
        if pos >= len(data):
            raise TruncatedImageError("GIF truncated before its first image")
        if data[pos] == 0x3B:
            raise ValueError("GIF without an image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:
            if pos >= len(data):
                raise TruncatedImageError("GIF truncated in an extension")
            label = data[pos]
            first = data[pos + 2:pos + 2 + data[pos + 1]] if pos + 1 < len(data) else b""
            _, pos, _ = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(first) >= 4 and first[0] & 1:
                transparency = first[3]
        elif kind == 0x2C:
            break
        # PIL skips any other byte between blocks
    if pos + 10 > len(data):
        raise TruncatedImageError("GIF truncated in its image descriptor")
    x0, y0, w, h = struct.unpack_from("<HHHH", data, pos)
    iflags = data[pos + 8]
    pos += 9
    if iflags & 0x80:
        n = 3 << ((iflags & 7) + 1)
        palette = data[pos:pos + n]
        pos += n
    if pos >= len(data):
        raise TruncatedImageError("GIF truncated before its image data")
    min_size = data[pos]
    if not 1 <= min_size <= 11:
        raise ValueError(f"GIF LZW code size {min_size}")
    stream, _, _ = _sub_blocks(data, pos + 1)
    pixels, _ = _lzw_decode(stream, min_size, msb=False, early=0, limit=w * h)
    if len(pixels) < w * h:  # PIL raises here, whether or not an end code came first
        raise TruncatedImageError("GIF image data ends before its last pixel")
    frame = np.zeros(w * h, np.uint8)
    frame[:len(pixels)] = np.frombuffer(pixels, np.uint8)
    frame = frame.reshape(h, w)
    if iflags & 0x40:  # interlaced: rows arrive in four passes
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        rows = np.empty_like(frame)
        rows[order] = frame
        frame = rows
    H, W = max(sh, y0 + h), max(sw, x0 + w)
    canvas = np.full((H, W), transparency or 0, np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = frame
    if palette is None:
        return np.repeat(canvas[..., None], 3, axis=2)
    lut = np.zeros((256, 3), np.uint8)
    entries = np.frombuffer(palette, np.uint8)[:768].reshape(-1, 3)
    lut[:len(entries)] = entries
    return lut[canvas]


# --- BMP ---------------------------------------------------------------------

_BMP_INFO_SIZES = (40, 52, 56, 64, 108, 124)
_BMP_MASKS = {  # the channel masks PIL takes (BmpImagePlugin's SUPPORTED)
    32: [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)],
    24: [(0xFF0000, 0xFF00, 0xFF)],
    16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)],
}
_BMP_COMPRESSIONS = {0: "uncompressed", 1: "RLE8", 2: "RLE4", 3: "BI_BITFIELDS",
                     4: "JPEG", 5: "PNG", 6: "BI_ALPHABITFIELDS"}


def _bmp_header(data: bytes) -> Dict[str, object]:
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError("not a BMP")
    offset, size = struct.unpack_from("<II", data, 10)
    hd = data[18:14 + size]
    if len(hd) < size - 4:
        raise TruncatedImageError("BMP truncated in its header")
    at = 14 + size
    info: Dict[str, object] = {"header": size, "direction": -1}
    if size == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", hd, 0)
        comp, colors, pad = 0, 0, 3
    elif size in _BMP_INFO_SIZES:
        flip = hd[7] == 0xFF
        info["direction"] = 1 if flip else -1
        w, h = struct.unpack_from("<II", hd, 0)
        if flip:
            h = 2 ** 32 - h
        bits, comp = struct.unpack_from("<HI", hd, 10)
        (colors,) = struct.unpack_from("<I", hd, 28)
        pad = 4
        if comp == 3:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = struct.unpack_from(f"<{n}I", hd, 36)
            else:
                masks = struct.unpack_from("<3I", data, at)
                at += 12
            info["masks"] = tuple(masks) + (0,) * (4 - len(masks))
    else:
        raise NotImplementedError(f"a BMP with a {size}-byte header")
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    info.update(width=w, height=h, bits=bits, compression=comp, colors=colors, offset=offset,
                palette_at=at, palette_pad=pad)
    return info


def bmp_format(data: bytes) -> str:
    try:
        i = _bmp_header(data)
    except (ValueError, NotImplementedError, struct.error) as e:
        return f"a BMP ({e})"
    comp = _BMP_COMPRESSIONS.get(i["compression"], f"compression {i['compression']}")
    return f"a {i['bits']}-bit {comp} BMP with a {i['header']}-byte header"


def _bmp_rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """PIL's ``BmpRleDecoder``, step for step: the indices in file order
    (bottom row first), which may run short or long."""
    out = bytearray()
    x, total, n = 0, w * h, len(data)
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            if len(out) % w:
                out += bytes(w - len(out) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            # PIL reads the delta's two bytes, then two more, which it uses
            if pos + 2 > n:
                break
            pos += 2
            right, up = data[pos:pos + 2] if pos + 2 <= n else (0, 0)
            pos = min(pos + 2, n)
            out += bytes(right + up * w)
            x = len(out) % w
        else:
            if rle4:
                count = byte // 2
                chunk = data[pos:pos + count]
                for b in chunk:
                    out += bytes((b >> 4, b & 15))
            else:
                count = byte
                chunk = data[pos:pos + count]
                out += chunk
            pos += len(chunk)
            if len(chunk) < count:
                break
            x += byte
            if pos % 2:  # the file offset realigns to a word
                pos += 1
    return bytes(out)


def decode_bmp(data: bytes) -> np.ndarray:
    """A BMP as RGB ``uint8 [H, W, 3]``."""
    i = _bmp_header(data)
    w, h, bits, comp = i["width"], i["height"], i["bits"], i["compression"]
    if bits not in (1, 4, 8, 16, 24, 32):
        raise NotImplementedError(f"a {bits}-bit BMP")
    if comp not in (0, 1, 2, 3):
        raise NotImplementedError(f"a BMP with {_BMP_COMPRESSIONS.get(comp, comp)} compression")
    masks = i.get("masks")
    if comp == 3:
        ok = masks if bits == 32 else masks[:3]
        if bits not in _BMP_MASKS or ok not in _BMP_MASKS[bits]:
            raise NotImplementedError(f"a {bits}-bit BMP with channel masks {ok}")
    offset = i["offset"]
    top_down = i["direction"] == 1
    lut = None
    if bits <= 8:
        pad, at = i["palette_pad"], i["palette_at"]
        raw = np.frombuffer(data[at:at + pad * i["colors"]], np.uint8)
        pal = raw[:len(raw) // pad * pad].reshape(-1, pad)[:256, 2::-1]
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(pal)] = pal
    if comp in (1, 2):
        idx = _bmp_rle(data, offset, w, h, rle4=comp == 2)
        if len(idx) < w * h:
            raise TruncatedImageError("BMP RLE data ends before its last pixel")
        img = np.frombuffer(idx[:w * h], np.uint8).reshape(h, w)
        img = img if top_down else img[::-1]
        return lut[img]
    stride = ((w * bits + 31) >> 3) & ~3
    body = data[offset:offset + stride * h]
    if len(body) < stride * h:
        raise TruncatedImageError("BMP pixel data ends before its last row")
    rows = np.frombuffer(body, np.uint8).reshape(h, stride)
    rows = rows if top_down else rows[::-1]
    if bits <= 8:
        if bits == 8:
            idx = rows
        elif bits == 4:
            idx = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)
        else:
            idx = np.unpackbits(rows, axis=1)
        return lut[idx[:, :w]]
    if bits == 24:
        return np.ascontiguousarray(rows[:, :w * 3].reshape(h, w, 3)[..., ::-1])
    width = bits // 8
    v = rows[:, :w * width].reshape(h, w, width).astype(np.uint32)
    v = sum(v[..., k] << (8 * k) for k in range(width))
    if bits == 16:
        rm, gm, bm = masks[:3] if masks else (0x7C00, 0x3E0, 0x1F)
        out = []
        for m in (rm, gm, bm):  # PIL's BGR;15 and BGR;16: v * 255 // (2^bits - 1)
            shift = (m & -m).bit_length() - 1
            out.append(((v & m) >> shift) * 255 // (m >> shift))
        return np.stack(out, -1).astype(np.uint8)
    if not masks or masks == (0, 0, 0, 0):  # BGRX, or BGRA read as such
        masks = (0xFF0000, 0xFF00, 0xFF, 0)
    return np.stack([(v & m) >> ((m & -m).bit_length() - 1) for m in masks[:3]],
                    -1).astype(np.uint8)


# --- TIFF --------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i",
               10: "ii", 11: "f", 12: "d"}
_TIFF_COMPRESSIONS = {1: "uncompressed", 2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4",
                      5: "LZW", 6: "old-style JPEG", 7: "JPEG", 8: "Adobe Deflate",
                      32773: "PackBits", 32946: "Deflate", 34712: "JPEG 2000",
                      34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
_TIFF_PHOTOMETRIC = {0: "min-is-white", 1: "min-is-black", 2: "RGB", 3: "palette",
                     4: "transparency mask", 5: "CMYK", 6: "YCbCr", 8: "CIELab"}


def _tiff_tags(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    if data[:4] == b"II*\0":
        e = "<"
    elif data[:4] == b"MM\0*":
        e = ">"
    elif data[:4] in (b"II+\0", b"MM\0+"):
        raise NotImplementedError("a BigTIFF")
    else:
        raise ValueError("not a TIFF")
    (ifd,) = struct.unpack_from(e + "I", data, 4)
    if ifd + 2 > len(data):
        raise TruncatedImageError("TIFF truncated before its first directory")
    (n,) = struct.unpack_from(e + "H", data, ifd)
    tags: Dict[int, tuple] = {}
    for k in range(n):
        at = ifd + 2 + 12 * k
        if at + 12 > len(data):
            raise TruncatedImageError("TIFF truncated in its directory")
        tag, kind, count = struct.unpack_from(e + "HHI", data, at)
        fmt = _TIFF_TYPES.get(kind)
        if fmt is None:
            continue
        size = struct.calcsize(e + fmt) * count
        where = at + 8 if size <= 4 else struct.unpack_from(e + "I", data, at + 8)[0]
        if where + size > len(data):
            raise TruncatedImageError(f"TIFF truncated in tag {tag}")
        tags[tag] = struct.unpack_from(e + fmt * count, data, where)
    return e, tags


def tiff_format(data: bytes) -> str:
    try:
        _, t = _tiff_tags(data)
    except (ValueError, NotImplementedError, struct.error) as err:
        return f"a TIFF ({err})"
    comp = t.get(259, (1,))[0]
    photo = t.get(262, (None,))[0]
    bits = t.get(258, (1,))
    return (f"a {_TIFF_COMPRESSIONS.get(comp, f'compression-{comp}')} "
            f"{_TIFF_PHOTOMETRIC.get(photo, f'photometric-{photo}')} TIFF of "
            f"{len(bits)} x {bits[0]}-bit samples")


def _packbits_decode(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += data[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def _tiff_chunk(raw: bytes, comp: int, size: int) -> bytes:
    if comp == 1:
        return raw[:size]
    if comp == 32773:
        return _packbits_decode(raw)[:size]
    if comp == 5:
        old = len(raw) >= 2 and raw[0] == 0 and raw[1] & 1
        return _lzw_decode(raw, 8, msb=not old, early=0 if old else 1, limit=size)[0]
    return zlib.decompressobj().decompress(raw, size)


def decode_tiff(data: bytes) -> np.ndarray:
    """The first image of a baseline TIFF as RGB ``uint8 [H, W, 3]``."""
    e, t = _tiff_tags(data)

    def one(tag, default=None):
        v = t.get(tag)
        return v[0] if v else default
    w, h = one(256), one(257)
    if w is None or h is None:
        raise ValueError("TIFF without ImageWidth/ImageLength")
    comp, photo = one(259, 1), one(262)
    spp = one(277, 1)
    bits = t.get(258, (1,) * spp)
    planar = one(284, 1)
    predictor = one(317, 1)
    fmt = set(t.get(339, (1,)))
    name = tiff_format(data)
    if comp not in (1, 5, 8, 32773, 32946):
        raise NotImplementedError(f"{name}: {_TIFF_COMPRESSIONS.get(comp, comp)} compression")
    if fmt != {1}:
        raise NotImplementedError(f"{name}: sample format {sorted(fmt)} (only unsigned "
                                  "integers are decoded)")
    if one(266, 1) != 1:
        raise NotImplementedError(f"{name}: fill order 2")
    if len(set(bits)) != 1:
        raise NotImplementedError(f"{name}: mixed sample widths {bits}")
    b = bits[0]
    extra = one(338)
    layout = {(0, 1, 1): "1", (1, 1, 1): "1", (0, 1, 8): "L", (1, 1, 8): "L",
              (0, 1, 16): "I16", (1, 1, 16): "I16", (2, 3, 8): "RGB", (2, 4, 8): "RGBA",
              (3, 1, 8): "P", (5, 4, 8): "CMYK"}.get((photo, spp, b))
    if layout is None:
        raise NotImplementedError(f"{name}: {spp} sample(s) of {b} bits, photometric "
                                  f"{_TIFF_PHOTOMETRIC.get(photo, photo)}")
    if layout == "I16" and photo == 0 and e == ">":
        raise NotImplementedError(f"{name}: big-endian 16-bit min-is-white (PIL does not "
                                  "open it either)")
    if layout == "RGBA" and planar == 2 and extra != 2:
        # PIL raises on these (extra sample 0 or 1) or reads them wrongly
        # (no ExtraSamples tag: libtiff and its raw tile reader misplace planes)
        raise NotImplementedError(f"{name}: planar RGB with extra sample {extra} (only "
                                  "unassociated alpha is read planar)")
    if predictor not in (1, 2) or (predictor == 2 and b == 1 and comp in (5, 8, 32946)):
        raise NotImplementedError(f"{name}: predictor {predictor}")
    per_pixel = spp if planar == 1 else 1
    tiled = 322 in t
    if tiled:
        cw, ch = one(322), one(323)
        offsets, counts = t.get(324), t.get(325)
    else:
        cw, ch = w, min(one(278, 2 ** 32 - 1), h)
        offsets, counts = t.get(273), t.get(279)
    if offsets is None or counts is None:
        raise ValueError(f"{name}: no strip or tile offsets")
    dtype = np.dtype(e + "u2") if b == 16 else np.uint8
    row_bytes = (cw * per_pixel * b + 7) // 8
    across, down = -(-w // cw), -(-h // ch)
    planes = spp if planar == 2 else 1
    if len(offsets) < across * down * planes:
        raise ValueError(f"{name}: {len(offsets)} chunks for {across * down * planes}")
    img = np.zeros((h, w, spp), np.int64)
    k = 0
    for p in range(planes):
        for cy in range(down):
            for cx in range(across):
                rows = ch if tiled else min(ch, h - cy * ch)
                raw = data[offsets[k]:offsets[k] + counts[k]]
                k += 1
                buf = _tiff_chunk(raw, comp, row_bytes * rows)
                if len(buf) < row_bytes * rows:
                    raise TruncatedImageError(f"{name}: a chunk decodes short")
                block = np.frombuffer(buf, np.uint8).reshape(rows, row_bytes)
                if b == 1:
                    vals = np.unpackbits(block, axis=1)[:, :cw].astype(np.int64)
                else:
                    vals = block.view(dtype).astype(np.int64)
                vals = vals.reshape(rows, cw, per_pixel)
                if predictor == 2 and comp in (5, 8, 32946):
                    vals = np.cumsum(vals, axis=1) % (1 << b)
                y0, x0 = cy * ch, cx * cw
                part = vals[:min(rows, h - y0), :min(cw, w - x0)]
                sl = slice(p, p + 1) if planar == 2 else slice(None)
                img[y0:y0 + part.shape[0], x0:x0 + part.shape[1], sl] = part
    if layout == "1":
        grey = img[..., 0] * 255 if photo == 1 else (1 - img[..., 0]) * 255
    elif layout == "L":
        grey = img[..., 0] if photo == 1 else 255 - img[..., 0]
    elif layout == "I16":
        grey = np.minimum(img[..., 0], 255)
    else:
        grey = None
    if grey is not None:
        return np.repeat(grey.astype(np.uint8)[..., None], 3, axis=2)
    if layout == "P":
        cmap = t.get(320)
        if cmap is None or len(cmap) < 3 * 256:
            raise ValueError(f"{name}: a palette image without a 256-entry colormap")
        lut = (np.asarray(cmap, np.int64).reshape(3, -1).T[:256] // 256).astype(np.uint8)
        return lut[img[..., 0]]
    if layout == "CMYK":
        from .image_io import _cmyk_to_rgb

        return _cmyk_to_rgb(*(255 - img[..., c] for c in range(4)), ycck=False)
    if layout == "RGBA" and extra == 1:  # associated alpha: PIL divides it out
        a = img[..., 3:]
        rgb = np.where(a == 0, 0, np.minimum(img[..., :3] * 255 // np.maximum(a, 1), 255))
        return rgb.astype(np.uint8)
    return img[..., :3].astype(np.uint8)


def codec_format(data: bytes) -> Optional[str]:
    """The variant of a GIF, BMP or TIFF file in words, else None."""
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "a GIF"
    if data[:2] == b"BM":
        return bmp_format(data)
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return tiff_format(data)
    return None


def decode_codec(data: bytes) -> Optional[np.ndarray]:
    """A GIF, BMP or TIFF file's pixels, chosen by the header; None for any
    other header."""
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return decode_tiff(data)
    return None
