"""Writes the committed parquet and image fixtures that the port's readers
are held against where neither pyarrow nor PIL is installed, and their
digests. Run from the repository root with pyarrow and PIL installed:

    python tests/fixtures/make_m2kr_parquet.py

It writes, under ``tests/fixtures/``:

- ``m2kr_snapshot/``: M2KR's layout on the hub, a ``README.md`` whose YAML
  front matter lists ``dataset_info`` and ``configs`` (``EVQA_data``,
  ``EVQA_passages``), the questions in ``EVQA_data/{split}-0000i-of-0000N.parquet``
  (1,024 train in two shards, 256 valid, 256 test) and 8,192 passages in
  ``EVQA_passages/{split}_passages-00000-of-00001.parquet`` (4,096 train,
  2,048 valid, 2,048 test), written by pyarrow with its defaults (snappy,
  dictionary pages, data page v1);
- ``parquet_variants/``: one small table of every column type the reader
  takes, once per codec (none, snappy, gzip, zstd, lz4 = LZ4_RAW),
  dictionary on and off, data page version 1.0 and 2.0, in row groups of
  50 rows and 1 KB pages; the same table in two sets of the delta and
  byte-stream-split encodings (``ENCODING_SETS``) and a FIXED_LEN_BYTE_ARRAY
  table by DELTA_BYTE_ARRAY and BYTE_STREAM_SPLIT, on pages v1 and v2;
  hand-made files in parquet's LZ4 codec (Hadoop's framing, and one raw
  block) and the refused BROTLI, LZO and INT96 files (``refused_*``, no
  digest);
- ``m2kr_snapshot_v2/``: the snapshot's rows re-encoded (the passages in
  ZSTD, the questions in LZ4_RAW, DELTA_BYTE_ARRAY and
  DELTA_LENGTH_BYTE_ARRAY, data pages v2);
- ``webp_images/``: WebP files (:func:`webp_cases`: lossy at several
  qualities and methods and with the simple or normal loop filter at
  several sharpnesses, lossless with every transform, alpha, animations)
  and ``m2kr_images_webp/``: each M2KR image re-encoded as WebP under its
  own name;
- ``m2kr_images/``: the images the questions name, in the formats the port
  decodes without PIL: progressive JPEGs (4:4:4, 4:2:2, 4:2:0, grey,
  optimised Huffman tables, restart markers, odd sizes), progressive files
  whose refinement or AC scans were cut (block smoothing), CMYK and YCCK,
  sequential and progressive, and PNGs (Adam7, 1/2/4/16 bits, grey, palette,
  grey+alpha, RGB, RGBA, ``tRNS``);
- ``codec_images/``: GIFs (interlaced, a frame at an offset with a local
  palette and a transparency index, no palette, LZW tables that fill and
  clear), BMPs (1/4/8-bit, core header, top-down, RLE8/RLE4 with and
  without a delta escape, 16-bit 555 and 565, 24 and 32 bits) and TIFFs
  (little- and big-endian, strips and tiles, raw, PackBits, LZW old and
  new, Adobe and old Deflate, the predictor, planar, RGBA, grey 1/8/16
  bits, palette, CMYK), written by :func:`gif_bytes`, :func:`bmp_bytes`
  and :func:`tiff_bytes`;
- ``image_column/images.parquet``: an ``Image`` column written by
  ``datasets`` (the bytes of some of those files, a PNG and a JPEG);
- ``unigram_tokenizer/``: a T5-style Unigram ``tokenizer.json`` directory
  written by the port's ``write_unigram_tokenizer``;
- ``digests.json``: the SHA-256 of each parquet file's rows as
  ``pyarrow.parquet.read_table(path).to_pylist()`` gives them
  (:func:`rows_digest`), of each image's pixels as PIL's
  ``Image.open(path).convert("RGB")`` gives them (:func:`pixels_digest`),
  of the image column as ``datasets.Image().decode_example`` gives it
  (:func:`images_digest`), of the ``tokenizers`` library's ids and
  decoded strings of :data:`TOKENIZER_TEXTS`, and of the WebP files'
  pixels as PIL decodes them.

The digest functions import neither pyarrow nor PIL, so that a reader can
be held against them where those are absent.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(HERE, "m2kr_snapshot")
VARIANTS = os.path.join(HERE, "parquet_variants")
IMAGES = os.path.join(HERE, "m2kr_images")
DIGESTS = os.path.join(HERE, "digests.json")
CODECS = os.path.join(HERE, "codec_images")
IMAGE_COLUMN = os.path.join(HERE, "image_column", "images.parquet")
TOKENIZER = os.path.join(HERE, "unigram_tokenizer")
WEBP = os.path.join(HERE, "webp_images")
SNAPSHOT_V2 = os.path.join(HERE, "m2kr_snapshot_v2")
IMAGES_WEBP = os.path.join(HERE, "m2kr_images_webp")
TOKENIZER_TEXTS = ["a photo of", "a photo of the cat on the mat", "ａ ｐｈｏｔｏ  of\tthe　sun",
                   "café é ñ", "東京 가각 xyz", "<extra_id_0> kato lomi </s> cat",
                   "the cat on the mat " * 5, "", "zz ẞ ◆"]
SEED = 0
QUESTIONS = {"train": 1024, "valid": 256, "test": 256}
TRAIN_SHARDS = 2
PASSAGES = {"train_passages": 4096, "valid_passages": 2048, "test_passages": 2048}
INSTRUCTIONS = ["Answer the following question with the image:",
                "Using the image, find the passage that answers the question:",
                "Retrieve the document that answers this question about the picture."]


def _bytes_as_hex(obj):
    """JSON for what json cannot write: bytes as hex; a date, time or
    datetime as its ISO text, with the nanoseconds beyond its microseconds
    where it carries them (a ``pandas.Timestamp``, or the port's
    ``data/temporal.py::Timestamp``)."""
    import datetime

    if isinstance(obj, bytes):
        return {"bytes": obj.hex()}
    if isinstance(obj, (datetime.date, datetime.time)):
        ns = getattr(obj, "nanosecond", None)
        if hasattr(obj, "to_pydatetime"):  # pandas
            obj = obj.to_pydatetime(warn=False)
        return {"iso": datetime.datetime.isoformat(obj) if isinstance(obj, datetime.datetime)
                else obj.isoformat(), "ns": ns}
    raise TypeError(type(obj).__name__)


def rows_digest(rows) -> str:
    """SHA-256 of a table's rows (a list of dicts) as canonical JSON: keys
    sorted, floats in their shortest round-trip form, bytes as hex, dates,
    times and timestamps as ISO text with their nanoseconds."""
    text = json.dumps(rows, sort_keys=True, ensure_ascii=False, default=_bytes_as_hex)
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def pixels_digest(rgb: np.ndarray) -> str:
    """SHA-256 of an RGB ``uint8 [H, W, 3]`` image with its shape."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    return hashlib.sha256(f"{rgb.shape}".encode() + rgb.tobytes()).hexdigest()


def words(n):
    """``n`` distinct lower-case pseudo-words."""
    syll = ["ka", "lo", "mi", "ne", "ru", "sa", "ti", "vo", "ze", "po", "da", "fu", "gi", "ho"]
    out = []
    for i in range(n):
        w, j = "", i
        while True:
            w += syll[j % len(syll)]
            j //= len(syll)
            if not j:
                break
        out.append(w + "x")
    return out


# ------------------------------------------------------------------ images
def _photo(rng, h, w):
    """Gradients, an edge and noise: every DCT frequency gets energy."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    ((xx + yy) * 3) % 256], -1).astype(np.float64)
    img[:, w // 2:] = 255 - img[:, w // 2:]
    img += rng.normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg(img, mode="RGB", **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cut_scans(data: bytes, keep) -> bytes:
    """A progressive JPEG without the scans for which ``keep(ss, se, ah,
    al)`` is false (their SOS segment and entropy-coded data); EOI kept."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            out += data[pos:]
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        end = pos + 2 + length
        if marker == 0xDA:
            ns = data[pos + 4]
            ss, se, ahl = data[pos + 5 + 2 * ns:pos + 8 + 2 * ns]
            j = end
            while True:  # the entropy-coded data runs to the next non-RST marker
                j = data.index(b"\xff", j)
                if data[j + 1] == 0 or 0xD0 <= data[j + 1] <= 0xD7:
                    j += 2
                    continue
                break
            if keep(ss, se, ahl >> 4, ahl & 15):
                out += data[pos:j]
            pos = j
            continue
        out += data[pos:end]
        pos = end
    return bytes(out)


def as_ycck(data: bytes) -> bytes:
    """A CMYK JPEG with its Adobe transform flag set to 2 (YCCK): the same
    samples, decoded through libjpeg's YCCK -> CMYK conversion."""
    out = bytearray(data)
    at = out.index(b"Adobe")
    out[at + 11] = 2
    return bytes(out)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = (samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(h, -1), axis=1)


def _filter_rows(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row with a random one of PNG's five filters."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        ftype = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:len(r)]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:len(r)]
        if ftype == 0:
            f = r
        elif ftype == 1:
            f = r - left
        elif ftype == 2:
            f = r - prev
        elif ftype == 3:
            f = r - ((left + prev) >> 1)
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            f = r - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([ftype]) + (f & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def png_bytes(samples: np.ndarray, depth: int, ctype: int, extra: bytes = b"",
              interlace: int = 0, seed: int = 0) -> bytes:
    """A PNG of ``samples`` ``[H, W, channels]`` written with ``zlib`` and
    ``struct``: any bit depth, Adam7 or not, random row filters, ``extra``
    chunks (PLTE, tRNS) before the image data."""
    rng = np.random.default_rng(seed)
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if not interlace:
        raw = _filter_rows(_pack(samples.reshape(h, -1), depth), bpp, rng)
    else:
        raw = b""
        for x0, y0, dx, dy in _ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack(sub.reshape(sub.shape[0], -1), depth), bpp, rng)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + extra + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b""))


def png_case(rng, h, w, depth, ctype, interlace, trns):
    """A PNG of random samples (a smooth field, so that it compresses), with
    a palette and ``tRNS`` where asked."""
    chans, top = _CHANNELS[ctype], (1 << depth) - 1
    base = _photo(rng, h, w).astype(np.int64)
    field = np.concatenate([base, base[..., :1]], -1)[..., :chans] if chans > 1 else base[..., :1]
    samples = field * top // 255
    extra = b""
    if ctype == 3:
        n = max(2, (top + 1) * 3 // 4)  # a palette shorter than the index range
        extra = _chunk(b"PLTE", rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes())
        if trns:
            extra += _chunk(b"tRNS", bytes(range(0, 256, 37))[:n])
    elif trns:
        extra = _chunk(b"tRNS", struct.pack(">" + "H" * chans, *samples[0, 0].tolist()))
    return png_bytes(samples, depth, ctype, extra, interlace, seed=int(rng.integers(1 << 30)))


# GIF, BMP and TIFF, written here with struct and zlib so that every variant
# the port's decoders take is produced, and PIL reads each as the reference
def _lzw_codes(data: bytes, min_size: int, max_next: int = 4094):
    """LZW codes of ``data`` with a clear code first, a clear whenever the
    table reaches ``max_next`` and the end code last."""
    clear = 1 << min_size
    codes = [clear]
    table = {bytes([i]): i for i in range(clear)}
    nxt, w = clear + 2, b""
    for b in data:
        wk = w + bytes([b])
        if wk in table:
            w = wk
            continue
        codes.append(table[w])
        if nxt < max_next:
            table[wk] = nxt
            nxt += 1
        else:
            codes.append(clear)
            table = {bytes([i]): i for i in range(clear)}
            nxt = clear + 2
        w = bytes([b])
    if w:
        codes.append(table[w])
    codes.append(clear + 1)
    return codes


def _pack_codes(codes, min_size: int, msb: bool, early: int) -> bytes:
    """Codes packed into bytes, the width growing as a decoder expects it:
    ``early`` 1 for TIFF's early change, 0 for GIF and old-style TIFF."""
    clear = 1 << min_size
    size, nxt, acc, nbits, out = min_size + 1, clear + 2, 0, 0, bytearray()
    first = True
    for c in codes:
        if msb:
            acc = (acc << size) | c
            nbits += size
            while nbits >= 8:
                nbits -= 8
                out.append((acc >> nbits) & 255)
        else:
            acc |= c << nbits
            nbits += size
            while nbits >= 8:
                out.append(acc & 255)
                acc >>= 8
                nbits -= 8
        if c == clear:
            size, nxt, first = min_size + 1, clear + 2, True
            continue
        if first:  # the first code after a clear adds no entry
            first = False
            continue
        if nxt < 4096:
            nxt += 1
        if nxt + early >= (1 << size) and size < 12:
            size += 1
    if nbits:
        out.append(((acc << (8 - nbits)) & 255) if msb else acc & 255)
    return bytes(out)


def gif_bytes(frame: np.ndarray, palette: np.ndarray, screen=None, offset=(0, 0),
              local_palette=None, interlace=False, transparency=None, background=0,
              truncate=None) -> bytes:
    """A GIF89a of one frame of palette indices ``[h, w]``: a global palette
    (``None``: none), a local one, an offset on a larger logical screen,
    interlaced rows, a transparency index, the LZW data cut to ``truncate``
    bytes."""
    h, w = frame.shape
    sw, sh = screen or (w, h)

    def table(pal):
        n = max(2, 1 << int(np.ceil(np.log2(max(len(pal), 2)))))
        bits = int(np.log2(n)) - 1
        padded = np.zeros((n, 3), np.uint8)
        padded[:len(pal)] = pal
        return bits, padded.tobytes()
    out = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh))
    if palette is not None:
        bits, body = table(palette)
        out += bytes([0x80 | (bits << 4) | bits, background, 0]) + body
    else:
        out += bytes([0, background, 0])
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes([1]) + b"\0\0" + bytes([transparency, 0])
    flags = 0x40 if interlace else 0
    lbody = b""
    if local_palette is not None:
        bits, lbody = table(local_palette)
        flags |= 0x80 | bits
    out += b"," + struct.pack("<HHHH", offset[0], offset[1], w, h) + bytes([flags]) + lbody
    rows = frame
    if interlace:
        order = [*range(0, h, 8), *range(4, h, 8), *range(2, h, 4), *range(1, h, 2)]
        rows = frame[order]
    min_size = max(2, int(frame.max()).bit_length())
    data = _pack_codes(_lzw_codes(rows.astype(np.uint8).tobytes(), min_size), min_size,
                       msb=False, early=0)
    if truncate is not None:
        data = data[:truncate]
    out.append(min_size)
    for i in range(0, len(data), 255):
        out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
    out += b"\0"
    if truncate is None:
        out += b";"
    return bytes(out)


def _rle(indices: np.ndarray, four: bool, delta: bool = False) -> bytes:
    """BMP RLE8/RLE4 of bottom-up rows: encoded runs, absolute runs padded
    to a word, end of line, end of bitmap; with ``delta`` a delta escape
    first skips the bottom row and two pixels of the next (left at 0)."""
    out = bytearray()
    h, w = indices.shape
    rows, x0 = list(range(h - 1, -1, -1)), 0
    if delta and h > 1 and w > 2:
        out += b"\0\2\2\1"
        rows, x0 = rows[1:], 2
    for y in rows:
        row = indices[y].tolist()
        x, x0 = x0, 0
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 3:
                out += bytes([n, row[x] * 17 if four else row[x]])
                x += n
                continue
            m = x
            while m < w and m - x < 255 and not (m + 2 < w and row[m] == row[m + 1] == row[m + 2]):
                m += 1
            m -= x
            if m < 3:
                for v in row[x:x + m]:
                    out += bytes([1, v * 17 if four else v])
                x += m
                continue
            vals = row[x:x + m]
            body = (bytes((vals[i] << 4) | (vals[i + 1] if i + 1 < m else 0)
                          for i in range(0, m, 2)) if four else bytes(vals))
            out += bytes([0, m]) + body + (b"\0" if len(body) % 2 else b"")
            x += m
        out += b"\0\0"
    out += b"\0\1"
    return bytes(out)


def bmp_bytes(pixels: np.ndarray, bits: int, palette=None, core=False, top_down=False,
              rle=False, masks=None, delta=False) -> bytes:
    """A BMP: ``pixels`` palette indices ``[h, w]`` (1/4/8 bits) or RGB
    ``[h, w, 3]`` (16/24/32 bits); a ``BITMAPCOREHEADER`` or a
    ``BITMAPINFOHEADER``; RLE8/RLE4; 16-bit 555, or ``masks`` by
    ``BI_BITFIELDS``; rows bottom-up unless ``top_down``."""
    h, w = pixels.shape[:2]
    if bits <= 8:
        if rle:
            body = _rle(pixels, four=bits == 4, delta=delta)
        else:
            stride = (w * bits + 31) // 32 * 4
            rows = []
            for r in pixels:
                packed = np.packbits(((r[:, None] >> np.arange(bits - 1, -1, -1)) & 1)
                                     .astype(np.uint8).reshape(-1))
                rows.append(packed.tobytes().ljust(stride, b"\0"))
            body = b"".join(rows if top_down else rows[::-1])
    else:
        rgb = pixels.astype(np.uint32)
        if bits == 16:
            rm, gm, bm = masks or (0x7C00, 0x3E0, 0x1F)
            vals = np.zeros((h, w), np.uint32)
            for ch, m in zip(range(3), (rm, gm, bm)):
                width = bin(m).count("1")
                shift = (m & -m).bit_length() - 1
                vals |= (rgb[..., ch] >> (8 - width)) << shift
            data = vals.astype("<u2").view(np.uint8).reshape(h, w * 2)
        elif bits == 24:
            data = pixels[..., ::-1].astype(np.uint8).reshape(h, w * 3)
        else:
            extra = (rgb[..., 0] * 7 + 3) & 255  # an alpha or pad byte PIL must ignore
            data = np.stack([pixels[..., 2], pixels[..., 1], pixels[..., 0], extra], -1)
            data = data.astype(np.uint8).reshape(h, w * 4)
        stride = (data.shape[1] + 3) // 4 * 4
        rows = [r.tobytes().ljust(stride, b"\0") for r in data]
        body = b"".join(rows if top_down else rows[::-1])
    comp = (1 if bits == 8 else 2) if rle else (3 if masks else 0)
    if core:
        header = struct.pack("<IHHHH", 12, w, h, 1, bits)
        pal = b"".join(bytes([b, g, r]) for r, g, b in palette) if palette is not None else b""
    else:
        header = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, comp,
                             len(body), 2835, 2835, len(palette) if palette is not None else 0,
                             0)
        pal = (b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
               if palette is not None else b"")
        if masks:
            header += struct.pack("<III", *masks)
    offset = 14 + len(header) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + header + pal
            + body)


def _packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + data[i:i + 1]
            i = j + 1
            continue
        j = i
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_bytes(samples: np.ndarray, bits: int, photometric: int, big_endian=False,
               compression=1, predictor=1, planar=1, tile=None, rows_per_strip=None,
               colormap=None, extra_samples=None, old_lzw=False) -> bytes:
    """A baseline TIFF of ``samples`` ``[h, w, spp]`` (unsigned, ``bits``
    each): strips or ``tile`` (width, length) tiles, chunky or planar,
    uncompressed (1), LZW (5; ``old_lzw``: the pre-6.0 bit order), Adobe
    Deflate (8), Deflate (32946) or PackBits (32773), horizontal predictor
    (2), a 16-bit colormap, extra samples."""
    e = ">" if big_endian else "<"
    h, w, spp = samples.shape
    dtype = np.dtype(e + ("u2" if bits == 16 else "u1"))

    def chunk_bytes(block):  # [rows, cols, spp] -> encoded bytes
        block = block.astype(np.int64)
        if predictor == 2:
            block = block.copy()
            block[:, 1:] = (block[:, 1:] - block[:, :-1]) % (1 << bits)
        if bits < 8:
            rows = [np.packbits(((r.reshape(-1)[:, None] >> np.arange(bits - 1, -1, -1)) & 1)
                                .astype(np.uint8).reshape(-1)).tobytes() for r in block]
            raw = b"".join(rows)
        else:
            raw = block.astype(dtype).tobytes()
        if compression == 1:
            return raw
        if compression == 32773:
            stride = len(raw) // block.shape[0]
            return b"".join(_packbits(raw[i:i + stride]) for i in range(0, len(raw), stride))
        if compression == 5:
            codes = _lzw_codes(raw, 8)
            return _pack_codes(codes, 8, msb=not old_lzw, early=0 if old_lzw else 1)
        return zlib.compress(raw, 6)

    planes = [samples[..., k:k + 1] for k in range(spp)] if planar == 2 else [samples]
    chunks = []
    for plane in planes:
        if tile:
            tw, tl = tile
            for ty in range(0, h, tl):
                for tx in range(0, w, tw):
                    block = np.zeros((tl, tw, plane.shape[2]), samples.dtype)
                    part = plane[ty:ty + tl, tx:tx + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    chunks.append(chunk_bytes(block))
        else:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                chunks.append(chunk_bytes(plane[y:y + rps]))
    tags = {256: ("H", [w]), 257: ("H", [h]), 258: ("H", [bits] * spp),
            259: ("H", [compression]), 262: ("H", [photometric]), 277: ("H", [spp]),
            284: ("H", [planar])}
    if predictor != 1:
        tags[317] = ("H", [predictor])
    if colormap is not None:
        tags[320] = ("H", np.asarray(colormap, np.int64).T.reshape(-1).tolist())
    if extra_samples is not None:
        tags[338] = ("H", [extra_samples])
    if photometric == 5:
        tags[332] = ("H", [1])
    offsets_tag, counts_tag = (324, 325) if tile else (273, 279)
    if tile:
        tags[322], tags[323] = ("H", [tile[0]]), ("H", [tile[1]])
    else:
        tags[278] = ("I", [rows_per_strip or h])
    data_at = 8
    offsets, blob = [], bytearray()
    for c in chunks:
        offsets.append(data_at + len(blob))
        blob += c
        if len(blob) % 2:
            blob += b"\0"
    tags[offsets_tag] = ("I", offsets)
    tags[counts_tag] = ("I", [len(c) for c in chunks])
    ifd_at = data_at + len(blob)
    n = len(tags)
    extra_at = ifd_at + 2 + 12 * n + 4
    entries, extra = bytearray(), bytearray()
    for tag in sorted(tags):
        fmt, vals = tags[tag]
        kind, size = (3, 2) if fmt == "H" else (4, 4)
        payload = struct.pack(e + fmt * len(vals), *vals)
        if len(payload) <= 4:
            value = payload.ljust(4, b"\0")
        else:
            value = struct.pack(e + "I", extra_at + len(extra))
            extra += payload + (b"\0" if len(payload) % 2 else b"")
        entries += struct.pack(e + "HHI", tag, kind, len(vals)) + value
    head = (b"MM\0*" if big_endian else b"II*\0") + struct.pack(e + "I", ifd_at)
    return (head + bytes(blob) + struct.pack(e + "H", n) + bytes(entries)
            + struct.pack(e + "I", 0) + bytes(extra))


def image_cases():
    """(file name, bytes) of every fixture image."""
    rng = np.random.default_rng(SEED)
    out = []
    for sub, name in ((0, "444"), (1, "422"), (2, "420")):
        for h, w in ((48, 64), (17, 9), (1, 1), (3, 513), (61, 37)):
            out.append((f"prog_{name}_{h}x{w}.jpg",
                        _jpeg(_photo(rng, h, w), progressive=True, subsampling=sub)))
        out.append((f"prog_{name}_optimize.jpg",
                    _jpeg(_photo(rng, 40, 56), progressive=True, subsampling=sub, optimize=True)))
        out.append((f"prog_{name}_restart.jpg",
                    _jpeg(_photo(rng, 40, 56), progressive=True, subsampling=sub,
                          restart_marker_blocks=3)))
    out.append(("prog_grey.jpg", _jpeg(_photo(rng, 45, 70), "L", progressive=True)))
    out.append(("prog_grey_restart.jpg", _jpeg(_photo(rng, 33, 21), "L", progressive=True,
                                               restart_marker_rows=1)))
    out.append(("prog_420_large.jpg", _jpeg(_photo(rng, 240, 320), progressive=True,
                                            quality=85)))
    out.append(("base_420_large.jpg", _jpeg(_photo(rng, 240, 320), quality=85)))
    cuts = {"norefine": lambda ss, se, ah, al: ah == 0,
            "dconly": lambda ss, se, ah, al: ss == 0,
            "lowac": lambda ss, se, ah, al: ss == 0 or (ah == 0 and se <= 5)}
    for cut, keep in cuts.items():
        for sub, name in ((0, "444"), (2, "420")):
            out.append((f"smooth_{cut}_{name}.jpg", cut_scans(
                _jpeg(_photo(rng, 37, 53), progressive=True, subsampling=sub), keep)))
    out.append(("smooth_norefine_grey.jpg", cut_scans(
        _jpeg(_photo(rng, 24, 40), "L", progressive=True), cuts["norefine"])))
    for prog in (False, True):
        kind = "prog" if prog else "seq"
        out.append((f"cmyk_{kind}.jpg", _jpeg(_photo(rng, 29, 43), "CMYK", progressive=prog)))
        out.append((f"ycck_{kind}.jpg", as_ycck(_jpeg(_photo(rng, 29, 43), "CMYK",
                                                      progressive=prog))))
    out.append(("cmyk_norefine.jpg", cut_scans(_jpeg(_photo(rng, 29, 43), "CMYK",
                                                     progressive=True), cuts["norefine"])))
    pngs = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
            (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
    for ctype, depth in pngs:
        for interlace in (0, 1):
            trns = ctype in (0, 2, 3) and interlace == 1
            out.append((f"png_c{ctype}_d{depth}_{'adam7' if interlace else 'plain'}"
                        f"{'_trns' if trns else ''}.png",
                        png_case(rng, 27, 35, depth, ctype, interlace, trns)))
    return out


def codec_cases():
    """(file name, bytes) of the GIF, BMP and TIFF fixtures: every variant
    the port decodes, at small sizes."""
    rng = np.random.default_rng(SEED + 2)
    out = []
    photo = _photo(rng, 23, 31)
    idx16 = (photo[..., 0] // 16).astype(np.uint8)
    pal16 = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    out.append(("gif_plain.gif", gif_bytes(idx16, pal16)))
    out.append(("gif_interlaced.gif", gif_bytes(idx16, pal16, interlace=True)))
    out.append(("gif_offset_local_trns.gif",
                gif_bytes(idx16[:17, :20] % 8, pal16, screen=(31, 23), offset=(3, 4),
                          local_palette=rng.integers(0, 256, (8, 3), dtype=np.uint8),
                          transparency=2, background=5)))
    out.append(("gif_no_palette.gif", gif_bytes(idx16, None)))
    big = _photo(rng, 64, 64)
    out.append(("gif_lzw_clears.gif", gif_bytes(
        (big[..., 0] // 4 * 4 + big[..., 1] // 64).astype(np.uint8),
        rng.integers(0, 256, (256, 3), dtype=np.uint8))))
    for bits in (1, 4, 8):
        pal = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)
        idx = (photo[..., 1] >> (8 - bits)).astype(np.uint8)
        out.append((f"bmp_{bits}bit.bmp", bmp_bytes(idx, bits, pal)))
        if bits == 8:
            out.append(("bmp_8bit_core.bmp", bmp_bytes(idx, 8, pal, core=True)))
            out.append(("bmp_8bit_topdown.bmp", bmp_bytes(idx, 8, pal, top_down=True)))
        if bits in (4, 8):
            runs = np.repeat(idx[:, ::3], 3, axis=1)[:, :31]
            out.append((f"bmp_rle{bits}.bmp", bmp_bytes(runs, bits, pal, rle=True)))
            out.append((f"bmp_rle{bits}_delta.bmp", bmp_bytes(runs, bits, pal, rle=True,
                                                              delta=True)))
    out.append(("bmp_16bit_555.bmp", bmp_bytes(photo, 16)))
    out.append(("bmp_16bit_565.bmp", bmp_bytes(photo, 16, masks=(0xF800, 0x7E0, 0x1F))))
    out.append(("bmp_24bit.bmp", bmp_bytes(photo, 24)))
    out.append(("bmp_24bit_topdown.bmp", bmp_bytes(photo, 24, top_down=True)))
    out.append(("bmp_32bit.bmp", bmp_bytes(photo, 32)))
    alpha = np.concatenate([photo, photo[..., :1] // 2 + 64], -1)
    grey = photo[..., :1]
    cmyk = np.concatenate([255 - photo, photo[..., 1:2] // 3], -1)
    tiffs = [("rgb_raw_le", photo, 8, 2, {}),
             ("rgb_raw_be_tiles", photo, 8, 2, {"big_endian": True, "tile": (16, 16)}),
             ("rgb_packbits_strips", photo, 8, 2, {"compression": 32773, "rows_per_strip": 5}),
             ("rgb_lzw_predictor", photo, 8, 2, {"compression": 5, "predictor": 2}),
             ("rgb_lzw_old", photo, 8, 2, {"compression": 5, "old_lzw": True}),
             ("rgb_adobe_deflate_planar", photo, 8, 2, {"compression": 8, "planar": 2,
                                                        "rows_per_strip": 8}),
             ("rgb_deflate_be_tiles_predictor", photo, 8, 2,
              {"compression": 32946, "big_endian": True, "tile": (16, 16), "predictor": 2}),
             ("rgba_lzw", alpha, 8, 2, {"compression": 5, "extra_samples": 2}),
             ("rgba_associated", alpha, 8, 2, {"extra_samples": 1}),
             ("grey8_min_is_white", grey, 8, 0, {}),
             ("grey8_lzw", grey, 8, 1, {"compression": 5, "rows_per_strip": 7}),
             ("grey16_be_predictor", grey.astype(np.uint16) * 3, 16, 1,
              {"compression": 8, "big_endian": True, "predictor": 2}),
             ("bit1_min_is_white_packbits", grey // 128, 1, 0, {"compression": 32773}),
             ("palette_lzw", grey, 8, 3, {"compression": 5, "colormap": rng.integers(
                 0, 65536, (256, 3))}),
             ("cmyk_deflate", cmyk, 8, 5, {"compression": 8})]
    for name, samples, bits, photometric, kw in tiffs:
        out.append((f"tiff_{name}.tif", tiff_bytes(samples, bits, photometric, **kw)))
    return out


def write_image_column(codec_files):
    """One parquet file written by ``datasets`` with an ``Image`` column (the
    bytes of some codec fixtures and a PNG and a JPEG), and the digest of
    ``datasets``' own decoding of it, each image then ``convert("RGB")``."""
    import datasets
    import pyarrow.parquet as pq

    names = [n for n in codec_files if n.startswith(("gif_plain", "bmp_rle8", "tiff_rgb_lzw",
                                                     "tiff_cmyk"))]
    rows = [{"bytes": open(os.path.join(CODECS, n), "rb").read(), "path": n} for n in names]
    for n in ("png_c3_d4_plain.png", "prog_444_17x9.jpg"):
        rows.append({"bytes": open(os.path.join(IMAGES, n), "rb").read(), "path": n})
    ds = datasets.Dataset.from_dict(
        {"id": [r["path"] for r in rows], "image": rows},
        features=datasets.Features({"id": datasets.Value("string"), "image": datasets.Image()}))
    os.makedirs(os.path.dirname(IMAGE_COLUMN), exist_ok=True)
    ds.to_parquet(IMAGE_COLUMN)
    feature = datasets.Image()
    decoded = [feature.decode_example(v) for v in pq.read_table(IMAGE_COLUMN)["image"].to_pylist()]
    return images_digest([np.asarray(im.convert("RGB")) for im in decoded])


def images_digest(images) -> str:
    """SHA-256 of a list of images' pixel digests."""
    return hashlib.sha256(json.dumps([pixels_digest(i) for i in images]).encode()).hexdigest()


def tokenizer_pieces():
    """The fixture tokenizer's pieces and scores (multiples of 1/4) and its
    charsmap: full-width forms, ideographic space, a combining sequence."""
    rng = np.random.default_rng(SEED + 3)
    vocab = ["a", "photo", "of", "the", "cat", "on", "mat", "sun", "kato", "lomi", "café",
             "東京", "가각", "ph", "ot", "at", "th"]
    pieces = list(dict.fromkeys(["▁", *"abcdefghijklmnopqrstuvwxyz.,éñ東京가각",
                                 *("▁" + w for w in vocab), *vocab]))
    scores = (-rng.integers(4, 60, len(pieces)) / 4.0).tolist()
    charsmap = {**{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)}, "　": " ",
                "é": "é", "ﬁ": "fi"}
    return pieces, scores, charsmap


def write_tokenizer():
    """The Unigram tokenizer directory (written by the port's
    ``write_unigram_tokenizer``) and the digests of ``tokenizers``' ids and
    decoded strings for :data:`TOKENIZER_TEXTS`."""
    import sys

    from tokenizers import Tokenizer

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (
        write_precompiled_charsmap, write_unigram_tokenizer)

    pieces, scores, charsmap = tokenizer_pieces()
    write_unigram_tokenizer(TOKENIZER, pieces, scores, write_precompiled_charsmap(charsmap),
                            extra_ids=8)
    tok = Tokenizer.from_file(os.path.join(TOKENIZER, "tokenizer.json"))
    ids = [tok.encode(t).ids for t in TOKENIZER_TEXTS]
    decoded = [tok.decode(i, skip_special_tokens=True) for i in ids]
    return {"texts": TOKENIZER_TEXTS, "ids": hashlib.sha256(json.dumps(ids).encode()).hexdigest(),
            "decoded": hashlib.sha256(json.dumps(decoded, ensure_ascii=False).encode("utf-8"))
            .hexdigest()}


# ------------------------------------------------------------------ tables
def _question_rows(rng, vocab, n, prefix, passages, images):
    ids, content = passages["passage_id"], passages["passage_content"]
    pos = rng.integers(0, len(ids), n)
    rows = {"question_id": [f"{prefix}{i}" for i in range(n)],
            # each question shares words with its positive passage
            "question": [" ".join(content[p].split()[:6]) + " "
                         + " ".join(vocab[j] for j in rng.integers(0, len(vocab), 4))
                         for p in pos],
            "instruction": [INSTRUCTIONS[int(j)] for j in rng.integers(0, len(INSTRUCTIONS), n)],
            "img_id": [os.path.splitext(images[int(j)])[0]
                       for j in rng.integers(0, len(images), n)],
            "answers": [[vocab[int(j)] for j in rng.integers(0, len(vocab), int(k))]
                        for k in rng.integers(1, 4, n)],
            "pos_item_ids": [[ids[p]] for p in pos],
            "pos_item_contents": [[content[p]] for p in pos],
            "related_item_ids": [[ids[int(j)] for j in rng.integers(0, len(ids), int(k))]
                                 for k in rng.integers(0, 3, n)],
            "source_name": ["evqa"] * n}
    names = {os.path.splitext(f)[0]: f for f in images}
    rows["img_path"] = [names[i] for i in rows["img_id"]]
    rows["gold_answer"] = [a[0] for a in rows["answers"]]
    return rows


def _passage_rows(rng, vocab, n, prefix):
    return {"passage_id": [f"{prefix}{i}" for i in range(n)],
            "passage_content": [" ".join(vocab[j] for j in rng.integers(0, len(vocab), int(k)))
                                for k in rng.integers(12, 28, n)],
            "source_name": ["evqa"] * n}


README = """---
license: mit
task_categories:
- knowledge-based-visual-question-answering
- Knowledge-retrieval
- passage-retrieval
language:
- en
pretty_name: M2KR (a synthetic cut for tests)
size_categories:
- 1K<n<10K
dataset_info:
{dataset_info}configs:
- config_name: EVQA_data
  data_files:
  - split: train
    path: EVQA_data/train-*
  - split: valid
    path: EVQA_data/valid-*
  - split: test
    path: EVQA_data/test-*
- config_name: EVQA_passages
  data_files:
  - split: train_passages
    path: EVQA_passages/train_passages-*
  - split: valid_passages
    path: EVQA_passages/valid_passages-*
  - split: test_passages
    path: EVQA_passages/test_passages-*
---

# M2KR (a synthetic cut for tests)

Random pseudo-word questions and passages in the layout and schema of
M2KR's EVQA configs on the HF hub; written by
`tests/fixtures/make_m2kr_parquet.py`.
"""


def _dataset_info(config, table, splits):
    import pyarrow as pa

    lines = [f"- config_name: {config}", "  features:"]
    for field in table.schema:
        if pa.types.is_list(field.type):
            lines += [f"  - name: {field.name}", "    sequence: string"]
        else:
            lines += [f"  - name: {field.name}", "    dtype: string"]
    lines.append("  splits:")
    for name, (nbytes, n) in splits.items():
        lines += [f"  - name: {name}", f"    num_bytes: {nbytes}", f"    num_examples: {n}"]
    total = sum(b for b, _ in splits.values())
    lines += [f"  download_size: {total // 3}", f"  dataset_size: {total}"]
    return "\n".join(lines) + "\n"


def write_snapshot(images):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(SEED)
    vocab = words(2000)
    info = ""
    passages = {}
    os.makedirs(os.path.join(SNAPSHOT, "EVQA_passages"), exist_ok=True)
    os.makedirs(os.path.join(SNAPSHOT, "EVQA_data"), exist_ok=True)
    sizes = {}
    for split, n in PASSAGES.items():
        passages[split] = _passage_rows(rng, vocab, n, f"evqa_{split.split('_')[0]}_p")
        t = pa.table(passages[split])
        pq.write_table(t, os.path.join(SNAPSHOT, "EVQA_passages",
                                       f"{split}-00000-of-00001.parquet"))
        sizes[split] = (t.nbytes, n)
    info += _dataset_info("EVQA_passages", t, sizes)
    sizes = {}
    for split, n in QUESTIONS.items():
        rows = _question_rows(rng, vocab, n, f"EVQA_{split}_", passages[f"{split}_passages"],
                              images)
        t = pa.table(rows)
        shards = TRAIN_SHARDS if split == "train" else 1
        for s in range(shards):
            lo, hi = s * n // shards, (s + 1) * n // shards
            pq.write_table(t.slice(lo, hi - lo), os.path.join(
                SNAPSHOT, "EVQA_data", f"{split}-{s:05d}-of-{shards:05d}.parquet"))
        sizes[split] = (t.nbytes, n)
    info = _dataset_info("EVQA_data", t, sizes) + info
    with open(os.path.join(SNAPSHOT, "README.md"), "w") as f:
        f.write(README.format(dataset_info=info))


def variant_table():
    """One table of every column type the reader takes: strings, ints of
    each width, unsigned ints, floats, bools, nulls, binary, lists of
    strings with empty and null lists, a struct and a list of structs."""
    import pyarrow as pa

    rng = np.random.default_rng(SEED + 1)
    n = 200

    def maybe(v, p=0.2):
        return None if rng.random() < p else v

    return pa.table({
        "s": pa.array([maybe(f"s{i % 23}") for i in range(n)], pa.string()),
        "i32": pa.array([maybe(int(x)) for x in rng.integers(-2**31, 2**31, n)], pa.int32()),
        "i64": pa.array([int(x) for x in rng.integers(-2**62, 2**62, n)], pa.int64()),
        "u8": pa.array([maybe(int(x)) for x in rng.integers(0, 256, n)], pa.uint8()),
        "f32": pa.array([maybe(float(x)) for x in rng.normal(size=n)], pa.float32()),
        "f64": pa.array([float(x) for x in rng.normal(size=n)], pa.float64()),
        "b": pa.array([maybe(bool(x)) for x in rng.integers(0, 2, n)], pa.bool_()),
        "nothing": pa.array([None] * n, pa.null()),
        "raw": pa.array([maybe(bytes(rng.integers(0, 256, i % 5).astype(np.uint8)))
                         for i in range(n)], pa.binary()),
        "tags": pa.array([maybe([maybe(f"t{j}", 0.1) for j in range(i % 4)])
                          for i in range(n)], pa.list_(pa.string())),
        "box": pa.array([maybe({"x": maybe(i), "label": f"l{i}"}) for i in range(n)],
                        pa.struct([("x", pa.int64()), ("label", pa.string())])),
        "objects": pa.array([maybe([maybe({"cls": f"c{j}", "score": float(j) / 4}, 0.1)
                                    for j in range(i % 3)]) for i in range(n)],
                            pa.list_(pa.struct([("cls", pa.string()),
                                                ("score", pa.float32())]))),
    })


def write_variants():
    import pyarrow.parquet as pq

    os.makedirs(VARIANTS, exist_ok=True)
    table = variant_table()
    for codec in ("none", "snappy", "gzip"):
        for version in ("1.0", "2.0"):
            for dictionary in (True, False):
                name = f"{codec}_v{version[0]}_{'dict' if dictionary else 'plain'}.parquet"
                pq.write_table(table, os.path.join(VARIANTS, name), compression=codec,
                               use_dictionary=dictionary, data_page_version=version,
                               row_group_size=50, data_page_size=1024, write_batch_size=16)


# ------------------------------------------- other codecs and encodings
# leaf path -> encoding, two sets that between them put every encoding the
# reader takes on every physical type that has it, in flat, list and struct
# columns (use_dictionary off)
ENCODING_SETS = {
    "delta": {"s": "DELTA_BYTE_ARRAY", "raw": "DELTA_LENGTH_BYTE_ARRAY",
              "i32": "DELTA_BINARY_PACKED", "i64": "DELTA_BINARY_PACKED",
              "u8": "DELTA_BINARY_PACKED", "f32": "BYTE_STREAM_SPLIT",
              "f64": "BYTE_STREAM_SPLIT", "tags.list.element": "DELTA_LENGTH_BYTE_ARRAY",
              "box.x": "DELTA_BINARY_PACKED", "box.label": "DELTA_BYTE_ARRAY",
              "objects.list.element.cls": "DELTA_LENGTH_BYTE_ARRAY",
              "objects.list.element.score": "BYTE_STREAM_SPLIT"},
    "split": {"s": "DELTA_LENGTH_BYTE_ARRAY", "raw": "DELTA_BYTE_ARRAY",
              "i32": "BYTE_STREAM_SPLIT", "i64": "BYTE_STREAM_SPLIT", "u8": "BYTE_STREAM_SPLIT",
              "f32": "BYTE_STREAM_SPLIT", "f64": "BYTE_STREAM_SPLIT",
              "tags.list.element": "DELTA_BYTE_ARRAY", "box.x": "BYTE_STREAM_SPLIT",
              "box.label": "DELTA_LENGTH_BYTE_ARRAY",
              "objects.list.element.cls": "DELTA_BYTE_ARRAY",
              "objects.list.element.score": "BYTE_STREAM_SPLIT"},
}


def fixed_table():
    """FIXED_LEN_BYTE_ARRAY columns, with nulls, flat and in a list."""
    import pyarrow as pa

    rng = np.random.default_rng(SEED + 2)
    n = 150
    return pa.table({
        "fixed": pa.array([None if i % 7 == 3 else bytes(rng.integers(0, 4, 6).astype(np.uint8))
                           for i in range(n)], pa.binary(6)),
        "fixed_list": pa.array([[bytes(rng.integers(0, 256, 3).astype(np.uint8))
                                 for _ in range(i % 3)] for i in range(n)],
                               pa.list_(pa.binary(3))),
    })


def write_codec_variants():
    """The variant table in ZSTD and LZ4_RAW, and in each encoding set, and
    the FIXED_LEN_BYTE_ARRAY table by DELTA_BYTE_ARRAY and
    BYTE_STREAM_SPLIT, on data pages v1 and v2."""
    import pyarrow.parquet as pq

    table = variant_table()
    out = {}
    for codec, tag in (("zstd", "zstd"), ("lz4", "lz4raw")):
        for version in ("1.0", "2.0"):
            for dictionary in (True, False):
                name = f"{tag}_v{version[0]}_{'dict' if dictionary else 'plain'}.parquet"
                out[name] = dict(table=table, compression=codec, use_dictionary=dictionary,
                                 data_page_version=version)
    for set_name, encodings in ENCODING_SETS.items():
        for version, codec in (("1.0", "none"), ("2.0", "zstd")):
            out[f"enc_{set_name}_v{version[0]}.parquet"] = dict(
                table=table, compression=codec, use_dictionary=False, data_page_version=version,
                column_encoding=encodings)
    for version, codec in (("1.0", "lz4"), ("2.0", "zstd")):
        for enc in ("DELTA_BYTE_ARRAY", "BYTE_STREAM_SPLIT"):
            tag = "split" if enc == "BYTE_STREAM_SPLIT" else "delta"
            out[f"enc_fixed_{tag}_v{version[0]}.parquet"] = dict(
                table=fixed_table(), compression=codec, use_dictionary=False,
                data_page_version=version,
                column_encoding={"fixed": enc, "fixed_list.list.element": enc})
    for name, kw in out.items():
        t = kw.pop("table")
        pq.write_table(t, os.path.join(VARIANTS, name), row_group_size=50, data_page_size=1024,
                       write_batch_size=16, **kw)
    return sorted(out)


class _Thrift:
    """A writer of Thrift's compact protocol for the hand-made files: a
    struct is a list of ``(field id, type, value)`` with type ``"i32"``,
    ``"i64"``, ``"bin"``, ``"struct"`` or ``("list", element type)``."""

    CODES = {"i32": 5, "i64": 6, "bin": 8, "struct": 12}

    def __init__(self):
        self.out = bytearray()

    def varint(self, n):
        while n >= 0x80:
            self.out.append((n & 0x7F) | 0x80)
            n >>= 7
        self.out.append(n)

    def value(self, kind, v):
        if kind in ("i32", "i64"):
            self.varint((v << 1) ^ (v >> 63))
        elif kind == "bin":
            self.varint(len(v))
            self.out += v
        elif kind == "struct":
            self.struct(v)
        else:
            elem = kind[1]
            code = self.CODES[elem]
            if len(v) < 15:
                self.out.append((len(v) << 4) | code)
            else:
                self.out.append(0xF0 | code)
                self.varint(len(v))
            for x in v:
                self.value(elem, x)

    def struct(self, fields):
        last = 0
        for fid, kind, v in fields:
            code = self.CODES[kind] if isinstance(kind, str) else 9
            self.out.append(((fid - last) << 4) | code)
            last = fid
            self.value(kind, v)
        self.out.append(0)


def _thrift(fields) -> bytes:
    w = _Thrift()
    w.struct(fields)
    return bytes(w.out)


def lz4_compress(data: bytes) -> bytes:
    """A greedy LZ4 block compressor (4-byte hash matches, offsets below
    65,536, the format's end rules: the last 5 bytes literals, no match
    starting in the last 12)."""
    out, n, i, anchor, seen = bytearray(), len(data), 0, 0, {}

    def length(v):
        while v >= 255:
            out.append(255)
            v -= 255
        out.append(v)

    def sequence(lit, match=None):
        ln = len(lit)
        ml = None if match is None else match[1] - 4
        out.append((min(ln, 15) << 4) | (0 if ml is None else min(ml, 15)))
        if ln >= 15:
            length(ln - 15)
        out.extend(lit)
        if match is not None:
            out.extend(struct.pack("<H", match[0]))
            if ml >= 15:
                length(ml - 15)

    while i + 12 <= n:
        key = data[i:i + 4]
        j = seen.get(key)
        seen[key] = i
        if j is not None and i - j < 65536:
            m = 4
            while i + m < n - 5 and data[j + m] == data[i + m]:
                m += 1
            sequence(data[anchor:i], (i - j, m))
            i += m
            anchor = i
        else:
            i += 1
    sequence(data[anchor:])
    return bytes(out)


def handmade_parquet(codec: int, hadoop: bool) -> bytes:
    """A file pyarrow does not write: two required columns (INT64, UTF8)
    in one row group of data pages v1, compressed by ``codec`` (LZ4 = 5 in
    Hadoop's framing, two blocks a page, or as one raw block; LZO = 3 is
    written with LZ4 blocks and only has to be refused)."""
    rng = np.random.default_rng(SEED + 3)
    n = 300
    ids = np.cumsum(rng.integers(0, 5, n)).astype("<i8")
    names = [f"name {int(x) % 17} {'x' * int(x % 5)}".encode() for x in ids]
    columns = [(2, [(1, "i32", 2), (3, "i32", 0), (4, "bin", b"id")], ids.tobytes()),
               (6, [(1, "i32", 6), (3, "i32", 0), (4, "bin", b"name"), (6, "i32", 0)],
                b"".join(struct.pack("<I", len(x)) + x for x in names))]
    body, chunks = bytearray(PAR1 := b"PAR1"), []
    for ptype, element, raw in columns:
        if hadoop:
            half = len(raw) // 2
            comp = b"".join(struct.pack(">II", len(part), len(c)) + c for part in
                            (raw[:half], raw[half:]) for c in [lz4_compress(part)])
        else:
            comp = lz4_compress(raw)
        header = _thrift([(1, "i32", 0), (2, "i32", len(raw)), (3, "i32", len(comp)),
                          (5, "struct", [(1, "i32", n), (2, "i32", 0), (3, "i32", 3),
                                         (4, "i32", 3)])])
        offset = len(body)
        body += header + comp
        meta = [(1, "i32", ptype), (2, ("list", "i32"), [0, 3]),
                (3, ("list", "bin"), [element[2][2]]), (4, "i32", codec), (5, "i64", n),
                (6, "i64", len(header) + len(raw)), (7, "i64", len(header) + len(comp)),
                (9, "i64", offset)]
        chunks.append([(2, "i64", offset), (3, "struct", meta)])
    schema = [[(4, "bin", b"schema"), (5, "i32", len(columns))]] + [c[1] for c in columns]
    footer = _thrift([(1, "i32", 1), (2, ("list", "struct"), schema), (3, "i64", n),
                      (4, ("list", "struct"), [[(1, ("list", "struct"), chunks),
                                               (2, "i64", len(body)), (3, "i64", n)]])])
    return bytes(body + footer + struct.pack("<I", len(footer)) + PAR1)


def write_refused_and_handmade():
    """The hand-made LZ4 files (read) and the file whose codec the reader
    refuses, as pyarrow does: LZO. Returns the names pyarrow reads."""
    for name, codec, hadoop in (("lz4_hadoop.parquet", 5, True),
                                ("lz4_hadoop_fallback.parquet", 5, False),
                                ("refused_lzo.parquet", 3, True)):
        with open(os.path.join(VARIANTS, name), "wb") as f:
            f.write(handmade_parquet(codec, hadoop))
    return ["lz4_hadoop.parquet", "lz4_hadoop_fallback.parquet"]


# English words the Brotli dictionary holds, for a table whose pages use
# its static references
_ENGLISH = ("the of and to in is that for it as was with be by on not he this are or his "
            "from at which but have an they you were her she there been one all we their has "
            "would when if so what out up more about into them can only other time new some "
            "could these two may first then do any like my now over such our man me even most "
            "made after also did many before must through back years where much your way well "
            "down should because each just those people how too little state good very make "
            "world still own see men work long get here between both life being under never "
            "day same another know while last might us great old year off come since against "
            "go came right used take three").split()


def temporal_table():
    """Dates, times and timestamps of every unit, naive and zoned, with
    nulls, in a list and in a struct."""
    import pyarrow as pa

    rng = np.random.default_rng(SEED + 11)
    n = 120

    def maybe(v, p=0.15):
        return None if rng.random() < p else v

    ns = [maybe(int(x)) for x in rng.integers(-2 ** 61, 2 ** 61, n)]
    us = [maybe(int(x)) for x in rng.integers(-2 ** 52, 2 ** 52, n)]
    return pa.table({
        "date": pa.array([maybe(int(x)) for x in rng.integers(-700000, 2900000, n)], pa.date32()),
        "time_ms": pa.array([maybe(int(x)) for x in rng.integers(0, 86400000, n)],
                            pa.time32("ms")),
        "time_us": pa.array([maybe(int(x)) for x in rng.integers(0, 86400 * 10 ** 6, n)],
                            pa.time64("us")),
        "time_ns": pa.array([maybe(int(x)) for x in rng.integers(0, 86400 * 10 ** 9, n)],
                            pa.time64("ns")),
        "ts_s": pa.array([maybe(int(x)) for x in rng.integers(-2 ** 34, 2 ** 35, n)],
                         pa.timestamp("s")),
        "ts_ms_utc": pa.array([maybe(int(x)) for x in rng.integers(-2 ** 44, 2 ** 45, n)],
                              pa.timestamp("ms", "UTC")),
        "ts_us_paris": pa.array(us, pa.timestamp("us", "Europe/Paris")),
        "ts_ns": pa.array(ns, pa.timestamp("ns")),
        "ts_ns_offset": pa.array(ns[::-1], pa.timestamp("ns", "+05:30")),
        "stamps": pa.array([maybe([maybe(u, 0.1) for u in us[i:i + i % 4]]) for i in range(n)],
                           pa.list_(pa.timestamp("us", "Asia/Tokyo"))),
        "event": pa.array([maybe({"at": maybe(ns[i]), "day": maybe(i * 37)}) for i in range(n)],
                          pa.struct([("at", pa.timestamp("ns", "UTC")), ("day", pa.date32())])),
    })


def write_temporal_and_brotli():
    """The variants the reader took on with BROTLI, INT96 and the temporal
    types: ``brotli_{1,11}_*`` (the variant table at levels 1 and 11, and
    English text at level 11, whose pages use the static dictionary),
    ``temporal_v{1,2}_*`` and ``int96_*`` (timestamps written as INT96).
    Returns their names."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = variant_table()
    names = []
    for level, version, dictionary in ((1, "1.0", True), (11, "2.0", False)):
        name = f"brotli_{level}_v{version[0]}_{'dict' if dictionary else 'plain'}.parquet"
        pq.write_table(table, os.path.join(VARIANTS, name), compression="brotli",
                       compression_level=level, use_dictionary=dictionary,
                       data_page_version=version, row_group_size=50, data_page_size=1024,
                       write_batch_size=16)
        names.append(name)
    rng = np.random.default_rng(SEED + 12)
    text = pa.table({"text": [" ".join(rng.choice(_ENGLISH, 40)) + "." for _ in range(300)],
                     "title": [f"The {w.title()} of the World" for w in rng.choice(_ENGLISH, 300)]})
    pq.write_table(text, os.path.join(VARIANTS, "brotli_11_text.parquet"), compression="brotli",
                   compression_level=11, use_dictionary=False)
    names.append("brotli_11_text.parquet")
    temporal = temporal_table()
    for version, dictionary in (("1.0", True), ("2.0", False)):
        name = f"temporal_v{version[0]}_{'dict' if dictionary else 'plain'}.parquet"
        pq.write_table(temporal, os.path.join(VARIANTS, name), use_dictionary=dictionary,
                       data_page_version=version, row_group_size=60)
        names.append(name)
    for dictionary in (True, False):
        name = f"int96_{'dict' if dictionary else 'plain'}.parquet"
        pq.write_table(temporal.select(["ts_s", "ts_ns", "ts_us_paris", "stamps", "event"]),
                       os.path.join(VARIANTS, name), use_dictionary=dictionary,
                       use_deprecated_int96_timestamps=True)
        names.append(name)
    return names


# -------------------------------------------------------------------- WebP
def _webp(arr, mode="RGB", **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _riff_webp(chunks) -> bytes:
    """A RIFF WEBP file of ``(fourcc, payload)`` chunks (odd ones padded)."""
    body = b"".join(tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)
                    for tag, data in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _webp_chunk(data: bytes, tag: bytes) -> bytes:
    """The payload of the first ``tag`` chunk of a simple or VP8X file."""
    pos = 12
    while pos < len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if data[pos:pos + 4] == tag:
            return data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    raise ValueError(tag)


def _u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def _raw_alpha(alpha: np.ndarray, method: int) -> bytes:
    """An ALPH payload: raw (compression 0) alpha under filter ``method``
    (0 none, 1 horizontal, 2 vertical, 3 gradient), as libwebp's filters
    predict (the first row from the left, the first column from above)."""
    a = alpha.astype(np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    if method:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        if method == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif method == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return bytes([method << 2]) + ((a - pred) & 255).astype(np.uint8).tobytes()


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return bytes([flags, 0, 0, 0]) + _u24(w - 1) + _u24(h - 1)


class _BoolEncoder:
    """VP8's boolean encoder (RFC 6386, 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob, bit):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def flush(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def vp8_with_filter(data: bytes, simple: int, sharpness: int) -> bytes:
    """A lossy WebP with its VP8 frame header's loop filter type and
    sharpness rewritten: the first partition's reads are replayed through
    a boolean encoder with those bits changed (PIL's encoder always writes
    the normal filter at sharpness 0). Every other read keeps its bit."""
    from reranking_multimodal_retrievers_tpu_torch.data import webp

    vp8 = _webp_chunk(data, b"VP8 ")
    part0 = (vp8[0] | vp8[1] << 8 | vp8[2] << 16) >> 5
    reads = []
    original = webp._Bool.get

    def logged(self, prob):
        bit = original(self, prob)
        if self.data is vp8 and self.end == 10 + part0:
            reads.append([prob, bit])
        return bit

    webp._Bool.get = logged
    try:
        webp._vp8(vp8)
    finally:
        webp._Bool.get = original
    bits = [b for _, b in reads]
    at = 3  # colour space, clamping, segmentation
    if bits[2]:
        update_map, update_data = bits[3], bits[4]
        at = 5
        if update_data:
            at += 1
            for width in (7, 7, 7, 7, 6, 6, 6, 6):
                at += 1 + (width + 1) * bits[at]
        if update_map:
            for _ in range(3):
                at += 1 + 8 * bits[at]
    reads[at][1] = simple
    for k in range(3):  # the sharpness, 3 bits after the 6-bit level
        reads[at + 7 + k][1] = (sharpness >> (2 - k)) & 1
    enc = _BoolEncoder()
    for prob, bit in reads:
        enc.put(prob, bit)
    first = enc.flush()
    tag = (vp8[0] | vp8[1] << 8 | vp8[2] << 16) & 0x1F | (len(first) << 5)
    new = struct.pack("<I", tag)[:3] + vp8[3:10] + first + vp8[10 + part0:]
    return _riff_webp([(b"VP8 ", new)])


def webp_cases():
    """(name, bytes) of WebP files: lossy at qualities 0, 75 and 100 and
    methods 0 and 6; lossless with every transform (a photo: predictor,
    cross colour and subtract green; 200, 12, 3 and 2 colours: colour
    indexing without and with pixel bundling); alpha (VP8L-compressed with
    libwebp's own filter choice, and raw under each of the four filters);
    animations (PIL's, and a first frame smaller than its canvas at an
    offset); sizes 1x1, odd and 300x200."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 4)
    photo = _photo(rng, 200, 300)
    small = photo[:37, :53]
    for q in (0, 75, 100):
        for m in (0, 6):
            yield f"lossy_q{q}_m{m}.webp", _webp(small, quality=q, method=m)
    yield "lossy_300x200.webp", _webp(photo, quality=75, method=4)
    for simple, sharpness in ((1, 0), (0, 3), (1, 6)):
        yield (f"lossy_{'simple' if simple else 'normal'}_filter_sharpness{sharpness}.webp",
               vp8_with_filter(_webp(small, quality=60), simple, sharpness))
    yield "lossy_1x1.webp", _webp(photo[:1, :1], quality=75)
    # smooth images: method 0 takes the predictor and subtract green, method
    # 6 the predictor and cross colour (noisy ones take no transform)
    yy, xx = np.mgrid[0:61, 0:77]
    smooth = np.stack([128 + 100 * np.sin(xx / 9 + yy / 17), 128 + 80 * np.cos(yy / 7 - xx / 23),
                       100 + xx + yy], -1) + rng.normal(0, 1, (61, 77, 3))
    smooth = np.clip(smooth, 0, 255).astype(np.uint8)
    yield "lossless_photo.webp", _webp(smooth[:37, :53], lossless=True, method=0)
    yield "lossless_photo_m6.webp", _webp(smooth, lossless=True, method=6, quality=100)
    yield "lossless_noise.webp", _webp(small, lossless=True)
    yield "lossless_1x1.webp", _webp(photo[:1, :1], lossless=True)
    for n in (200, 12, 3, 2):
        palette = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        idx = rng.integers(0, n, (29, 45))
        yield f"lossless_{n}colors.webp", _webp(palette[idx], lossless=True)
    ramp = np.add.outer(np.arange(37) * 5, np.arange(53) * 3)
    alpha = np.clip(ramp + rng.integers(0, 9, (37, 53)), 0, 255).astype(np.uint8)
    rgba = np.concatenate([small, alpha[..., None]], -1)
    yield "alpha_lossy.webp", _webp(rgba, "RGBA", quality=70, method=4)
    yield "alpha_lossy_m0.webp", _webp(rgba, "RGBA", quality=70, method=0)
    yield "alpha_quality50.webp", _webp(rgba, "RGBA", quality=70, alpha_quality=50)
    yield "alpha_lossless.webp", _webp(rgba, "RGBA", lossless=True, exact=True)
    vp8 = _webp_chunk(_webp(small, quality=75), b"VP8 ")
    for method in range(4):
        yield f"alpha_raw_filter{method}.webp", _riff_webp(
            [(b"VP8X", _vp8x(0x10, 53, 37)), (b"ALPH", _raw_alpha(alpha, method)), (b"VP8 ", vp8)])
    frames = [Image.fromarray(np.roll(small, 7 * k, axis=1)) for k in range(3)]
    for lossless in (False, True):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=40,
                       lossless=lossless, quality=75)
        yield f"animated_{'lossless' if lossless else 'lossy'}.webp", buf.getvalue()
    # a first frame of 21x15 at (6, 4) on a 53x37 canvas, VP8L with alpha
    part = np.concatenate([small[:15, :21], alpha[:15, :21, None]], -1)
    vp8l = _webp_chunk(_webp(part, "RGBA", lossless=True, exact=True), b"VP8L")
    anmf = _u24(3) + _u24(2) + _u24(20) + _u24(14) + _u24(40) + b"\0" + b"VP8L" + \
        struct.pack("<I", len(vp8l)) + vp8l + b"\0" * (len(vp8l) & 1)
    yield "animated_offset.webp", _riff_webp(
        [(b"VP8X", _vp8x(0x12, 53, 37)), (b"ANIM", b"\0\0\0\0\0\0"), (b"ANMF", anmf)])


def write_webp(images):
    """``webp_images/`` and ``m2kr_images_webp/`` (each M2KR image
    re-encoded as WebP under its own name: lossy, lossless and lossy with
    alpha in turn); returns their pixel digests as PIL decodes them."""
    from PIL import Image

    os.makedirs(WEBP, exist_ok=True)
    os.makedirs(IMAGES_WEBP, exist_ok=True)
    digests = {"webp_images": {}, "m2kr_images_webp": {}}
    for name, data in webp_cases():
        with open(os.path.join(WEBP, name), "wb") as f:
            f.write(data)
        with Image.open(os.path.join(WEBP, name)) as img:
            digests["webp_images"][name] = pixels_digest(np.asarray(img.convert("RGB")))
    for k, name in enumerate(sorted(images)):
        with Image.open(os.path.join(IMAGES, name)) as img:
            rgb = np.asarray(img.convert("RGB"))
        kind = k % 3
        if kind == 0:
            data = _webp(rgb, quality=80)
        elif kind == 1:
            data = _webp(rgb, lossless=True)
        else:
            ramp = (np.arange(rgb.shape[1]) * 7 % 256).astype(np.uint8)
            alpha = np.broadcast_to(ramp, rgb.shape[:2])[..., None]
            data = _webp(np.concatenate([rgb, alpha], -1), "RGBA", quality=80)
        with open(os.path.join(IMAGES_WEBP, name), "wb") as f:
            f.write(data)
        with Image.open(os.path.join(IMAGES_WEBP, name)) as img:
            digests["m2kr_images_webp"][name] = pixels_digest(np.asarray(img.convert("RGB")))
    return digests


def write_snapshot_v2():
    """``m2kr_snapshot_v2/``: the snapshot's files re-encoded on data pages
    v2 without dictionaries: the passages in ZSTD (level 19), the questions
    in LZ4_RAW, strings by DELTA_BYTE_ARRAY, lists of strings by
    DELTA_LENGTH_BYTE_ARRAY (the snapshot has no numeric column for
    BYTE_STREAM_SPLIT), its README as it is. The rows are the same."""
    import shutil

    import pyarrow as pa
    import pyarrow.parquet as pq

    for dirpath, _, files in sorted(os.walk(SNAPSHOT)):
        out_dir = os.path.join(SNAPSHOT_V2, os.path.relpath(dirpath, SNAPSHOT))
        os.makedirs(out_dir, exist_ok=True)
        for f in sorted(files):
            src = os.path.join(dirpath, f)
            if not f.endswith(".parquet"):
                shutil.copyfile(src, os.path.join(out_dir, f))
                continue
            table = pq.read_table(src)
            encodings = {}
            for field in table.schema:
                if pa.types.is_list(field.type):
                    encodings[f"{field.name}.list.element"] = "DELTA_LENGTH_BYTE_ARRAY"
                else:
                    encodings[field.name] = "DELTA_BYTE_ARRAY"
            passages = "passages" in f
            pq.write_table(table, os.path.join(out_dir, f),
                           compression="zstd" if passages else "lz4",
                           compression_level=19 if passages else None,
                           use_dictionary=False, data_page_version="2.0",
                           column_encoding=encodings)


# --------------------------------------------- arithmetic-coded and lossless JPEGs
# Encoders for the JPEG codings PIL reads but does not write: arithmetic-coded
# DCT, sequential (SOF9) and progressive (SOF10), after libjpeg's jcarith.c,
# and Huffman-coded lossless (SOF3). PIL's decoding of what they write is the
# fixture's digest.
JPEG_CODING = os.path.join(HERE, "jpeg_coding")
_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
           34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
           37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
_LUMA_Q = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40,
           57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35,
           55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
           100, 103, 99]


def _qm_table():
    sys_path = os.path.dirname(os.path.dirname(HERE))
    import sys

    sys.path.insert(0, sys_path)
    from reranking_multimodal_retrievers_tpu_torch.data.jpeg_coding import QE

    return QE


class QMEncoder:
    """T.81 Annex D's arithmetic encoder as libjpeg's ``jcarith.c`` runs it
    (``arith_encode``, ``finish_pass``), byte stuffing included."""

    def __init__(self):
        self.qe = _qm_table()
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def encode(self, stats, i, val):
        sv = stats[i]
        qe, nl, nm, sw = self.qe[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ (nl | (sw << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self.out.append(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self.out.append(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self.out.append(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            b1 = (self.c >> 19) & 0xFF
            self.out.append(b1)
            if b1 == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                b2 = (self.c >> 11) & 0xFF
                self.out.append(b2)
                if b2 == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dct_coefficients(plane: np.ndarray, by: int, bx: int, qt) -> np.ndarray:
    """[by, bx, 64] quantized DCT coefficients (natural order) of ``plane``
    padded by edge replication to by x bx blocks."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64) - 128, ((0, by * 8 - h), (0, bx * 8 - w)), mode="edge")
    n = np.arange(8)
    basis = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    basis[0] /= np.sqrt(2)
    blocks = p.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ux,abxy,vy->abuv", basis, blocks, basis).reshape(by, bx, 64)
    return np.round(coef / np.asarray(qt, np.float64)).astype(np.int64)


def _ycbcr(img: np.ndarray):
    r, g, b = (img[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return [np.clip(np.round(x), 0, 255) for x in (y, cb, cr)]


def _ac_first(enc, st, fixed, blk, ss, se, al, kx):
    """jcarith.c's ``encode_mcu_AC_first`` (and the sequential AC, at Al 0)."""
    def pt(v):
        return v >> al if v >= 0 else -((-v) >> al)
    ke = se
    while ke > 0 and pt(blk[_ZIGZAG[ke]]) == 0:
        ke -= 1
    k = ss
    while k <= ke:
        s = 3 * (k - 1)
        enc.encode(st, s, 0)
        while True:
            v = pt(blk[_ZIGZAG[k]])
            if v:
                enc.encode(st, s + 1, 1)
                enc.encode(fixed, 0, 1 if v < 0 else 0)
                v = abs(v)
                break
            enc.encode(st, s + 1, 0)
            s += 3
            k += 1
        s += 2
        m = 0
        v -= 1
        if v:
            enc.encode(st, s, 1)
            m = 1
            v2 = v >> 1
            if v2:
                enc.encode(st, s, 1)
                m <<= 1
                s = 189 if k <= kx else 217
                v2 >>= 1
                while v2:
                    enc.encode(st, s, 1)
                    m <<= 1
                    s += 1
                    v2 >>= 1
        enc.encode(st, s, 0)
        s += 14
        m >>= 1
        while m:
            enc.encode(st, s, 1 if m & v else 0)
            m >>= 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _ac_refine(enc, st, fixed, blk, ss, se, ah, al):
    """jcarith.c's ``encode_mcu_AC_refine``."""
    absl = [abs(blk[_ZIGZAG[k]]) >> al for k in range(64)]
    k = se
    while k > 0 and not absl[k]:
        k -= 1
    eob = k
    while k > 0 and not (abs(blk[_ZIGZAG[k]]) >> ah):
        k -= 1
    eobx = k
    k = ss
    while k <= eob:
        s = 3 * (k - 1)
        if k > eobx:
            enc.encode(st, s, 0)
        while True:
            t = absl[k]
            if t:
                if t >> 1:
                    enc.encode(st, s + 2, t & 1)
                else:
                    enc.encode(st, s + 1, 1)
                    enc.encode(fixed, 0, 1 if blk[_ZIGZAG[k]] < 0 else 0)
                break
            enc.encode(st, s + 1, 0)
            s += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _dc_encode(enc, st, ctx, v, lu):
    """jcarith.c's DC difference coding; returns the next context."""
    if v == 0:
        enc.encode(st, ctx, 0)
        return 0
    enc.encode(st, ctx, 1)
    if v > 0:
        enc.encode(st, ctx + 1, 0)
        s, nctx = ctx + 2, 4
    else:
        v = -v
        enc.encode(st, ctx + 1, 1)
        s, nctx = ctx + 3, 8
    m = 0
    v -= 1
    if v:
        enc.encode(st, s, 1)
        m = 1
        v2 = v
        s = 20
        v2 >>= 1
        while v2:
            enc.encode(st, s, 1)
            m <<= 1
            s += 1
            v2 >>= 1
    enc.encode(st, s, 0)
    if m < (1 << lu[0]) >> 1:
        nctx = 0
    elif m > (1 << lu[1]) >> 1:
        nctx += 8
    s += 14
    m >>= 1
    while m:
        enc.encode(st, s, 1 if m & v else 0)
        m >>= 1
    return nctx


def arith_jpeg_bytes(img: np.ndarray, progressive: bool, sampling=(1, 1), restart: int = 0,
                     dac=None) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with libjpeg's default
    progressive script) of a grey [H, W] or RGB [H, W, 3] image: YCbCr with
    the chroma sampled by ``sampling`` (h, v of luma), ``restart`` MCUs a
    restart interval, ``dac``: ((L, U), K) conditioning in a DAC marker."""
    grey = img.ndim == 2
    planes = [img.astype(np.float64)] if grey else _ycbcr(img)
    h, w = img.shape[:2]
    hs, vs = (1, 1) if grey else sampling
    comps = [(1, hs, vs, 0)] + ([] if grey else [(2, 1, 1, 1), (3, 1, 1, 1)])
    mcux, mcuy = -(-w // (8 * hs)), -(-h // (8 * vs))
    qts = [_LUMA_Q, [min(255, q * 2) for q in _LUMA_Q]]
    coefs = []
    for (cid, ch, cv, tq), plane in zip(comps, planes):
        if (ch, cv) != (hs, vs):  # box-filtered chroma
            ph, pw = -(-h // vs) * vs, -(-w // hs) * hs
            p = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
            plane = p.reshape(ph // vs, vs, pw // hs, hs).mean((1, 3))
        coefs.append(_dct_coefficients(plane, mcuy * cv, mcux * ch, [qts[tq][k] for k in
                                                                      range(64)]))
    lu, kx = dac if dac else ((0, 1), 5)
    head = b"\xff\xd8"
    if not grey:
        head += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    for t in range(1 if grey else 2):
        zz = [qts[t][n] for n in _ZIGZAG]
        head += _segment(0xDB, bytes([t]) + bytes(zz))
    head += _segment(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, h, w, len(comps))
                     + b"".join(bytes([cid, (ch << 4) | cv, tq]) for cid, ch, cv, tq in comps))
    if dac:
        head += _segment(0xCC, b"".join(bytes([(tc << 4) | t, cs]) for t in range(2)
                                        for tc, cs in ((0, (lu[1] << 4) | lu[0]), (1, kx))))
    if restart:
        head += _segment(0xDD, struct.pack(">H", restart))
    if grey:
        script = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                  ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]
    else:
        script = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                  ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                  ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                  ((0,), 1, 63, 1, 0)]
    if not progressive:
        script = [(tuple(range(len(comps))), 0, 63, 0, 0)]
    out = bytearray(head)
    for cs, ss, se, ah, al in script:
        selectors = b"".join(bytes([comps[c][0], (c > 0) * 0x11]) for c in cs)
        out += _segment(0xDA, bytes([len(cs)]) + selectors + bytes([ss, se, ah << 4 | al]))
        units = []  # (component, block row, block column) in coding order
        if len(cs) == 1:
            c = cs[0]
            bx = -(-(-(-w * comps[c][1] // hs)) // 8)
            by = -(-(-(-h * comps[c][2] // vs)) // 8)
            units = [[(c, r, col)] for r in range(by) for col in range(bx)]
        else:
            for my in range(mcuy):
                for mx in range(mcux):
                    units.append([(c, my * comps[c][2] + yy, mx * comps[c][1] + xx)
                                  for c in cs for yy in range(comps[c][2])
                                  for xx in range(comps[c][1])])
        per = restart or len(units)
        for i in range(0, len(units), per):
            if i:
                out += bytes([0xFF, 0xD0 + (i // per - 1) % 8])
            enc = QMEncoder()
            fixed = [113]
            dc_st = {t: [0] * 64 for t in range(2)}
            ac_st = {t: [0] * 256 for t in range(2)}
            last, ctx = {}, {}
            for mcu in units[i:i + per]:
                for c, r, col in mcu:
                    blk = coefs[c][r, col].tolist()
                    t = int(c > 0)
                    if ss == 0 and ah == 0:
                        dc = blk[0] >> al
                        ctx[c] = _dc_encode(enc, dc_st[t], ctx.get(c, 0), dc - last.get(c, 0), lu)
                        last[c] = dc
                        if not progressive:
                            _ac_first(enc, ac_st[t], fixed, blk, 1, 63, 0, kx)
                    elif ss == 0:
                        enc.encode(fixed, 0, (blk[0] >> al) & 1)
                    elif ah == 0:
                        _ac_first(enc, ac_st[t], fixed, blk, ss, se, al, kx)
                    else:
                        _ac_refine(enc, ac_st[t], fixed, blk, ss, se, ah, al)
            out += enc.finish()
    return bytes(out + b"\xff\xd9")


# a Huffman code for lossless differences of categories 0..16 (lengths 2..14)
_LOSSLESS_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
_LOSSLESS_SYMBOLS = list(range(17))


def lossless_jpeg_bytes(img: np.ndarray, predictor: int, pt: int = 0, restart_rows: int = 0,
                        colour: str = "rgb", interleaved: bool = True) -> bytes:
    """A Huffman-coded lossless JPEG (SOF3) of a grey [H, W] or RGB [H, W, 3]
    image: predictor 1-7, point transform ``pt``, a restart every
    ``restart_rows`` rows; three components as ``colour`` "rgb" (an Adobe
    marker with transform 0) or "ycbcr" (JFIF), in one interleaved scan or
    one scan each."""
    grey = img.ndim == 2
    h, w = img.shape[:2]
    if grey:
        planes = [img.astype(np.int64)]
    elif colour == "rgb":
        planes = [img[..., i].astype(np.int64) for i in range(3)]
    else:
        planes = [p.astype(np.int64) for p in _ycbcr(img)]
    codes, code, k = {}, 0, 0
    for length, n in enumerate(_LOSSLESS_COUNTS, 1):
        for _ in range(n):
            codes[_LOSSLESS_SYMBOLS[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    out = bytearray(b"\xff\xd8")
    if not grey:
        out += (_segment(0xEE, b"Adobe\0\x64\0\0\0\0\0") if colour == "rgb"
                else _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0"))
    out += _segment(0xC3, struct.pack(">BHHB", 8, h, w, len(planes))
                    + b"".join(bytes([i + 1, 0x11, 0]) for i in range(len(planes))))
    out += _segment(0xC4, b"\x00" + bytes(_LOSSLESS_COUNTS) + bytes(_LOSSLESS_SYMBOLS))
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * w))
    scans = [list(range(len(planes)))] if interleaved else [[c] for c in range(len(planes))]
    for cs in scans:
        out += _segment(0xDA, bytes([len(cs)]) + b"".join(bytes([c + 1, 0]) for c in cs)
                        + bytes([predictor, 0, pt]))
        x = [p >> pt for p in planes]
        rows_per = restart_rows or h
        for r0 in range(0, h, rows_per):
            if r0:
                out += bytes([0xFF, 0xD0 + (r0 // rows_per - 1) % 8])
            acc, nacc, seg = 0, 0, bytearray()
            for y in range(r0, min(h, r0 + rows_per)):
                for xx in range(w):
                    for c in cs:
                        p = x[c]
                        if y == r0:
                            pred = p[y, xx - 1] if xx else 1 << (8 - pt - 1)
                        elif xx == 0:
                            pred = p[y - 1, 0]
                        else:
                            ra, rb, rc = int(p[y, xx - 1]), int(p[y - 1, xx]), int(p[y - 1, xx - 1])
                            pred = [ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                                    rb + ((ra - rc) >> 1), (ra + rb) >> 1][predictor - 1]
                        d = (int(p[y, xx]) - int(pred)) & 0xFFFF
                        d = d - 0x10000 if d > 0x8000 else d
                        s = abs(d).bit_length()
                        cw, cl = codes[s]
                        acc, nacc = (acc << cl) | cw, nacc + cl
                        if 0 < s < 16:
                            acc, nacc = (acc << s) | ((d if d > 0 else d + (1 << s) - 1)
                                                      & ((1 << s) - 1)), nacc + s
                        while nacc >= 8:
                            byte = (acc >> (nacc - 8)) & 0xFF
                            seg.append(byte)
                            if byte == 0xFF:
                                seg.append(0)
                            nacc -= 8
            if nacc:
                byte = ((acc << (8 - nacc)) | ((1 << (8 - nacc)) - 1)) & 0xFF
                seg.append(byte)
                if byte == 0xFF:
                    seg.append(0)
            out += seg
    return bytes(out + b"\xff\xd9")


def jpeg_coding_cases():
    """(name, bytes) of the arithmetic-coded and lossless JPEG fixtures."""
    rng = np.random.default_rng(SEED + 9)
    cases = []
    for i, (h, w) in enumerate([(37, 53), (16, 16), (9, 70)]):
        rgb = _photo(rng, h, w)
        grey = rgb[..., 1].copy()
        cases += [
            (f"arith_seq_444_{i}.jpg", arith_jpeg_bytes(rgb, False)),
            (f"arith_seq_420_rst_{i}.jpg", arith_jpeg_bytes(rgb, False, (2, 2), restart=2)),
            (f"arith_seq_grey_dac_{i}.jpg", arith_jpeg_bytes(grey, False, dac=((1, 3), 3))),
            (f"arith_prog_422_{i}.jpg", arith_jpeg_bytes(rgb, True, (2, 1))),
            (f"arith_prog_444_rst_dac_{i}.jpg", arith_jpeg_bytes(rgb, True, restart=3,
                                                                 dac=((2, 4), 8))),
            (f"arith_prog_grey_{i}.jpg", arith_jpeg_bytes(grey, True)),
        ]
        if i == 0:  # libjpeg-turbo converts no lossless YCbCr: PIL refuses it
            cases.append(("refused_lossless_ycbcr.jpg",
                          lossless_jpeg_bytes(rgb, 4, colour="ycbcr")))
        for p in range(1, 8):
            cases.append((f"lossless_rgb_p{p}_{i}.jpg", lossless_jpeg_bytes(
                rgb, p, pt=p % 3 == 0, restart_rows=4 if p % 2 else 0)))
        cases += [(f"lossless_grey_p7_{i}.jpg", lossless_jpeg_bytes(grey, 7, pt=2)),
                  (f"lossless_rgb_scans_p6_{i}.jpg", lossless_jpeg_bytes(
                      rgb, 6, restart_rows=3, interleaved=False))]
    return cases


def write_jpeg_coding():
    """``jpeg_coding/``: :func:`jpeg_coding_cases`, and the digests of
    PIL's pixels of each (none for a ``refused_`` file, which PIL cannot
    decode)."""
    from PIL import Image

    os.makedirs(JPEG_CODING, exist_ok=True)
    digests = {}
    for name, data in jpeg_coding_cases():
        path = os.path.join(JPEG_CODING, name)
        with open(path, "wb") as f:
            f.write(data)
        if not name.startswith("refused_"):
            with Image.open(path) as img:
                digests[name] = pixels_digest(np.asarray(img.convert("RGB")))
    return digests


def main():
    import pyarrow.parquet as pq
    from PIL import Image

    os.makedirs(IMAGES, exist_ok=True)
    images = []
    for name, data in image_cases():
        with open(os.path.join(IMAGES, name), "wb") as f:
            f.write(data)
        images.append(name)
    write_snapshot(images)
    write_variants()
    write_codec_variants()
    write_refused_and_handmade()
    write_temporal_and_brotli()
    write_snapshot_v2()
    digests = {"tables": {}, "images": {}}
    for root in (SNAPSHOT, SNAPSHOT_V2, VARIANTS):
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                if f.endswith(".parquet") and not f.startswith("refused_"):
                    p = os.path.join(dirpath, f)
                    digests["tables"][os.path.relpath(p, HERE)] = rows_digest(
                        pq.read_table(p).to_pylist())
    for name in images:
        with Image.open(os.path.join(IMAGES, name)) as img:
            digests["images"][name] = pixels_digest(np.asarray(img.convert("RGB")))
    os.makedirs(CODECS, exist_ok=True)
    digests["codec_images"] = {}
    for name, data in codec_cases():
        with open(os.path.join(CODECS, name), "wb") as f:
            f.write(data)
        with Image.open(os.path.join(CODECS, name)) as img:
            digests["codec_images"][name] = pixels_digest(np.asarray(img.convert("RGB")))
    digests["image_columns"] = {
        os.path.relpath(IMAGE_COLUMN, HERE): write_image_column(sorted(digests["codec_images"]))}
    digests["tokenizer"] = write_tokenizer()
    digests.update(write_webp(images))
    digests["jpeg_coding"] = write_jpeg_coding()
    with open(DIGESTS, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
