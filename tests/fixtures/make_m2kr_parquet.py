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
  takes, once per codec (none, snappy, gzip), dictionary on and off, data
  page version 1.0 and 2.0, in row groups of 50 rows and 1 KB pages;
- ``m2kr_images/``: the images the questions name, in the formats the port
  decodes without PIL: progressive JPEGs (4:4:4, 4:2:2, 4:2:0, grey,
  optimised Huffman tables, restart markers, odd sizes), progressive files
  whose refinement or AC scans were cut (block smoothing), CMYK and YCCK,
  sequential and progressive, and PNGs (Adam7, 1/2/4/16 bits, grey, palette,
  grey+alpha, RGB, RGBA, ``tRNS``);
- ``digests.json``: the SHA-256 of each parquet file's rows as
  ``pyarrow.parquet.read_table(path).to_pylist()`` gives them
  (:func:`rows_digest`) and of each image's pixels as PIL's
  ``Image.open(path).convert("RGB")`` gives them (:func:`pixels_digest`).

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
SEED = 0
QUESTIONS = {"train": 1024, "valid": 256, "test": 256}
TRAIN_SHARDS = 2
PASSAGES = {"train_passages": 4096, "valid_passages": 2048, "test_passages": 2048}
INSTRUCTIONS = ["Answer the following question with the image:",
                "Using the image, find the passage that answers the question:",
                "Retrieve the document that answers this question about the picture."]


def _bytes_as_hex(obj):
    if isinstance(obj, bytes):
        return {"bytes": obj.hex()}
    raise TypeError(type(obj).__name__)


def rows_digest(rows) -> str:
    """SHA-256 of a table's rows (a list of dicts) as canonical JSON: keys
    sorted, floats in their shortest round-trip form, bytes as hex."""
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
    digests = {"tables": {}, "images": {}}
    for root in (SNAPSHOT, VARIANTS):
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                if f.endswith(".parquet"):
                    p = os.path.join(dirpath, f)
                    digests["tables"][os.path.relpath(p, HERE)] = rows_digest(
                        pq.read_table(p).to_pylist())
    for name in images:
        with Image.open(os.path.join(IMAGES, name)) as img:
            digests["images"][name] = pixels_digest(np.asarray(img.convert("RGB")))
    with open(DIGESTS, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
