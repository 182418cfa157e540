"""``data/image_codecs.py``'s GIF, BMP and TIFF decoders (through
``data/image_io.py``'s ``read_image``/``decode_image``) against PIL 12.1's
``Image.open(p).convert("RGB")``, bitwise, on every variant they take,
written here by ``tests/fixtures/make_m2kr_parquet.py``'s ``gif_bytes``,
``bmp_bytes`` and ``tiff_bytes``; the committed files against their
digests; the variants they refuse raise naming them, and the formats still
left to PIL raise naming the format where PIL is absent. Then a
``datasets`` ``Image`` column, written by ``datasets`` to a
``save_to_disk`` directory and to parquet, read by ``arrow_io`` and
``parquet_io`` against ``datasets``' own decoding (then ``convert("RGB")``,
as the JAX package's loaders take images)."""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
PIL_Image = pytest.importorskip("PIL.Image")

from reranking_multimodal_retrievers_tpu_torch.data import (  # noqa: E402
    arrow_io, image_codecs, image_io, parquet_io)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "fixtures"))
try:
    import make_m2kr_parquet as fx  # noqa: E402
finally:
    sys.path.pop(0)
with open(fx.DIGESTS) as _f:
    DIGESTS = json.load(_f)


def _pil(data: bytes) -> np.ndarray:
    with PIL_Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


def _same_as_pil(data: bytes) -> None:
    want = _pil(data)
    got = image_io.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ GIF
GIF_CASES = ["plain", "interlaced", "offset", "offset_transparency", "overhang", "local",
             "local_only", "no_palette", "lzw_clears", "one_pixel"]


@pytest.mark.parametrize("case", GIF_CASES)
def test_gif_variant_is_bitwise_pil(case):
    rng = np.random.default_rng(GIF_CASES.index(case))
    pal = rng.integers(0, 256, (7, 3), dtype=np.uint8)
    frame = rng.integers(0, 7, (13, 17)).astype(np.uint8)
    local = rng.integers(0, 256, (5, 3), dtype=np.uint8)
    data = {
        "plain": lambda: fx.gif_bytes(frame, pal),
        "interlaced": lambda: fx.gif_bytes(rng.integers(0, 7, (37, 5)).astype(np.uint8), pal,
                                           interlace=True),
        "offset": lambda: fx.gif_bytes(frame, pal, screen=(25, 19), offset=(3, 2),
                                       background=5),
        "offset_transparency": lambda: fx.gif_bytes(frame, pal, screen=(25, 19),
                                                    offset=(3, 2), transparency=4),
        "overhang": lambda: fx.gif_bytes(frame, pal, screen=(8, 8), offset=(1, 2)),
        "local": lambda: fx.gif_bytes(frame % 5, pal, local_palette=local),
        "local_only": lambda: fx.gif_bytes(frame % 5, None, local_palette=local,
                                           screen=(20, 20)),
        "no_palette": lambda: fx.gif_bytes(frame, None),
        "lzw_clears": lambda: fx.gif_bytes(rng.integers(0, 256, (70, 64)).astype(np.uint8),
                                           rng.integers(0, 256, (256, 3), dtype=np.uint8)),
        "one_pixel": lambda: fx.gif_bytes(frame[:1, :1], pal),
    }[case]()
    _same_as_pil(data)


def test_truncated_gif_raises_as_pil_raises():
    """A stream cut short, a file cut short and an end code before the
    frame's last pixel all raise, in PIL and here."""
    rng = np.random.default_rng(5)
    data = fx.gif_bytes(rng.integers(0, 256, (64, 64)).astype(np.uint8),
                        rng.integers(0, 256, (256, 3), dtype=np.uint8), truncate=700)
    frame = rng.integers(0, 7, (13, 17)).astype(np.uint8)
    whole = fx.gif_bytes(frame, rng.integers(0, 256, (7, 3), dtype=np.uint8))
    at = 13 + 3 * 8  # the image descriptor, after the 8-entry global palette
    assert whole[at] == 0x2C
    body = fx._pack_codes(fx._lzw_codes(frame.tobytes()[:100], 3), 3, msb=False, early=0)
    early_end = whole[:at + 10] + bytes([3, len(body)]) + body + b"\0;"
    for cut in (data, data[:len(data) // 3], early_end):
        with pytest.raises(OSError, match="truncated|cannot identify"):
            _pil(cut)
        with pytest.raises(OSError, match="truncated|ends before its last pixel"):
            image_io.decode_image(cut)


# ------------------------------------------------------------------ BMP
BMP_CASES = [(bits, kw) for bits in (1, 4, 8)
             for kw in ("plain", "top_down", "core")] + \
            [(bits, kw) for bits in (4, 8) for kw in ("rle", "rle_delta", "rle_short_runs")] + \
            [(bits, kw) for bits in (16, 24, 32) for kw in ("plain", "top_down")] + \
            [(16, "565"), (16, "555_bitfields"), (8, "short_palette")]


@pytest.mark.parametrize("bits,case", BMP_CASES, ids=lambda v: str(v))
def test_bmp_variant_is_bitwise_pil(bits, case):
    rng = np.random.default_rng(bits * 10 + len(case))
    for h, w in ((1, 1), (7, 13), (16, 31), (5, 34)):
        if bits <= 8:
            pal = rng.integers(0, 256, ((4 if case == "short_palette" else 1 << bits), 3),
                               dtype=np.uint8)
            idx = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
            if case.startswith("rle"):
                reps = 1 if case == "rle_short_runs" else 3
                idx = np.repeat(idx, reps, axis=1)[:, :w + 2]
            kw = {"top_down": case == "top_down", "core": case == "core",
                  "rle": case.startswith("rle"), "delta": case == "rle_delta"}
            _same_as_pil(fx.bmp_bytes(idx, bits, pal, **kw))
        else:
            px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            masks = {"565": (0xF800, 0x7E0, 0x1F), "555_bitfields": (0x7C00, 0x3E0, 0x1F)}
            _same_as_pil(fx.bmp_bytes(px, bits, top_down=case == "top_down",
                                      masks=masks.get(case)))


# ------------------------------------------------------------------ TIFF
TIFF_KINDS = ["rgb", "rgba", "rgba_unassociated", "rgba_associated", "rgb_extra_none", "grey8",
              "grey8_white", "grey16", "grey16_white", "bit1", "bit1_white", "palette", "cmyk"]
TIFF_STORAGE = [(comp, pred) for comp in (1, 32773, 5, 8, 32946) for pred in (1, 2)] + \
               [("old_lzw", 1), ("old_lzw", 2)]
# libtiff refuses the predictor on 1-bit samples where it applies it
TIFF_CASES = [(kind, comp, pred) for comp, pred in TIFF_STORAGE for kind in TIFF_KINDS
              if not (kind.startswith("bit1") and pred == 2 and comp not in (1, 32773))]


def _tiff_samples(kind, rng, h, w):
    if kind.startswith("rgba"):
        return rng.integers(0, 256, (h, w, 4)).astype(np.uint8), 8, 2
    if kind == "rgb_extra_none":
        return rng.integers(0, 256, (h, w, 4)).astype(np.uint8), 8, 2
    if kind == "rgb":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8), 8, 2
    if kind.startswith("grey16"):
        return rng.integers(0, 700, (h, w, 1)).astype(np.uint16), 16, int(kind == "grey16")
    if kind.startswith("bit1"):
        return rng.integers(0, 2, (h, w, 1)).astype(np.uint8), 1, int(kind == "bit1")
    if kind == "cmyk":
        return rng.integers(0, 256, (h, w, 4)).astype(np.uint8), 8, 5
    photometric = {"grey8": 1, "grey8_white": 0, "palette": 3}[kind]
    return rng.integers(0, 256, (h, w, 1)).astype(np.uint8), 8, photometric


@pytest.mark.parametrize("kind,comp,pred", TIFF_CASES, ids=lambda v: str(v))
def test_tiff_variant_is_bitwise_pil(kind, comp, pred):
    rng = np.random.default_rng([TIFF_KINDS.index(kind), TIFF_STORAGE.index((comp, pred))])
    extra = {"rgba": None, "rgba_unassociated": 2, "rgba_associated": 1,
             "rgb_extra_none": 0}.get(kind)
    cmap = rng.integers(0, 65536, (256, 3)) if kind == "palette" else None
    for (h, w), be, planar, tile in (((19, 21), False, 1, None), ((19, 21), True, 1, (16, 16)),
                                      ((33, 17), False, 2, None), ((20, 40), True, 2, (16, 32))):
        if planar == 2 and (kind in ("rgba", "rgba_associated", "rgb_extra_none")
                            or kind.startswith(("grey", "bit1", "palette"))):
            continue  # planar RGBA only as PIL reads it; one-sample images have no planes
        samples, bits, photometric = _tiff_samples(kind, rng, h, w)
        data = fx.tiff_bytes(samples, bits, photometric, big_endian=be,
                             compression=5 if comp == "old_lzw" else comp, predictor=pred,
                             planar=planar, tile=tile, rows_per_strip=6, colormap=cmap,
                             extra_samples=extra, old_lzw=comp == "old_lzw")
        if kind == "grey16_white" and be:  # PIL cannot open it, and the port refuses it
            with pytest.raises(OSError):
                _pil(data)
            with pytest.raises(NotImplementedError, match="big-endian 16-bit min-is-white"):
                image_io.decode_image(data)
            continue
        _same_as_pil(data)


@pytest.mark.parametrize("patch,named", [
    ({259: 7}, "JPEG compression"), ({259: 4}, "CCITT G4 compression"),
    ({262: 6}, "YCbCr"), ({339: 3}, "sample format"), ({317: 3}, "predictor 3"),
    ({266: 2}, "fill order 2"), ({338: 0, 284: 2}, "planar RGB with extra sample 0")])
def test_tiff_variants_not_taken_raise_naming_them(patch, named):
    """A tag rewritten in place (the value fits the entry) makes a variant
    the decoder does not take; it raises naming it, and never asks PIL."""
    rng = np.random.default_rng(1)
    four = 338 in patch
    data = bytearray(fx.tiff_bytes(rng.integers(0, 256, (8, 8, 4 if four else 3))
                                   .astype(np.uint8), 8, 2, extra_samples=0 if four else None,
                                   predictor=1))
    ifd = int.from_bytes(data[4:8], "little")
    n = int.from_bytes(data[ifd:ifd + 2], "little")
    entries = {int.from_bytes(data[ifd + 2 + 12 * k:ifd + 4 + 12 * k], "little"): ifd + 2 + 12 * k
               for k in range(n)}
    for tag, value in patch.items():
        if tag not in entries:  # take over PlanarConfiguration's entry (1, the default)
            at = entries.pop(284)
            data[at:at + 2] = tag.to_bytes(2, "little")
            entries[tag] = at
        at = entries[tag]
        data[at + 2:at + 4] = (3).to_bytes(2, "little")
        data[at + 4:at + 8] = (1).to_bytes(4, "little")
        data[at + 8:at + 12] = value.to_bytes(2, "little") + b"\0\0"
    with pytest.raises(NotImplementedError, match=named):
        image_io.decode_image(bytes(data))


# ------------------------------------------------------- committed files
@pytest.mark.parametrize("name", sorted(DIGESTS["codec_images"]))
def test_committed_codec_images_equal_their_digests_and_pil(name):
    path = os.path.join(fx.CODECS, name)
    got = image_io.read_image(path)
    assert fx.pixels_digest(got) == DIGESTS["codec_images"][name]
    with PIL_Image.open(path) as img:
        np.testing.assert_array_equal(got, np.asarray(img.convert("RGB")))
    with open(path, "rb") as f:
        assert name.split("_")[0].upper() in image_io.image_format(f.read()).upper()


def test_decoders_run_without_pil_and_left_formats_raise_naming_them(tmp_path):
    """With PIL blocked: the committed GIF, BMP and TIFF files equal their
    digests, a WebP decodes to PIL's pixels, and an arithmetic-coded
    lossless JPEG (a format still left to PIL) raises naming it."""
    rng = np.random.default_rng(5)
    pixels = rng.integers(0, 256, (13, 17, 3)).astype(np.uint8)
    webp = io.BytesIO()
    PIL_Image.fromarray(pixels).save(webp, "WEBP", quality=80)
    (tmp_path / "x.webp").write_bytes(webp.getvalue())
    with PIL_Image.open(tmp_path / "x.webp") as img:
        want = fx.pixels_digest(np.asarray(img.convert("RGB")))
    jpeg = io.BytesIO()
    PIL_Image.fromarray(pixels).save(jpeg, "JPEG")
    (tmp_path / "x.jpg").write_bytes(jpeg.getvalue().replace(b"\xff\xc0", b"\xff\xcb", 1))
    code = (
        "import sys, json, os\nsys.modules['PIL'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'tests' / 'fixtures')!r})\n"
        "import make_m2kr_parquet as fx\n"
        "from reranking_multimodal_retrievers_tpu_torch.data import image_io\n"
        "d = json.load(open(fx.DIGESTS))['codec_images']\n"
        "for n, h in d.items():\n"
        "    assert fx.pixels_digest(image_io.read_image(os.path.join(fx.CODECS, n))) == h, n\n"
        "print('decoded', len(d))\n"
        f"print(fx.pixels_digest(image_io.read_image({str(tmp_path / 'x.webp')!r})))\n"
        f"image_io.read_image({str(tmp_path / 'x.jpg')!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.split("\n")[:2] == [f"decoded {len(DIGESTS['codec_images'])}", want], \
        out.stderr[-2000:]
    assert "NotImplementedError" in out.stderr and "an arithmetic-coded lossless JPEG" in out.stderr


# --------------------------------------------------- datasets Image columns
@pytest.fixture(scope="module")
def datasets_mod(tmp_path_factory):
    os.environ.setdefault("HF_DATASETS_CACHE", str(tmp_path_factory.mktemp("hf_cache")))
    return pytest.importorskip("datasets")


def _images(n=5):
    rng = np.random.default_rng(11)
    names = sorted(DIGESTS["codec_images"])
    files = [os.path.join(fx.CODECS, names[int(i)]) for i in rng.choice(len(names), n, False)]
    return files + [os.path.join(fx.IMAGES, "prog_420_17x9.jpg"),
                    os.path.join(fx.IMAGES, "png_c6_d16_adam7.png")]


def _want(ds, column="image"):
    return [np.asarray(im.convert("RGB")) for im in ds[column]]


def test_image_column_in_save_to_disk_equals_datasets(tmp_path, datasets_mod):
    ds_mod = datasets_mod
    files = _images()
    rows = [{"bytes": open(p, "rb").read(), "path": os.path.basename(p)} for p in files]
    rows.append({"bytes": None, "path": files[0]})  # read from the path
    ds = ds_mod.Dataset.from_dict(
        {"image": rows, "album": [[r, r] for r in rows], "k": list(range(len(rows))),
         "framed": [{"pic": r, "tag": "t"} for r in rows],
         "shots": [{"pic": [r, r], "n": [1, 2]} for r in rows]},
        features=ds_mod.Features({
            "image": ds_mod.Image(), "album": ds_mod.Sequence(ds_mod.Image()),
            "k": ds_mod.Value("int64"),
            "framed": {"pic": ds_mod.Image(), "tag": ds_mod.Value("string")},
            "shots": ds_mod.Sequence({"pic": ds_mod.Image(), "n": ds_mod.Value("int64")})}))
    ds_mod.DatasetDict({"train": ds}).save_to_disk(str(tmp_path / "d"))
    want = ds_mod.load_from_disk(str(tmp_path / "d"))["train"]
    got = arrow_io.load_from_disk(str(tmp_path / "d"))["train"]
    for a, b in zip(got["image"], _want(want)):
        np.testing.assert_array_equal(a, b)
    for pair, album in zip(got["album"], want["album"]):
        for a, b in zip(pair, album):
            np.testing.assert_array_equal(a, np.asarray(b.convert("RGB")))
    assert got["k"] == list(range(len(rows)))
    for row, want_row in zip(got["framed"], want["framed"]):  # an image inside a struct
        np.testing.assert_array_equal(row["pic"], np.asarray(want_row["pic"].convert("RGB")))
        assert row["tag"] == want_row["tag"]
    for row, want_row in zip(got["shots"], want["shots"]):  # a sequence of structs
        assert row["n"] == want_row["n"]
        for a, b in zip(row["pic"], want_row["pic"]):
            np.testing.assert_array_equal(a, np.asarray(b.convert("RGB")))
    raw = ds_mod.Dataset.from_dict({"image": rows[:2]},
                                   features=ds_mod.Features({"image": ds_mod.Image(decode=False)}))
    raw.save_to_disk(str(tmp_path / "raw"))
    assert arrow_io.load_from_disk(str(tmp_path / "raw"))["image"] == raw["image"]


def test_image_column_in_parquet_equals_datasets(tmp_path, datasets_mod):
    ds_mod = datasets_mod
    files = _images()
    ds = ds_mod.Dataset.from_dict(
        {"image": [{"bytes": open(p, "rb").read(), "path": None} for p in files],
         "q": [f"q{i}" for i in range(len(files))]},
        features=ds_mod.Features({"image": ds_mod.Image(), "q": ds_mod.Value("string")}))
    path = str(tmp_path / "x.parquet")
    ds.to_parquet(path)
    got = parquet_io.read_parquet(path)
    want = ds_mod.Dataset.from_parquet(path, cache_dir=str(tmp_path / "cache"))
    for a, b in zip(got["image"], _want(want)):
        np.testing.assert_array_equal(a, b)
    assert got["q"] == want["q"]


def test_committed_image_column_equals_its_digest():
    rel = os.path.relpath(fx.IMAGE_COLUMN, fx.HERE)
    table = parquet_io.read_parquet(fx.IMAGE_COLUMN)
    assert fx.images_digest(table["image"]) == DIGESTS["image_columns"][rel]
    assert all(isinstance(i, np.ndarray) and i.dtype == np.uint8 and i.shape[2] == 3
               for i in table["image"])


def test_codec_format_names_each_variant():
    rng = np.random.default_rng(0)
    bmp = fx.bmp_bytes(rng.integers(0, 16, (3, 3)).astype(np.uint8), 4,
                       rng.integers(0, 256, (16, 3), dtype=np.uint8), rle=True)
    assert image_io.image_format(bmp) == "a 4-bit RLE4 BMP with a 40-byte header"
    tif = fx.tiff_bytes(rng.integers(0, 256, (3, 3, 4)).astype(np.uint8), 8, 5, compression=8)
    assert image_io.image_format(tif) == "a Adobe Deflate CMYK TIFF of 4 x 8-bit samples"
    assert image_codecs.codec_format(b"RIFF0000WEBP") is None
