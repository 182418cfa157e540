"""``data/webp.py`` against PIL 12.1 (libwebp 1.6), bitwise, on the CPU:
every committed WebP fixture (``tests/fixtures/webp_images`` and the M2KR
images re-encoded in ``tests/fixtures/m2kr_images_webp``, written by
``tests/fixtures/make_m2kr_parquet.py``) to its committed digest and to
``np.asarray(Image.open(f).convert("RGB"))``; lossy files at qualities 0,
75 and 100 and methods 0 and 6, lossless files that use every transform and
every pixel bundling, alpha planes (VP8L-compressed and raw under each
filter) to PIL's RGBA, animations, and sizes 1x1, odd and 300x200; the
sub-format names and the variants that are refused."""

import io
import json
import os
import sys

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

from reranking_multimodal_retrievers_tpu_torch.data import image_io, webp  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures"))
try:
    import make_m2kr_parquet as fx  # noqa: E402
finally:
    sys.path.pop(0)

with open(fx.DIGESTS) as _f:
    DIGESTS = json.load(_f)


def _pil(data: bytes, mode="RGB") -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert(mode))


def _photo(h, w, seed=0):
    return fx._photo(np.random.default_rng(seed), h, w)


@pytest.mark.parametrize("key,name", [(k, n) for k in ("webp_images", "m2kr_images_webp")
                                      for n in sorted(DIGESTS[k])])
def test_committed_webp_equal_their_digests_and_pil(key, name):
    path = os.path.join(fx.WEBP if key == "webp_images" else fx.IMAGES_WEBP, name)
    with open(path, "rb") as f:
        data = f.read()
    got = image_io.read_image(path)
    assert fx.pixels_digest(got) == DIGESTS[key][name]
    np.testing.assert_array_equal(got, _pil(data))
    assert "WebP" in image_io.image_format(data)


@pytest.mark.parametrize("method", [0, 6])
@pytest.mark.parametrize("quality", [0, 75, 100])
@pytest.mark.parametrize("size", [(1, 1), (37, 53), (200, 300)])
def test_lossy_equals_pil(quality, method, size):
    data = fx._webp(_photo(*size, seed=quality + method), quality=quality, method=method)
    assert webp.webp_variant(data) == "a lossy WebP"
    np.testing.assert_array_equal(webp.decode_webp(data), _pil(data))


def test_lossless_fixtures_use_every_transform(monkeypatch):
    """Across the lossless fixtures: the predictor (0), cross colour (1),
    subtract green (2) and colour indexing (3) transforms, colour indexing
    with 1, 2, 4 and 8 pixels a byte, and a colour cache."""
    seen, caches = set(), set()
    undo, entropy = webp._undo_transform, webp._entropy_image

    def record(kind, w, h, bits, sub, pixels):
        seen.add((kind, bits if kind == 3 else None))
        return undo(kind, w, h, bits, sub, pixels)

    def cache_bits(br, xsize, ysize, level0):
        pos = br.pos
        if br.read(1):
            caches.add(br.read(4))
        br.pos = pos
        return entropy(br, xsize, ysize, level0)

    monkeypatch.setattr(webp, "_undo_transform", record)
    monkeypatch.setattr(webp, "_entropy_image", cache_bits)
    for name in sorted(DIGESTS["webp_images"]):
        if name.startswith("lossless"):
            with open(os.path.join(fx.WEBP, name), "rb") as f:
                data = f.read()
            np.testing.assert_array_equal(webp.decode_webp(data), _pil(data))
    assert {(0, None), (1, None), (2, None), (3, 0), (3, 1), (3, 2), (3, 3)} <= seen
    assert caches


@pytest.mark.parametrize("name", sorted(n for n in DIGESTS["webp_images"]
                                        if n.startswith(("alpha", "animated"))))
def test_alpha_and_animation_rgba_equal_pil(name):
    """The RGBA of files with alpha and of animations' first frames, as
    PIL opens them (non-premultiplied; an animation's canvas transparent
    black outside its first frame)."""
    with open(os.path.join(fx.WEBP, name), "rb") as f:
        data = f.read()
    got = webp.decode_webp_rgba(data)
    with Image.open(io.BytesIO(data)) as img:
        want = np.asarray(img.convert("RGBA"))
    np.testing.assert_array_equal(got, want)


def test_sub_formats_are_named():
    names = {}
    for name in sorted(DIGESTS["webp_images"]):
        with open(os.path.join(fx.WEBP, name), "rb") as f:
            names[name] = webp.webp_variant(f.read())
    assert names["lossy_q75_m0.webp"] == "a lossy WebP"
    assert names["lossless_photo.webp"] == "a lossless WebP"
    assert names["alpha_raw_filter2.webp"] == "a lossy WebP with alpha"
    assert names["animated_offset.webp"] == "an animated WebP"


def test_variants_it_cannot_decode_raise_naming_them():
    with open(os.path.join(fx.WEBP, "lossy_q75_m0.webp"), "rb") as f:
        lossy = bytearray(f.read())
    at = lossy.find(b"VP8 ") + 8
    inter = bytearray(lossy)
    inter[at] |= 1  # an interframe
    with pytest.raises(NotImplementedError, match="not a key frame"):
        image_io.decode_image(bytes(inter), "inter.webp")
    with open(os.path.join(fx.WEBP, "alpha_raw_filter0.webp"), "rb") as f:
        alpha = bytearray(f.read())
    alpha[alpha.find(b"ALPH") + 8] |= 2  # compression method 2
    with pytest.raises(NotImplementedError, match="compression method 2"):
        webp.decode_webp(bytes(alpha))
    with pytest.raises(ValueError, match="not a RIFF WEBP"):
        webp.decode_webp(b"RIFF\0\0\0\0WAVEfmt ")


@pytest.mark.parametrize("name,filter_type,sharpness", [
    ("lossy_simple_filter_sharpness0.webp", 1, 0),
    ("lossy_normal_filter_sharpness3.webp", 2, 3),
    ("lossy_simple_filter_sharpness6.webp", 1, 6),
])
def test_loop_filter_variants_are_reached(name, filter_type, sharpness):
    """The fixtures whose frame header was rewritten to the simple filter
    and to sharpness 3 and 6 (``make_m2kr_parquet.py::vp8_with_filter``)
    parse so, and decode as PIL does."""
    with open(os.path.join(fx.WEBP, name), "rb") as f:
        data = f.read()
    vp8 = fx._webp_chunk(data, b"VP8 ")
    _, _, part0 = webp._parse_header(vp8)
    hd = webp._frame_header(webp._Bool(vp8, 10, 10 + part0), vp8, 10 + part0)
    assert (hd.filter_type, hd.sharpness) == (filter_type, sharpness) and hd.level > 0
    np.testing.assert_array_equal(webp.decode_webp(data), _pil(data))
