"""``data/image_io.py``'s PNG reader against PIL's ``Image.open(p).convert(
"RGB")``, bitwise: every colour type at every bit depth the format allows
(1, 2 and 4-bit grey and palette, 16-bit grey, grey+alpha, RGB and RGBA),
Adam7-interlaced or not, with ``tRNS`` on grey, RGB and palette images
(dropped, as ``convert("RGB")`` drops it), palettes shorter than the index
range, every row filter, and sizes down to 1 x 1; the files are written
here with ``zlib`` and ``struct`` (``tests/fixtures/make_m2kr_parquet.py``
::``png_case``). The committed PNGs equal their digests."""

import io
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
PIL_Image = pytest.importorskip("PIL.Image")

from reranking_multimodal_retrievers_tpu_torch.data import image_io  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures"))
try:
    import make_m2kr_parquet as fixtures  # noqa: E402
finally:
    sys.path.pop(0)
with open(fixtures.DIGESTS) as _f:
    DIGESTS = json.load(_f)

COMBOS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
          (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
SIZES = [(1, 1), (3, 5), (9, 17), (13, 8), (33, 31)]


@pytest.mark.parametrize("ctype,depth", COMBOS)
def test_png_variant_is_bitwise_pil(ctype, depth):
    rng = np.random.default_rng(ctype * 100 + depth)
    for h, w in SIZES:
        for interlace in (0, 1):
            for trns in ((False, True) if ctype in (0, 2, 3) else (False,)):
                data = fixtures.png_case(rng, h, w, depth, ctype, interlace, trns)
                assert image_io._is_own_png(data)
                with PIL_Image.open(io.BytesIO(data)) as img:
                    want = np.asarray(img.convert("RGB"))
                got = image_io._read_png(data)
                assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
                assert np.array_equal(got, want), (ctype, depth, interlace, trns, (h, w))


def test_sixteen_bit_grey_clips_as_pil_mode_i():
    """16-bit grey opens in PIL as ``I;16``, whose ``convert("RGB")`` clips
    at 255 rather than scaling; the other 16-bit types keep the high byte."""
    samples = np.array([[[0], [1], [255], [256], [65535]]], np.int64)
    got = image_io._read_png(fixtures.png_bytes(samples, 16, 0))
    assert got[0, :, 0].tolist() == [0, 1, 255, 255, 255]
    got = image_io._read_png(fixtures.png_bytes(np.repeat(samples, 3, 2), 16, 2))
    assert got[0, :, 0].tolist() == [0, 0, 0, 1, 255]


PNG_FIXTURES = sorted(n for n in DIGESTS["images"] if n.endswith(".png"))


@pytest.mark.parametrize("name", PNG_FIXTURES)
def test_committed_pngs_equal_pil_and_their_digest(name):
    path = os.path.join(fixtures.IMAGES, name)
    got = image_io.read_image(path)
    with PIL_Image.open(path) as img:
        assert np.array_equal(got, np.asarray(img.convert("RGB")))
    assert fixtures.pixels_digest(got) == DIGESTS["images"][name]
