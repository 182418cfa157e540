"""``data/image_io.py``'s JPEG decoder against PIL (libjpeg-turbo with its
defaults: the ``islow`` IDCT, fancy upsampling, integer YCbCr tables):
bitwise on baseline files of 4:4:4, 4:2:2, 4:2:0 and
greyscale, and stored as RGB, with restart intervals, optimised Huffman
tables, and widths and
heights that are not multiples of 8 or 16; on the committed fixture against
the pixels PIL gave for it (``tests/fixtures/baseline_420_rst.pil.npy``), so
that the decoder is held where no PIL is installed. Progressive and CMYK
files go to PIL by their header, and fail without it."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
PIL_Image = pytest.importorskip("PIL.Image")

from reranking_multimodal_retrievers_tpu_torch.data import image_io  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "fixtures", "baseline_420_rst.jpg")


def _photo(h, w, seed):
    """Gradients, an edge and noise: every DCT frequency gets energy."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    ((xx + yy) * 3) % 256], -1).astype(np.float64)
    img[:, w // 2:] = 255 - img[:, w // 2:]
    img += np.random.default_rng(seed).normal(0, 25, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _encode(img, mode="RGB", **kw):
    buf = io.BytesIO()
    PIL_Image.fromarray(img).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data):
    return np.asarray(PIL_Image.open(io.BytesIO(data)).convert("RGB"))


SIZES = [(8, 8), (16, 16), (37, 53), (61, 29), (3, 5), (2, 9), (100, 131)]
OPTIONS = {"plain": {}, "restart": {"restart_marker_blocks": 3}, "q95": {"quality": 95},
           "optimized_q30": {"optimize": True, "quality": 30}}


@pytest.mark.parametrize("subsampling,name", [(0, "4:4:4"), (1, "4:2:2"), (2, "4:2:0")])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_colour_jpeg_is_bitwise_pil(subsampling, name, option):
    for i, (h, w) in enumerate(SIZES):
        data = _encode(_photo(h, w, i), subsampling=subsampling, **OPTIONS[option])
        assert image_io._jpeg_frame(data) is not None
        got, want = image_io.decode_jpeg(data), _pil(data)
        assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
        assert np.array_equal(got, want), (name, option, (h, w),
                                           int(np.abs(got.astype(int) - want).max()))


@pytest.mark.parametrize("quality", [75, 95])
def test_rgb_jpeg_is_bitwise_pil(quality):
    """Components stored as R, G, B (the Adobe marker's transform 0): no
    YCbCr conversion."""
    for i, (h, w) in enumerate(SIZES):
        data = _encode(_photo(h, w, 20 + i), keep_rgb=True, subsampling=0, quality=quality)
        assert b"Adobe" in data
        assert np.array_equal(image_io.decode_jpeg(data), _pil(data)), (quality, (h, w))


@pytest.mark.parametrize("option", [{}, {"restart_marker_rows": 1}, {"quality": 20}])
def test_greyscale_jpeg_is_bitwise_pil(option):
    for i, (h, w) in enumerate(SIZES):
        data = _encode(_photo(h, w, 10 + i), mode="L", **option)
        assert np.array_equal(image_io.decode_jpeg(data), _pil(data)), (option, (h, w))


def test_read_image_decodes_a_photograph_sized_jpeg(tmp_path):
    """A COCO-sized file through ``read_image`` (the path the data nodes
    take)."""
    path = str(tmp_path / "coco.jpg")
    with open(path, "wb") as f:
        f.write(_encode(_photo(480, 640, 3), quality=90))
    assert np.array_equal(image_io.read_image(path), np.asarray(
        PIL_Image.open(path).convert("RGB")))


def test_committed_fixture_equals_its_pil_pixels():
    want = np.load(os.path.join(HERE, "fixtures", "baseline_420_rst.pil.npy"))
    with open(FIXTURE, "rb") as f:
        data = f.read()
    assert image_io._jpeg_frame(data)[:2] == (97, 75)
    assert b"\xff\xdd" in data  # it has a restart interval
    assert np.array_equal(image_io.read_image(FIXTURE), want)
    assert np.array_equal(_pil(data), want)


@pytest.mark.parametrize("kind", ["progressive", "cmyk"])
def test_other_jpegs_go_to_pil_by_header(tmp_path, kind):
    img = _photo(20, 30, 5)
    data = (_encode(img, progressive=True) if kind == "progressive"
            else _encode(img, mode="CMYK"))
    assert image_io._jpeg_frame(data) is None
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(data)
    assert np.array_equal(image_io.read_image(path),
                          np.asarray(PIL_Image.open(path).convert("RGB")))
    with pytest.raises(ValueError, match="not a sequential"):
        image_io.decode_jpeg(data)
    code = ("import sys\nsys.modules['PIL'] = None\n"
            "from reranking_multimodal_retrievers_tpu_torch.data import image_io\n"
            f"image_io.read_image({path!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "import of PIL halted" in out.stderr
