"""``data/image_io.py``'s JPEG decoder against PIL (libjpeg-turbo with its
defaults: the ``islow`` IDCT, fancy upsampling, integer YCbCr tables, block
smoothing): bitwise on baseline and progressive files of 4:4:4, 4:2:2,
4:2:0 and greyscale, and stored as RGB, with restart intervals, optimised
Huffman tables, and widths and heights that are not multiples of 8 or 16;
on progressive files whose refinement or AC scans were cut (block
smoothing); on CMYK and YCCK files, sequential and progressive; on the
committed fixtures against the pixels PIL gave for them
(``tests/fixtures/baseline_420_rst.pil.npy``, ``tests/fixtures/digests.json``),
so that the decoder is held where no PIL is installed. The module parser's
images equal the JAX package's. An arithmetic-coded lossless file goes to PIL
by its header, and raises naming it without PIL (arithmetic-coded DCT and
lossless files are decoded here: ``tests/test_torch_jpeg_coding.py``)."""

import io
import json
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
sys.path.insert(0, os.path.join(HERE, "fixtures"))
try:
    import make_m2kr_parquet as fixtures  # noqa: E402
finally:
    sys.path.pop(0)
with open(fixtures.DIGESTS) as _f:
    DIGESTS = json.load(_f)


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
def test_other_jpegs_go_to_pil_by_header(tmp_path, monkeypatch, kind):
    """Progressive and CMYK files, which went to PIL by their header, are
    decoded here bitwise as PIL, also where PIL cannot be imported; the
    same file with an arithmetic-coded lossless frame header (SOF11, which
    this module leaves to PIL) goes to PIL, and raises naming that format
    where PIL is absent."""
    img = _photo(20, 30, 5)
    data = (_encode(img, progressive=True) if kind == "progressive"
            else _encode(img, mode="CMYK"))
    assert image_io._jpeg_frame(data) is not None
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(data)
    want = np.asarray(PIL_Image.open(path).convert("RGB"))
    assert np.array_equal(image_io.read_image(path), want)
    sof = b"\xff\xc2" if kind == "progressive" else b"\xff\xc0"
    arith = data.replace(sof, b"\xff\xcb", 1)
    arith_path = str(tmp_path / f"{kind}_arith.jpg")
    with open(arith_path, "wb") as f:
        f.write(arith)
    assert image_io._jpeg_frame(arith) is None
    with pytest.raises(ValueError, match="arithmetic-coded lossless"):
        image_io.decode_jpeg(arith)
    opened = []

    class _Opened:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def convert(self, mode):
            opened.append(mode)
            return np.zeros((2, 3, 3), np.uint8)

    monkeypatch.setattr(PIL_Image, "open", lambda p: opened.append(p) or _Opened())
    assert image_io.read_image(arith_path).shape == (2, 3, 3)
    assert opened == [arith_path, "RGB"]
    np.save(str(tmp_path / "want.npy"), want)
    code = ("import sys\nsys.modules['PIL'] = None\nimport numpy as np\n"
            "from reranking_multimodal_retrievers_tpu_torch.data import image_io\n"
            f"assert (image_io.read_image({path!r}) == np.load({str(tmp_path / 'want.npy')!r}))"
            ".all()\n"
            f"image_io.read_image({arith_path!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "NotImplementedError" in out.stderr
    assert "arithmetic-coded lossless" in out.stderr and "AssertionError" not in out.stderr


PROGRESSIVE_SIZES = [(1, 1), (17, 9), (3, 513), (513, 3), (37, 53), (16, 16), (61, 29)]
PROGRESSIVE_OPTIONS = {"plain": {}, "optimize": {"optimize": True},
                       "restart_blocks": {"restart_marker_blocks": 3},
                       "restart_rows": {"restart_marker_rows": 1}, "q95": {"quality": 95}}


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("option", list(PROGRESSIVE_OPTIONS))
def test_progressive_jpeg_is_bitwise_pil(subsampling, option):
    for i, (h, w) in enumerate(PROGRESSIVE_SIZES):
        data = _encode(_photo(h, w, 30 + i), progressive=True, subsampling=subsampling,
                       **PROGRESSIVE_OPTIONS[option])
        assert image_io._jpeg_frame(data)[3] is True
        got, want = image_io.decode_jpeg(data), _pil(data)
        assert got.shape == want.shape == (h, w, 3)
        assert np.array_equal(got, want), (subsampling, option, (h, w),
                                           int(np.abs(got.astype(int) - want).max()))


@pytest.mark.parametrize("option", ["plain", "optimize", "restart_rows"])
def test_progressive_greyscale_is_bitwise_pil(option):
    for i, (h, w) in enumerate(PROGRESSIVE_SIZES):
        data = _encode(_photo(h, w, 40 + i), mode="L", progressive=True,
                       **PROGRESSIVE_OPTIONS[option])
        assert np.array_equal(image_io.decode_jpeg(data), _pil(data)), (option, (h, w))


@pytest.mark.parametrize("cut", ["norefine", "dconly", "dcfirst", "lowac"])
@pytest.mark.parametrize("mode,subsampling", [("RGB", 0), ("RGB", 1), ("RGB", 2), ("L", 0),
                                              ("CMYK", 0)])
def test_block_smoothing_is_bitwise_pil(cut, mode, subsampling):
    """Progressive files whose scan script was cut, EOI kept: without the
    refinement scans (``norefine``), without AC scans (``dconly``, and
    ``dcfirst`` without the DC refinement too: DC interpolation), or with
    only the first AC band (``lowac``). libjpeg-turbo smooths the blocks of
    such files; so does the decoder. Block widths 1-3 and odd heights
    cover the edges of its 5 x 5 window."""
    keep = {"norefine": lambda ss, se, ah, al: ah == 0,
            "dconly": lambda ss, se, ah, al: ss == 0,
            "dcfirst": lambda ss, se, ah, al: ss == 0 and ah == 0,
            "lowac": lambda ss, se, ah, al: ss == 0 or (ah == 0 and se <= 5)}[cut]
    for i, (h, w) in enumerate([(8, 8), (8, 16), (17, 9), (40, 24), (48, 17), (37, 53),
                                (3, 513)]):
        full = _encode(_photo(h, w, 50 + i), mode=mode, progressive=True,
                       subsampling=subsampling)
        data = fixtures.cut_scans(full, keep)
        assert len(data) < len(full) and data.endswith(b"\xff\xd9")
        got, want = image_io.decode_jpeg(data), _pil(data)
        assert np.array_equal(got, want), (cut, mode, subsampling, (h, w),
                                           int(np.abs(got.astype(int) - want).max()))


@pytest.mark.parametrize("kind", ["cmyk", "ycck"])
@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_and_ycck_are_bitwise_pil(kind, progressive):
    """Adobe CMYK (PIL opens it as ``CMYK;I``, inverted) and YCCK (Adobe
    transform 2, which libjpeg converts to CMYK), then PIL's CMYK -> RGB."""
    for i, (h, w) in enumerate([(1, 1), (17, 9), (29, 43), (64, 48)]):
        data = _encode(_photo(h, w, 60 + i), mode="CMYK", progressive=progressive)
        if kind == "ycck":
            data = fixtures.as_ycck(data)
        assert len(image_io._jpeg_frame(data)[2]) == 4
        assert np.array_equal(image_io.decode_jpeg(data), _pil(data)), (kind, progressive,
                                                                      (h, w))


JPEG_FIXTURES = sorted(n for n in DIGESTS["images"] if n.endswith(".jpg"))


@pytest.mark.parametrize("name", JPEG_FIXTURES)
def test_committed_jpegs_equal_pil_and_their_digest(name):
    path = os.path.join(fixtures.IMAGES, name)
    got = image_io.read_image(path)
    assert np.array_equal(got, np.asarray(PIL_Image.open(path).convert("RGB")))
    assert fixtures.pixels_digest(got) == DIGESTS["images"][name]


@pytest.mark.parametrize("name", ["prog_420_large.jpg", "cmyk_prog.jpg", "ycck_seq.jpg",
                                  "smooth_norefine_420.jpg", "png_c0_d16_adam7_trns.png",
                                  "png_c3_d4_plain.png"])
def test_module_parser_images_equal_jax(name):
    """The ``VisionInput`` module of both packages' module parsers on the
    same file: the JAX package opens it with PIL, the port decodes it."""
    from reranking_multimodal_retrievers_tpu.data.module_parser import ModuleParser as JaxParser
    from reranking_multimodal_retrievers_tpu_torch.data.module_parser import ModuleParser

    sample = {"img_path": os.path.join(fixtures.IMAGES, name)}
    (want,) = JaxParser().VisionInput(dict(sample), {})["images"]
    (got,) = ModuleParser().VisionInput(dict(sample), {})["images"]
    assert np.array_equal(np.asarray(got), np.asarray(want))
