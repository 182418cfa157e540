"""``data/jpeg_coding.py`` through ``data/image_io.py``: arithmetic-coded
JPEGs (SOF9 sequential, SOF10 progressive; 4:4:4, 4:2:2, 4:2:0 and grey,
restart intervals, DAC conditioning) and Huffman-coded lossless JPEGs
(SOF3: predictors 1-7, point transforms, restart intervals, one scan or a
scan a component, RGB and grey) decoded bitwise as PIL 12.1 decodes them
through libjpeg-turbo. PIL writes none of these, so
``tests/fixtures/make_m2kr_parquet.py`` encodes them (after libjpeg's
``jcarith.c``), and PIL's pixels are the check: the committed files
(``tests/fixtures/jpeg_coding``) against their digests and PIL, fresh
files at other sizes and seeds against PIL. A lossless YCbCr file and a
12-bit JPEG, which PIL refuses, are refused here too."""

import io
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
PIL_Image = pytest.importorskip("PIL.Image")

from reranking_multimodal_retrievers_tpu_torch.data import image_io, jpeg_coding  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures"))
try:
    import make_m2kr_parquet as fx  # noqa: E402
finally:
    sys.path.pop(0)
with open(fx.DIGESTS) as _f:
    DIGESTS = json.load(_f)["jpeg_coding"]


def _pil(data: bytes) -> np.ndarray:
    with PIL_Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_committed_files_equal_pil_and_their_digest(name):
    with open(os.path.join(fx.JPEG_CODING, name), "rb") as f:
        data = f.read()
    assert image_io._jpeg_frame(data) is not None
    got = image_io.decode_image(data, name)
    assert fx.pixels_digest(got) == DIGESTS[name]
    assert np.array_equal(got, _pil(data))


@pytest.mark.parametrize("seed", range(3))
def test_fresh_arithmetic_files_equal_pil(seed):
    rng = np.random.default_rng(100 + seed)
    h, w = (int(x) for x in rng.integers(1, 60, 2))
    rgb = fx._photo(rng, h, w)
    for data in (fx.arith_jpeg_bytes(rgb, False, (2, 1), restart=1),
                 fx.arith_jpeg_bytes(rgb, True, (1, 2)),
                 fx.arith_jpeg_bytes(rgb, True, (2, 2), restart=2, dac=((0, 5), 2)),
                 fx.arith_jpeg_bytes(rgb[..., 0].copy(), False, dac=((3, 3), 20))):
        assert np.array_equal(image_io.decode_image(data), _pil(data)), (h, w)


@pytest.mark.parametrize("predictor", range(1, 8))
def test_fresh_lossless_files_equal_pil(predictor):
    rng = np.random.default_rng(200 + predictor)
    h, w = (int(x) for x in rng.integers(1, 40, 2))
    rgb = fx._photo(rng, h, w)
    for data in (fx.lossless_jpeg_bytes(rgb, predictor, pt=predictor % 4, restart_rows=2),
                 fx.lossless_jpeg_bytes(rgb[..., 2].copy(), predictor, interleaved=False)):
        got = image_io.decode_image(data)
        assert np.array_equal(got, _pil(data)), (h, w)
    assert np.array_equal(image_io.decode_image(fx.lossless_jpeg_bytes(rgb, predictor)), rgb)


def test_qm_decoder_reads_what_the_encoder_wrote():
    """Decisions on adaptive and fixed estimates, through the fixtures'
    encoder and the port's decoder (carries, stacked 0xFF bytes)."""
    rng = np.random.default_rng(7)
    bits = (rng.random(20000) < rng.random(20000) ** 3).astype(int).tolist()
    ctx = rng.integers(0, 8, len(bits)).tolist()
    enc, st = fx.QMEncoder(), [0] * 8
    for b, c in zip(bits, ctx):
        enc.encode(st, c, b) if c else enc.encode([jpeg_coding.FIXED], 0, b)
    data = enc.finish()
    unstuffed = data.replace(b"\xff\x00", b"\xff")
    dec, st = jpeg_coding.QMDecoder(unstuffed), [0] * 8
    got = [dec.decode(st, c) if c else dec.decode([jpeg_coding.FIXED], 0) for c in ctx]
    assert got == bits


def test_formats_pil_refuses_are_refused(tmp_path):
    """A lossless JPEG in YCbCr (libjpeg-turbo converts no lossless colour)
    and a 12-bit JPEG: PIL cannot decode either, and the port raises
    ``NotImplementedError`` naming it."""
    with open(os.path.join(fx.JPEG_CODING, "refused_lossless_ycbcr.jpg"), "rb") as f:
        ycbcr = f.read()
    with pytest.raises(OSError):
        _pil(ycbcr)
    with pytest.raises(NotImplementedError, match="lossless JPEG in YCbCr"):
        image_io.decode_image(ycbcr)
    buf = io.BytesIO()
    PIL_Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    at = data.find(b"\xff\xc0")
    data[at + 4] = 12
    with pytest.raises(OSError):
        _pil(bytes(data))
    path = tmp_path / "twelve.jpg"
    path.write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="12-bit JPEG"):
        image_io.read_image(str(path))
