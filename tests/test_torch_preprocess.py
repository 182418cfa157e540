"""The port's on-device CLIP preprocessing (``ops/preprocess.py``) against the
JAX package's ``ops/preprocess.py`` on the CPU, the same numpy images
through both.

Tolerance: max |diff| <= 1e-4 after normalisation. Both compute the same
antialiased resize in fp32 (the port as two products with the crop's weight
columns, JAX as one einsum over the full resized image), so they differ in
summation order only: about 2e-5 at most over these shapes, on noise (the
worst case), divided by CLIP's std of ~0.27.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reranking_multimodal_retrievers_tpu.ops import preprocess as jpre  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops import preprocess as tpre  # noqa: E402

TOL = 1e-4
SHAPES = [(224, 224), (256, 320), (320, 256), (96, 200), (480, 640)]


def _images(h, w, seed=0, n=2):
    return np.random.default_rng(seed).integers(0, 256, size=(n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("size", [64, 224])
@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("method", ["bicubic", "linear"])
def test_matches_jax(method, hw, size):
    """uint8 and [0, 1] float inputs, each within TOL of the JAX function."""
    u8 = _images(*hw)
    for x in (u8, u8.astype(np.float32) / 255.0):
        want = np.asarray(jpre.preprocess_images(x, image_size=size, method=method))
        got = tpre.preprocess_images(torch.from_numpy(x), image_size=size, method=method)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, size, size)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("method", ["lanczos3", "lanczos5", "nearest"])
def test_other_methods_match_jax(method):
    u8 = _images(480, 640, seed=1)
    want = np.asarray(jpre.preprocess_images(u8, image_size=224, method=method))
    got = tpre.preprocess_images(torch.from_numpy(u8), image_size=224, method=method)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_float_rule_is_batch_wide():
    """A float batch is divided by 255 when its largest value (over the whole
    batch) exceeds 2: an image in [0, 1] beside one in [0, 255] is divided
    too, as in JAX; a per-image rule would not divide it."""
    u8 = _images(96, 200, seed=2)
    batch = np.stack([u8[0].astype(np.float32) / 255.0, u8[1].astype(np.float32)])
    want = np.asarray(jpre.preprocess_images(batch, image_size=64))
    got = tpre.preprocess_images(torch.from_numpy(batch), image_size=64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    per_image = tpre.preprocess_images(torch.from_numpy(batch[:1]), image_size=64).numpy()
    assert np.abs(per_image[0] - got[0]).max() > 1.0  # the rules differ on image 0
    low = (np.asarray(tpre.CLIP_MEAN, np.float32) / np.asarray(tpre.CLIP_STD, np.float32))
    np.testing.assert_allclose(got[0].max(axis=(1, 2)), -low, atol=0.02)  # ~black


def test_device_processor_lists_and_resolutions(monkeypatch):
    """A list of same-shape HWC arrays is one batch; each resolution's plan is
    built once; the numpy entry point runs on the platform device."""
    monkeypatch.setenv("RMRT_PLATFORM", "cpu")
    proc = tpre.CLIPImageProcessorDevice(image_size=64, device="cpu")
    a, b = _images(256, 320, seed=3), _images(96, 200, seed=4)
    got_a = proc(list(a))
    got_b = proc(b)
    proc(a)
    assert len(proc._plans) == 2
    for x, got in ((a, got_a), (b, got_b)):
        want = np.asarray(jpre.preprocess_images(x, image_size=64))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tpre.preprocess_images(a, image_size=64).numpy(),
                                  got_a.numpy())
    with pytest.raises(ValueError):
        tpre.CLIPImageProcessorDevice(method="area", device="cpu")
    with pytest.raises(ValueError):
        proc(a[..., :2])


def test_scaled_size_and_crop_follow_jax():
    """Python's round on the shortest-side scale (half to even), and the
    center crop of the scaled image."""
    for h, w in [(96, 200), (480, 640), (224, 225), (300, 301), (1001, 250)]:
        s = 224
        scale = s / min(h, w)
        assert tpre.scaled_size(h, w, s) == (max(s, round(h * scale)), max(s, round(w * scale)))
    # 250 -> 224 along W, 1001 -> round(1001 * 224 / 250) = 897 along H
    u8 = _images(1001, 250, seed=5, n=1)
    want = np.asarray(jpre.preprocess_images(u8, image_size=224))
    got = tpre.preprocess_images(torch.from_numpy(u8), image_size=224).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
