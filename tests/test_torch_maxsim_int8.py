"""Kernel K3's plain version (``ops/maxsim_int8_cuda.py``) against the JAX
package's int8 MaxSim: ``maxsim_scores_pallas_int8`` in interpret mode and
``engine/search.py::_xla_chunk_scores_int8``, on the same numpy codes.

On the CPU the port's ``maxsim_scores_int8`` wrapper takes its plain
version and leaves the kernel's launch counter where it was.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine.search import _xla_chunk_scores_int8  # noqa: E402
from reranking_multimodal_retrievers_tpu.ops.maxsim_pallas import (  # noqa: E402
    maxsim_scores_pallas_int8,
)
from reranking_multimodal_retrievers_tpu.ops.quant import quantize_rows  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops import maxsim_int8_cuda  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_int8_cuda import (  # noqa: E402
    maxsim_scores_int8,
    maxsim_scores_int8_reference,
)

# L_q = 12 is not a multiple of 8; the Pallas kernel's blocks need B % 8 and
# N % 8
B, L_Q, N, L_D, DIM = 8, 12, 16, 8, 128


def _port(Qq, qs, Dq, ds, mask):
    launches = maxsim_scores_int8.launches
    out = maxsim_scores_int8(*(None if a is None else torch.as_tensor(np.array(a))
                               for a in (Qq, qs, Dq, ds, mask)))
    assert maxsim_scores_int8.launches == launches  # CPU tensors: plain version
    return out.numpy()


def _pallas(Qq, qs, Dq, ds, mask):
    return np.asarray(maxsim_scores_pallas_int8(
        jnp.asarray(Qq), jnp.asarray(qs), jnp.asarray(Dq), jnp.asarray(ds),
        None if mask is None else jnp.asarray(mask), B_blk=8, C_blk=8, interpret=True))


def _random(seed, whole_padding_doc=True):
    """Codes of unit vectors quantized as the JAX package does (per query
    token and per doc), with a ragged mask."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(B, L_Q, DIM)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    Qq, qs = quantize_rows(jnp.asarray(Q))
    D = rng.normal(size=(N, L_D, DIM)).astype(np.float32)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    amax = np.abs(D).max(axis=(1, 2))
    ds = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
    Dq = np.clip(np.round(D / ds[:, None, None]), -127, 127).astype(np.int8)
    lens = rng.integers(1, L_D + 1, size=N)
    mask = np.arange(L_D)[None, :] < lens[:, None]
    if whole_padding_doc:
        mask[5] = False
    return np.asarray(Qq), np.asarray(qs)[..., 0], Dq, ds, mask


def test_plain_k3_exact_on_crafted_codes():
    """Small integer codes and power-of-two scales: every product, maximum,
    scaled term and sum is exact in fp32, so the totals match bitwise
    whatever the summation order."""
    rng = np.random.default_rng(0)
    Qq = rng.integers(-8, 9, size=(B, L_Q, DIM)).astype(np.int8)
    Dq = rng.integers(-8, 9, size=(N, L_D, DIM)).astype(np.int8)
    qs = (2.0 ** rng.integers(-3, 2, size=(B, L_Q))).astype(np.float32)
    ds = (2.0 ** rng.integers(-3, 2, size=N)).astype(np.float32)
    mask = np.arange(L_D)[None, :] < rng.integers(1, L_D + 1, size=N)[:, None]
    for m in (mask, None):
        want = _pallas(Qq, qs, Dq, ds, m)
        got = _port(Qq, qs, Dq, ds, m)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(_xla_chunk_scores_int8(
                jnp.asarray(Qq), jnp.asarray(qs), jnp.asarray(Dq), jnp.asarray(ds),
                jnp.asarray(np.ones((N, L_D), bool) if m is None else m), N, 8)))


@pytest.mark.parametrize("masked", [True, False])
def test_plain_k3_matches_pallas_int8(masked):
    Qq, qs, Dq, ds, mask = _random(1)
    m = mask if masked else None
    want = _pallas(Qq, qs, Dq, ds, m)
    got = _port(Qq, qs, Dq, ds, m)
    assert got.shape == (B, N) and got.dtype == np.float32
    # the int32 maxima are exact on both sides; only the order of the fp32
    # sum of 12 scaled maxima differs (1e-5 relative). The whole-padding doc
    # (mask row 5) totals about -2^25 * sum(qs) * ds on both sides, since
    # both add the bias before the max
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if masked:
        assert got[:, 5].max() < -1e3 * ds[5] * qs.sum(axis=1).min()


def test_plain_k3_matches_xla_chunk_scores_int8():
    """Against the JAX package's portable scan, which replaces masked token
    scores by -2^25 instead of adding it: the two agree on every doc with a
    valid token."""
    Qq, qs, Dq, ds, mask = _random(2)
    want = np.asarray(_xla_chunk_scores_int8(
        jnp.asarray(Qq), jnp.asarray(qs), jnp.asarray(Dq), jnp.asarray(ds),
        jnp.asarray(mask), N, 4))
    got = _port(Qq, qs, Dq, ds, mask)
    valid = mask.any(axis=1)
    np.testing.assert_allclose(got[:, valid], want[:, valid], rtol=1e-5, atol=1e-6)


def test_plain_k3_unpadded_equals_all_true_mask():
    """``mask=None`` (an unpadded corpus) gives what an all-True mask gives."""
    Qq, qs, Dq, ds, _ = _random(3)
    ones = np.ones((N, L_D), bool)
    np.testing.assert_array_equal(_port(Qq, qs, Dq, ds, None), _port(Qq, qs, Dq, ds, ones))
    np.testing.assert_allclose(_port(Qq, qs, Dq, ds, None), _pallas(Qq, qs, Dq, ds, None),
                               rtol=1e-5, atol=1e-6)


def test_plain_k3_chunks_over_docs(monkeypatch):
    """The plain version's doc chunking does not change its result."""
    Qq, qs, Dq, ds, mask = _random(4)
    whole = _port(Qq, qs, Dq, ds, mask)
    monkeypatch.setattr(maxsim_int8_cuda, "_PLAIN_CHUNK_BYTES", 1)  # one doc a chunk
    # integer products are exact in any blocking, and each doc's sum runs
    # along its own contiguous L_q axis: bitwise the same
    np.testing.assert_array_equal(_port(Qq, qs, Dq, ds, mask), whole)


def test_cpu_wrapper_is_the_reference():
    Qq, qs, Dq, ds, mask = _random(5)
    args = [torch.as_tensor(np.array(a)) for a in (Qq, qs, Dq, ds, mask)]
    np.testing.assert_array_equal(maxsim_scores_int8_reference(*args).numpy(),
                                  _port(Qq, qs, Dq, ds, mask))


def test_wrapper_refuses_a_non_cuda_device():
    """A tensor that is on neither the CPU nor CUDA gets no plain fallback."""
    q = torch.empty(1, 2, 32, dtype=torch.int8, device="meta")
    d = torch.empty(3, 4, 32, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        maxsim_scores_int8(q, torch.empty(1, 2, device="meta"), d,
                           torch.empty(3, device="meta"))
