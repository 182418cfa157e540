"""Whole-padding docs on the port's int8 search path, and ``Searcher.search``'s
``remove_zero_rows`` keyword, against the JAX package.

The crafted corpus: 3 real docs of 8 tokens x dim 32 whose tokens all point
away from the 4 tokens of a unit query, so every real doc totals below 0;
the index is padded to 4 docs and k = 3. A padding doc has zero codes, so
its int8 total is about 0 (scale 1e-8/127, or 0 in a streamed slab's tail)
and, unguarded, outranks every real doc. The port guards whole-padding docs
on its int8 path whatever ``unpadded`` is. The oracle is the JAX package's
``_local_search_int8(..., unpadded=True)`` on the CPU, whose scan keeps the
token mask and only adds that guard. This departs from the JAX package's
default (``unpadded=False``), which ranks the padding doc first: ids
[3, 2, 0].
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine import search as jsearch  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import index as tindex  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import search as tsearch  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine.streaming import (  # noqa: E402
    HostQuantizedTokenIndex,
    StreamingSearcher,
)

N_REAL, L_D, DIM, L_Q, K = 3, 8, 32, 4, 3


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _crafted():
    """Query tokens near a direction u; doc j's tokens near -u, with more
    noise (so a less negative total) for doc 2, then 0, then 1."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=DIM)
    Q = _unit(u + 0.3 * np.linalg.norm(u) * _unit(rng.normal(size=(1, L_Q, DIM))))
    noise = np.array([0.5, 0.3, 0.8])[:, None, None]
    emb = _unit(-_unit(u)[None, None] + noise * _unit(rng.normal(size=(N_REAL, L_D, DIM))))
    return Q, emb, np.ones((N_REAL, L_D), bool), ["d0", "d1", "d2"]


def _jax_top_k(qindex, Q, unpadded):
    Qq, qs = tsearch.quantize_queries(torch.as_tensor(Q))
    vals, idx = jsearch._local_search_int8(
        *(jnp.asarray(x.numpy()) for x in (Qq, qs, qindex.codes, qindex.scales, qindex.mask)),
        k=K, chunk=4, use_pallas=False, unpadded=unpadded)
    return np.asarray(vals), np.asarray(idx)


def test_int8_padding_doc_never_wins():
    Q, emb, mask, ids = _crafted()
    qindex = tindex.QuantizedTokenIndex.from_arrays(emb, mask, ids, device="cpu",
                                                    pad_multiple=4)
    assert qindex.num_padded_docs == 4 and not qindex.mask[3].any()
    want_v, want_i = _jax_top_k(qindex, Q, unpadded=True)
    np.testing.assert_array_equal(want_i[0], [2, 0, 1])
    assert (want_v < 0).all()
    # the JAX package's default ranks the padding doc first
    np.testing.assert_array_equal(_jax_top_k(qindex, Q, unpadded=False)[1][0], [3, 2, 0])

    vals, idx = tsearch.search_exhaustive(qindex, Q, k=K)
    np.testing.assert_array_equal(idx, want_i)
    # K3's plain version and the JAX scan sum the same int32 maxima in
    # another order: fp32 round-off of totals near -2
    np.testing.assert_allclose(vals, want_v, atol=1e-5, rtol=1e-5)

    got_ids, got_v = tsearch.Searcher(qindex, k=K).search(Q)
    assert got_ids == [["d2", "d0", "d1"]]
    np.testing.assert_allclose(got_v, want_v, atol=1e-5, rtol=1e-5)

    # streamed: one slab of 4 docs, its tail doc zero-filled with scale 0
    host = HostQuantizedTokenIndex(codes=qindex.codes[:N_REAL].numpy(),
                                   scales=qindex.scales[:N_REAL].numpy(),
                                   mask=mask, doc_ids=ids)
    s_vals, s_idx = StreamingSearcher(host, k=K, slab_docs=4, device="cpu").search(Q)
    np.testing.assert_array_equal(s_idx, want_i)
    np.testing.assert_allclose(s_vals, want_v, atol=1e-5, rtol=1e-5)


def test_bf16_padding_doc_already_last():
    """The bf16 path needs no guard: K1 adds -9999 per masked token, so the
    padding doc totals about -9999 * L_q, and the JAX package agrees."""
    Q, emb, mask, ids = _crafted()
    index = tindex.TokenIndex.from_arrays(emb, mask, ids, device="cpu", pad_multiple=4)
    _, idx = tsearch.search_exhaustive(index, Q, k=K)
    np.testing.assert_array_equal(idx[0], [2, 0, 1])


@pytest.mark.parametrize("quantized", [False, True])
def test_searcher_accepts_remove_zero_rows(quantized):
    """A no-op kept for the JAX package's API (``Searcher.search``)."""
    Q, emb, mask, ids = _crafted()
    cls = tindex.QuantizedTokenIndex if quantized else tindex.TokenIndex
    searcher = tsearch.Searcher(cls.from_arrays(emb, mask, ids, device="cpu"), k=2)
    Qz = np.concatenate([Q, np.zeros((1, 2, DIM), np.float32)], axis=1)  # zero rows
    plain_ids, plain_v = searcher.search(Qz)
    for flag in (True, False):
        got_ids, got_v = searcher.search(Qz, remove_zero_rows=flag)
        assert got_ids == plain_ids
        np.testing.assert_array_equal(got_v, plain_v)
