"""The port's streamed retrieval (``engine/streaming.py``) against the
port's device-resident search and against the JAX package's
``StreamingSearcher`` on the same numpy corpus: bf16 and int8 host indexes,
partial last slabs, an unmasked corpus, a memory-mapped saved index and
k above the corpus size. On the CPU the slabs are scored by the kernels'
plain versions.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine import streaming as jstream  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import (  # noqa: E402
    HostQuantizedTokenIndex,
    HostTokenIndex,
    QuantizedTokenIndex,
    StreamingSearcher,
    TokenIndex,
    search_exhaustive,
)


def _corpus(n=200, L=12, dim=32, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, L, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    mask = None
    if masked:
        lens = rng.integers(4, L + 1, size=n)
        mask = np.arange(L)[None, :] < lens[:, None]
        emb = np.where(mask[..., None], emb, 0.0)
    return emb.astype(np.float16), mask, [f"d{i}" for i in range(n)]


def _queries(b=5, Lq=8, dim=32, seed=1):
    return np.random.default_rng(seed).normal(size=(b, Lq, dim)).astype(np.float32)


def _jax_streamed(host, Q, k, slab_docs):
    if isinstance(host, HostQuantizedTokenIndex):
        jhost = jstream.HostQuantizedTokenIndex(codes=host.codes, scales=host.scales,
                                                mask=host.mask, doc_ids=host.doc_ids)
    else:
        jhost = jstream.HostTokenIndex(embeddings=host.embeddings, mask=host.mask,
                                       doc_ids=host.doc_ids)
    return jstream.StreamingSearcher(jhost, k=k, slab_docs=slab_docs,
                                     use_pallas=False).search(Q)


@pytest.mark.parametrize("slab_docs", [64, 80, 200, 512])
def test_streamed_bf16_matches_resident_and_jax(slab_docs):
    emb, mask, ids = _corpus()
    Q = _queries()
    ref_v, ref_i = search_exhaustive(TokenIndex.from_arrays(emb, mask, ids, device="cpu"),
                                     Q, k=10)
    host = HostTokenIndex(embeddings=emb, mask=mask, doc_ids=ids)
    vals, idx = StreamingSearcher(host, k=10, slab_docs=slab_docs, device="cpu").search(Q)
    np.testing.assert_array_equal(idx, ref_i)
    # the same bf16 operands; the plain version's fp32 matmul may block
    # differently for another slab width (fp32 round-off of totals below 10)
    np.testing.assert_allclose(vals, ref_v, rtol=1e-6, atol=1e-5)
    jv, ji = _jax_streamed(host, Q, 10, slab_docs)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_allclose(vals, jv, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("slab_docs", [64, 80, 200, 512])
def test_streamed_int8_matches_resident_and_jax(slab_docs):
    emb, mask, ids = _corpus(n=160)
    Q = _queries(b=4)
    ref = QuantizedTokenIndex.from_arrays(emb, mask, ids, device="cpu")
    ref_v, ref_i = search_exhaustive(ref, Q, k=10)
    host = HostQuantizedTokenIndex.from_host_index(
        HostTokenIndex(embeddings=emb, mask=mask, doc_ids=ids), slab_docs=64)
    # the same quantization as the device-resident index, and as JAX's
    np.testing.assert_array_equal(host.codes, ref.codes.numpy())
    np.testing.assert_array_equal(host.scales, ref.scales.numpy())
    jhost = jstream.HostQuantizedTokenIndex.from_host_index(
        jstream.HostTokenIndex(embeddings=emb, mask=mask, doc_ids=ids), slab_docs=64)
    np.testing.assert_array_equal(host.codes, jhost.codes)
    np.testing.assert_array_equal(host.scales, jhost.scales)

    vals, idx = StreamingSearcher(host, k=10, slab_docs=slab_docs, device="cpu").search(Q)
    # a doc's value does not depend on the slab it falls in: bitwise equal
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_array_equal(vals, ref_v)
    jv, ji = _jax_streamed(host, Q, 10, slab_docs)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_allclose(vals, jv, rtol=1e-5, atol=1e-6)


def test_streamed_unmasked_corpus_and_ids():
    emb, _, ids = _corpus(n=150, masked=False)
    Q = _queries(b=3)
    ref_v, ref_i = search_exhaustive(
        TokenIndex.from_arrays(emb, np.ones(emb.shape[:2], bool), ids, device="cpu"), Q, k=7)
    host = HostTokenIndex(embeddings=emb, mask=None, doc_ids=ids)
    got_ids, vals = StreamingSearcher(host, k=7, slab_docs=64, device="cpu").search_ids(Q)
    assert got_ids == [[ids[j] for j in row] for row in ref_i]
    np.testing.assert_allclose(vals, ref_v, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_streamed_from_saved_index_memmap(tmp_path, writer):
    from reranking_multimodal_retrievers_tpu.engine.index import TokenIndex as JTokenIndex

    emb, mask, ids = _corpus(n=96)
    Q = _queries(b=2)
    ref = TokenIndex.from_arrays(emb, mask, ids, device="cpu")
    ref_v, ref_i = search_exhaustive(ref, Q, k=5)
    path = str(tmp_path / "idx")
    (ref if writer == "port" else JTokenIndex.from_arrays(emb, mask, ids)).save(path)
    host = HostTokenIndex.load(path, mmap=True)
    assert isinstance(host.embeddings, np.memmap) and host.doc_ids == ids
    vals, idx = StreamingSearcher(host, k=5, slab_docs=40, device="cpu").search(Q)
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_allclose(vals, ref_v, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_k_larger_than_corpus(quantized):
    emb, mask, ids = _corpus(n=24)
    Q = _queries(b=2)
    host = HostTokenIndex(embeddings=emb, mask=mask, doc_ids=ids)
    if quantized:
        host = HostQuantizedTokenIndex.from_host_index(host)
    vals, idx = StreamingSearcher(host, k=40, slab_docs=16, device="cpu").search(Q)
    assert vals.shape == (2, 40) and vals.dtype == np.float32
    # exactly num_docs real entries per row, the rest -inf / -1
    for row_v, row_i in zip(vals, idx):
        real = row_i >= 0
        assert real.sum() == 24 and len(set(row_i[real].tolist())) == 24
        assert np.all(np.isneginf(row_v[~real]))
    jv, ji = _jax_streamed(host, Q, 40, 16)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_allclose(vals, jv, rtol=1e-5, atol=1e-4)
