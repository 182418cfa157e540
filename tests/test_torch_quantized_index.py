"""The port's int8 retrieval (``QuantizedTokenIndex``, ``make_search_fn_int8``,
``search_exhaustive``/``Searcher`` over an int8 index, ``RetrievalService``)
and ``TokenIndex``/``QuantizedTokenIndex`` save/load, against the JAX
package on the same numpy inputs. The JAX side scores with its portable
int8 scan (``use_pallas=False`` on the CPU); the port's with K3's plain
version.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine import index as jindex  # noqa: E402
from reranking_multimodal_retrievers_tpu.engine import search as jsearch  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import index as tindex  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import search as tsearch  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_int8_cuda import (  # noqa: E402
    maxsim_scores_int8,
)
from reranking_multimodal_retrievers_tpu_torch.serving import RetrievalService  # noqa: E402


def _corpus(n=64, L_d=8, dim=32, seed=0):
    """Unit-norm doc tokens; every fifth doc has only L_d / 2 real tokens."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, L_d, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    mask = np.ones((n, L_d), bool)
    mask[::5, L_d // 2:] = False
    return emb, mask, [f"d{i}" for i in range(n)]


def _queries(b=4, L_q=6, dim=32, seed=1):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(b, L_q, dim)).astype(np.float32)
    return Q / np.linalg.norm(Q, axis=-1, keepdims=True)


def _assert_same_index(t, j):
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert t.doc_ids == j.doc_ids


@pytest.mark.parametrize("pad_multiple", [None, 48])
def test_quantized_index_bitwise_equal_to_jax(pad_multiple):
    """Codes, scales and mask bitwise; padding tokens carry non-zero values
    here, so this also checks that they are zeroed before the amax."""
    emb, mask, ids = _corpus(n=40)
    emb[::5, 4:] = 3.0  # padding tokens must not set a scale
    j = jindex.QuantizedTokenIndex.from_arrays(emb, mask, ids, pad_multiple=pad_multiple)
    t = tindex.QuantizedTokenIndex.from_arrays(emb, mask, ids, device="cpu",
                                               pad_multiple=pad_multiple)
    assert t.num_padded_docs == (48 if pad_multiple else 40) and t.num_docs == 40
    assert (t.doc_maxlen, t.dim) == (8, 32)
    _assert_same_index(t, j)


def test_from_token_index_bitwise_equal_to_jax(monkeypatch):
    emb, mask, ids = _corpus(n=37)
    jt = jindex.TokenIndex.from_arrays(emb * mask[..., None], mask, ids, pad_multiple=8)
    tt = tindex.TokenIndex.from_arrays(emb * mask[..., None], mask, ids, device="cpu",
                                       pad_multiple=8)
    # slabs of 5 docs: the slab loop leaves no trace in the codes
    monkeypatch.setattr(tindex, "QUANTIZE_SLAB_DOCS", 5)
    t = tindex.QuantizedTokenIndex.from_token_index(tt)
    _assert_same_index(t, jindex.QuantizedTokenIndex.from_token_index(jt))
    assert t.num_padded_docs == 40


def test_save_load_across_packages(tmp_path):
    """A directory saved by one package loads in the other, both index kinds."""
    emb, mask, ids = _corpus(n=20)
    jt = jindex.TokenIndex.from_arrays(emb, mask, ids)
    tt = tindex.TokenIndex.from_arrays(emb, mask, ids, device="cpu")
    jt.save(str(tmp_path / "j_bf16"))
    tt.save(str(tmp_path / "t_bf16"))
    from_j = tindex.TokenIndex.load(str(tmp_path / "j_bf16"), device="cpu")
    from_t = jindex.TokenIndex.load(str(tmp_path / "t_bf16"))
    for t, j in ((from_j, jt), (tt, from_t)):
        np.testing.assert_array_equal(t.embeddings.float().numpy(),
                                      np.asarray(j.embeddings.astype(jnp.float32)))
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
        assert t.doc_ids == j.doc_ids == ids
    assert from_j.embeddings.dtype == torch.bfloat16

    jq = jindex.QuantizedTokenIndex.from_arrays(emb, mask, ids)
    tq = tindex.QuantizedTokenIndex.from_arrays(emb, mask, ids, device="cpu")
    jq.save(str(tmp_path / "j_int8"))
    tq.save(str(tmp_path / "t_int8"))
    _assert_same_index(tindex.QuantizedTokenIndex.load(str(tmp_path / "j_int8"), device="cpu"), jq)
    _assert_same_index(tq, jindex.QuantizedTokenIndex.load(str(tmp_path / "t_int8")))


def test_int8_search_topk_matches_jax():
    emb, mask, ids = _corpus()
    Q = _queries()
    jq = jindex.QuantizedTokenIndex.from_arrays(emb, mask, ids, pad_multiple=80)
    tq = tindex.QuantizedTokenIndex.from_arrays(emb, mask, ids, device="cpu", pad_multiple=80)
    want_v, want_i = jsearch.search_exhaustive(jq, Q, k=10, use_pallas=False)
    launches = maxsim_scores_int8.launches
    got_v, got_i = tsearch.search_exhaustive(tq, Q, k=10)
    np.testing.assert_array_equal(got_i, want_i)
    # exact int32 maxima; the fp32 sums of 6 scaled maxima differ in order
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=1e-6)

    got_ids, vals = tsearch.Searcher(tq, k=10).search(Q)
    want_ids, _ = jsearch.Searcher(index=jq, k=10, use_pallas=False).search(Q)
    assert got_ids == want_ids
    np.testing.assert_allclose(vals, want_v, rtol=1e-5, atol=1e-6)
    assert maxsim_scores_int8.launches == launches  # CPU: plain version


def test_int8_search_tracks_fp_ranking():
    """Mirrors the JAX package's faithfulness check: the int8 top-10 overlaps
    the bf16 top-10 by at least 80% and its scores track the fp64 totals."""
    emb, mask, ids = _corpus()
    Q = _queries()
    tt = tindex.TokenIndex.from_arrays(emb, mask, ids, device="cpu")
    tq = tindex.QuantizedTokenIndex.from_token_index(tt)
    _, i_fp = tsearch.search_exhaustive(tt, Q, k=10)
    v_q, i_q = tsearch.search_exhaustive(tq, Q, k=10)
    for b in range(Q.shape[0]):
        assert len(set(i_fp[b]) & set(i_q[b])) >= 8, b
    s = np.einsum("bqd,nld->bnlq", Q.astype(np.float64), emb.astype(np.float64))
    oracle = np.where(mask[None, :, :, None], s, -1e9).max(axis=2).sum(axis=-1)
    np.testing.assert_allclose(v_q, np.take_along_axis(oracle, i_q, axis=1),
                               rtol=0.05, atol=0.05)


def test_int8_search_exact_on_crafted_codes():
    """Integer-valued embeddings whose amax hits 127 * u give exact codes;
    with query tokens built the same way the int8 search reproduces the
    fp64 MaxSim (mirrors the JAX package's crafted case)."""
    rng = np.random.default_rng(2)
    N, L_d, L_q, dim = 8, 4, 3, 32
    codes = rng.integers(-5, 6, size=(N, L_d, dim)).astype(np.float32)
    codes[:, 0, 0] = 127
    emb = codes * 0.01
    mask = np.ones((N, L_d), bool)
    tq = tindex.QuantizedTokenIndex.from_arrays(emb, mask, [str(i) for i in range(N)],
                                                device="cpu")
    np.testing.assert_array_equal(tq.codes.numpy(), codes.astype(np.int8))
    Qc = rng.integers(-5, 6, size=(2, L_q, dim)).astype(np.float32)
    Qc[:, :, 0] = 127
    Q = Qc * 0.02
    v, _ = tsearch.search_exhaustive(tq, Q, k=N)
    oracle = np.einsum("bqd,nld->bnlq", Q.astype(np.float64), emb.astype(np.float64))
    oracle = np.sort(oracle.max(axis=2).sum(axis=-1), axis=1)[:, ::-1]
    np.testing.assert_allclose(v, oracle, rtol=1e-5, atol=1e-6)


def test_int8_unpadded_search_keeps_padding_docs_out():
    """``unpadded=True`` drops the token mask; whole-padding docs still rank
    last, as on the JAX side."""
    emb, _, ids = _corpus(n=13)
    mask = np.ones(emb.shape[:2], bool)
    Q = -np.abs(_queries())  # against |emb|: every real doc totals below 0
    jq = jindex.QuantizedTokenIndex.from_arrays(np.abs(emb), mask, ids, pad_multiple=16)
    tq = tindex.QuantizedTokenIndex.from_arrays(np.abs(emb), mask, ids, device="cpu",
                                                pad_multiple=16)
    fn = tsearch.make_search_fn_int8(16, k=16, unpadded=True)
    got_v, got_i = fn(torch.as_tensor(Q), tq.codes, tq.scales, tq.mask)
    jfn = jsearch.make_search_fn_int8(None, 16, k=16, use_pallas=False, unpadded=True)
    want_v, want_i = jfn(jnp.asarray(Q), jq.codes, jq.scales, jq.mask)
    np.testing.assert_array_equal(got_i[:, :13].numpy(), np.asarray(want_i)[:, :13])
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-6)
    assert got_i[:, :13].max() < 13 and (got_v[:, 13:] < -9000 * Q.shape[1]).all()


def test_retrieval_service_over_quantized_index():
    emb, mask, ids = _corpus(n=30)
    Q = _queries(b=3)
    jq = jindex.QuantizedTokenIndex.from_arrays(emb, mask, ids)
    tq = tindex.QuantizedTokenIndex.from_arrays(emb, mask, ids, device="cpu", pad_multiple=32)
    want_v, want_i = jsearch.search_exhaustive(jq, Q, k=5, use_pallas=False)
    svc = RetrievalService(tsearch.make_search_fn_int8(tq.num_padded_docs, k=5), tq,
                           batch_queries=4, max_wait_ms=50)
    try:
        results = [f.result(timeout=60) for f in [svc.search(q) for q in Q]]
    finally:
        svc.close()
    assert not svc.batcher._worker.is_alive()
    assert [r for r, _ in results] == [[ids[j] for j in row] for row in want_i]
    np.testing.assert_allclose(np.stack([v for _, v in results]), want_v,
                               rtol=1e-5, atol=1e-6)
