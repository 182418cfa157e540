"""The port's compressed engine (``engine/{kmeans,codec,plaid,compress}.py``)
against the JAX package's, on the CPU, inputs from numpy seeds.

Tolerances, each from the arithmetic both sides do in fp32 (JAX at matmul
precision "highest"):
- centroids within 1e-5: sums of at most a few hundred unit rows in another
  order (one-hot product against ``segment_sum``), renormalised, over up to
  20 rounds; assignments equal (no near-tie in these seeded data);
- codec: codes equal; scales within 1e-6 relative plus 4e-7 / 127 absolute
  (the same division of the running max of the same residuals, which a
  centroid's round-off, a few ulps of a unit vector, moves by up to 4e-7);
  the port's int8 residuals are its own unrounded residual / scale rounded
  half to even, and differ from JAX's only where the two unrounded values,
  apart by the round-off of centroids and scales over the scale, lie on
  either side of a rounding boundary, less than 5% of a step apart
  (``RESID_TIE``: a wrong scale or rounding moves values by a whole step);
- decompress within 1e-6 (an fp32 multiply and add);
- search scores within 1e-4: sums of at most 8 maxima of 32-term fp32 dot
  products in another order; ids equal up to near-ties (``assert_same_topk``);
- pooling within 1e-5 in fp32; a pooled bf16 index within one bf16 spacing
  of unit vectors (2^-8).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine import codec as jcodec  # noqa: E402
from reranking_multimodal_retrievers_tpu.engine import compress as jcompress  # noqa: E402
from reranking_multimodal_retrievers_tpu.engine import kmeans as jkmeans  # noqa: E402
from reranking_multimodal_retrievers_tpu.engine import plaid as jplaid  # noqa: E402
from reranking_multimodal_retrievers_tpu.engine.index import TokenIndex as JTokenIndex  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import codec, compress, kmeans, plaid  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine.index import (  # noqa: E402
    QuantizedTokenIndex,
    TokenIndex,
)
from reranking_multimodal_retrievers_tpu_torch.engine.search import search_exhaustive  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops import maxsim_cuda  # noqa: E402

CENTROID_TOL = 1e-5
SCALE_RTOL = 1e-6
DECOMPRESS_TOL = 1e-6
SCORE_TOL = 1e-4
POOL_TOL = 1e-5
BF16_SPACING = 2.0 ** -8
SCALE_ATOL = 4e-7 / 127
RESID_TIE = 0.05


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-6)


def corpus(whole_padding_doc=None):
    """``tests/test_engine_extras.py``'s corpus: 64 docs of 4-12 tokens of
    dim 32, 4 queries of 8 tokens. ``whole_padding_doc``: a doc made all
    padding."""
    rng = np.random.default_rng(0)
    N, L, D = 64, 12, 32
    emb = rng.normal(size=(N, L, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    lens = rng.integers(4, L + 1, size=N)
    mask = np.arange(L)[None] < lens[:, None]
    if whole_padding_doc is not None:
        mask[whole_padding_doc] = False
    emb *= mask[:, :, None]
    Q = rng.normal(size=(4, 8, D)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    return emb, mask, Q


def to_port(jidx):
    """A JAX CompressedTokenIndex's arrays as the port's index, on the CPU."""
    return codec.CompressedTokenIndex(
        centroids=torch.tensor(np.asarray(jidx.centroids)),
        codes=torch.tensor(np.asarray(jidx.codes)),
        residuals=torch.tensor(np.asarray(jidx.residuals)),
        scales=torch.tensor(np.asarray(jidx.scales)),
        mask=torch.tensor(np.asarray(jidx.mask)),
        doc_ids=list(jidx.doc_ids))


def assert_same_index(got, want, emb):
    """The port's index against JAX's, compressed from ``emb``."""
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=0, atol=CENTROID_TOL)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales), rtol=SCALE_RTOL,
                               atol=SCALE_ATOL)
    g = got.residuals.numpy()
    q_port = (emb - got.centroids.numpy()[got.codes.numpy()]) / got.scales.numpy()
    np.testing.assert_array_equal(g, np.clip(np.round(q_port), -127, 127))
    q_jax = (emb - np.asarray(want.centroids)[np.asarray(want.codes)]) / np.asarray(want.scales)
    flips = g != np.asarray(want.residuals)
    assert (np.abs(q_jax - q_port)[flips] < RESID_TIE).all(), (q_jax[flips], q_port[flips])
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.doc_ids == list(want.doc_ids)
    assert got.codes.dtype == torch.int32 and got.residuals.dtype == torch.int8
    assert got.nbytes() == want.nbytes() and got.bytes_per_token == want.bytes_per_token


def assert_same_topk(got_vals, got_ids, want_vals, want_ids, tol=SCORE_TOL):
    """Values within ``tol`` rank by rank; an id may differ from JAX's only
    between docs whose JAX values lie within ``tol`` (an order swap), or at
    the boundary for a doc whose value is within ``tol`` of JAX's last."""
    np.testing.assert_allclose(got_vals, want_vals, rtol=0, atol=tol)
    for gv, gi, wv, wi in zip(got_vals, got_ids, want_vals, want_ids):
        rank = {int(d): r for r, d in enumerate(wi)}
        for r, d in enumerate(gi):
            if d == wi[r]:
                continue
            if int(d) in rank:
                assert abs(wv[rank[int(d)]] - wv[r]) <= tol, (r, d, wi)
            else:
                assert abs(gv[r] - wv[-1]) <= tol, (r, d, wi)


@pytest.mark.parametrize("estimate", [0, 1, 3, 10_000, 123_456, 25_600_000])
def test_num_partitions_heuristic(estimate):
    assert kmeans.num_partitions_heuristic(estimate) == jkmeans.num_partitions_heuristic(estimate)


def _clusters():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(100, 8)) * 0.05 + np.array([1] + [0] * 7)
    b = rng.normal(size=(100, 8)) * 0.05 + np.array([0, 1] + [0] * 6)
    x = np.concatenate([a, b]).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True), 2, 10


def _random_rows():
    rng = np.random.default_rng(3)
    return _unit(rng.normal(size=(600, 16))).astype(np.float32), 24, 20


def _tiny_sample():
    """Fewer rows than k: the init is tiled up to k rows, and clusters stay
    empty and are re-seeded."""
    return np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32), 16, 3


@pytest.mark.parametrize("data", [_clusters, _random_rows, _tiny_sample],
                         ids=["two_clusters", "random_rows", "tiled_init"])
def test_train_centroids_matches_jax(data):
    x, k, n_iters = data()
    want_c, want_a = jkmeans.train_centroids(x, k=k, n_iters=n_iters, seed=5)
    c, a = kmeans.train_centroids(x, k=k, n_iters=n_iters, seed=5, device="cpu")
    assert c.shape == (k, x.shape[1]) and a.shape == (len(x),) and a.dtype == np.int32
    np.testing.assert_allclose(c, want_c, rtol=0, atol=CENTROID_TOL)
    np.testing.assert_array_equal(a, want_a)


def test_kmeans_separates_clusters():
    x, k, n_iters = _clusters()
    _, assign = kmeans.train_centroids(x, k=k, n_iters=n_iters, device="cpu")
    assert len(set(assign[:100])) == 1 and len(set(assign[100:])) == 1
    assert assign[0] != assign[150]


def test_train_centroids_empty_sample_raises():
    with pytest.raises(ValueError, match="empty"):
        kmeans.train_centroids(np.zeros((0, 8), np.float32), k=4, device="cpu")


@pytest.mark.parametrize("token_chunk", [1 << 21, 100], ids=["one_slab", "slabs_of_100"])
def test_compress_matches_jax(token_chunk):
    emb, mask, _ = corpus()
    ids = [f"d{i}" for i in range(len(emb))]
    kw = dict(num_centroids=32, sample_size=512, seed=1)
    want = jcodec.compress(emb, mask, ids, **kw)
    got = codec.compress(emb, mask, ids, token_chunk=token_chunk, device="cpu", **kw)
    assert_same_index(got, want, emb)


def test_compress_device_and_host_inputs_agree():
    """A tensor on the target device (sliced there) and a host array
    (shipped a slab at a time) give the same index; so does JAX's device
    input branch."""
    emb, mask, _ = corpus()
    ids = [f"d{i}" for i in range(len(emb))]
    kw = dict(num_centroids=32, sample_size=512, token_chunk=128)
    host = codec.compress(emb, mask, ids, device="cpu", **kw)
    dev = codec.compress(torch.tensor(emb), torch.tensor(mask), ids, device="cpu", **kw)
    for name in ("centroids", "codes", "residuals", "scales", "mask"):
        assert torch.equal(getattr(host, name), getattr(dev, name)), name
    assert_same_index(dev, jcodec.compress(jnp.asarray(emb), mask, ids, **kw), emb)


def test_codec_scales_ignore_padding_rows():
    """``tests/test_engine_extras.py``'s padding case: per-dim scales come
    from valid residuals only, not from a padding token's -centroid."""
    rng = np.random.default_rng(7)
    dim = 16
    centers = _unit(rng.normal(size=(2, dim))).astype(np.float32)
    emb = np.zeros((8, 4, dim), np.float32)
    mask = np.zeros((8, 4), bool)
    for i in range(8):
        for j in range(3):  # the last token of every doc is padding
            emb[i, j] = centers[(i + j) % 2] + rng.normal(scale=1e-3, size=dim)
            mask[i, j] = True
    ids = [f"d{i}" for i in range(8)]
    idx = codec.compress(emb, mask, ids, num_centroids=2, sample_size=24, device="cpu")
    assert_same_index(idx, jcodec.compress(emb, mask, ids, num_centroids=2, sample_size=24),
                      emb)
    assert float(idx.scales.max()) < 1e-3
    rec = codec.decompress(idx.codes, idx.residuals, idx.centroids, idx.scales).numpy()
    assert np.abs(rec - emb)[mask].max() < 5e-5


def test_decompress_matches_jax():
    emb, mask, _ = corpus()
    jidx = jcodec.compress(emb, mask, list(range(len(emb))), num_centroids=32, sample_size=512)
    idx = to_port(jidx)
    want = np.asarray(jcodec.decompress(jidx.codes, jidx.residuals, jidx.centroids, jidx.scales))
    got = codec.decompress(idx.codes, idx.residuals, idx.centroids, idx.scales)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DECOMPRESS_TOL)
    valid = mask.astype(bool)
    assert np.abs(got.numpy()[valid] - emb[valid]).max() < 0.05
    assert idx.nbytes() < emb.nbytes / 2


@pytest.mark.parametrize("n_candidates", [32, 100], ids=["cand32", "cand_ge_N"])
@pytest.mark.parametrize("chunk", [16, 7], ids=["chunk16", "chunk7_to_4"])
@pytest.mark.parametrize("stage1_bf16", [True, False], ids=["bf16", "fp32"])
def test_compressed_searcher_matches_jax(stage1_bf16, chunk, n_candidates):
    emb, mask, Q = corpus()
    jidx = jcodec.compress(emb, mask, [f"d{i}" for i in range(len(emb))],
                           num_centroids=32, sample_size=512)
    kw = dict(k=5, n_candidates=n_candidates, chunk=chunk, stage1_bf16=stage1_bf16)
    want = jplaid.CompressedSearcher(jidx, **kw)
    got = plaid.CompressedSearcher(to_port(jidx), **kw)
    assert (got.chunk, got.n_candidates, got.k) == (want.chunk, want.n_candidates, want.k)
    wv, wi = want.search(Q)
    gv, gi = got.search(Q)
    assert gv.dtype == np.float32 and gv.shape == (4, 5)
    assert_same_topk(gv, gi, np.asarray(wv), np.asarray(wi))


def test_compressed_search_close_to_exact():
    """``tests/test_engine_extras.py``'s recall check on the port's own
    compress and search: top-1 is the exact top-1, every returned doc's
    exact score is near its reported one, top-5 overlaps the exact top-5."""
    emb, mask, Q = corpus()
    idx = codec.compress(emb, mask, [f"d{i}" for i in range(len(emb))],
                         num_centroids=32, sample_size=512, device="cpu")
    vals, ids = plaid.CompressedSearcher(idx, k=5, n_candidates=32, chunk=16).search(Q)
    scores = np.where(mask[None, :, :, None], np.einsum("bqd,nld->bnlq", Q, emb), -9999.0)
    exact = scores.max(axis=2).sum(axis=-1)
    np.testing.assert_array_equal(ids[:, 0], np.argsort(-exact, axis=1)[:, 0])
    top5 = np.argsort(-exact, axis=1)[:, :5]
    for b in range(len(Q)):
        np.testing.assert_allclose(vals[b], exact[b, ids[b]], rtol=0.05, atol=0.05)
        assert len(set(ids[b].tolist()) & set(top5[b].tolist())) >= 4


@pytest.mark.parametrize("stage1_bf16", [True, False], ids=["bf16", "fp32"])
def test_whole_padding_doc_matches_jax(stage1_bf16):
    """A doc with no valid token, every doc returned (k = N): its total is
    JAX's -9999 * L_q through the plain stage 1 and stage 2."""
    emb, mask, Q = corpus(whole_padding_doc=9)
    jidx = jcodec.compress(emb, mask, list(range(len(emb))), num_centroids=32, sample_size=512)
    kw = dict(k=64, n_candidates=64, chunk=16, stage1_bf16=stage1_bf16)
    wv, wi = jplaid.CompressedSearcher(jidx, **kw).search(Q)
    gv, gi = plaid.CompressedSearcher(to_port(jidx), **kw).search(Q)
    assert_same_topk(gv, gi, np.asarray(wv), np.asarray(wi))
    assert (gi[:, -1] == 9).all() and (gv[:, -1] == -9999.0 * Q.shape[1]).all()


def test_stage1_through_k1_route_equals_plain_stage1():
    """The card's stage 1 (decompress a slab, round to bf16, K1 under the
    mask, the whole-padding guard) taken on the CPU, where K1's wrapper runs
    its plain version: the JAX einsum's scores, whole-padding doc included,
    and no kernel launch."""
    emb, mask, Q = corpus(whole_padding_doc=9)
    idx = codec.compress(emb, mask, list(range(len(emb))), num_centroids=32, sample_size=512,
                         device="cpu")
    args = (torch.tensor(Q), idx.codes, idx.residuals, idx.centroids, idx.scales, idx.mask)
    before = maxsim_cuda.maxsim_scores.launches
    k1 = plaid.stage1_k1(*args, slab=24)
    plain = plaid.stage1_plain(*args, chunk=16, bf16=True)
    assert maxsim_cuda.maxsim_scores.launches == before
    np.testing.assert_allclose(k1.numpy(), plain.numpy(), rtol=0, atol=SCORE_TOL)
    assert (plain[:, 9] == -9999.0 * Q.shape[1]).all() and (k1[:, 9] == plain[:, 9]).all()


def _pool_corpus(N=64, L=16, dim=32, seed=0):
    """``tests/test_compress.py``'s corpus: docs of a few topic directions
    with noise, a 3-token padding tail."""
    rng = np.random.default_rng(seed)
    topics = _unit(rng.normal(size=(N, 4, dim)))
    emb = np.stack([t[rng.integers(0, 4, size=L)] + 0.1 * rng.normal(size=(L, dim))
                    for t in topics])
    emb = _unit(emb).astype(np.float32)
    mask = np.ones((N, L), bool)
    mask[:, L - 3:] = False
    return emb, mask


@pytest.mark.parametrize("factor,iters", [(2, 4), (4, 2), (2, 0)])
def test_pool_doc_tokens_matches_jax(factor, iters):
    emb, mask = _pool_corpus()
    wp, wm = jcompress.pool_doc_tokens(jnp.asarray(emb), jnp.asarray(mask), factor=factor,
                                       iters=iters)
    gp, gm = compress.pool_doc_tokens(torch.tensor(emb), torch.tensor(mask), factor=factor,
                                      iters=iters)
    assert gp.dtype == torch.float32 and gp.shape == (64, 16 // factor, 32)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=POOL_TOL)
    valid = gm.numpy()
    np.testing.assert_allclose(np.linalg.norm(gp.numpy(), axis=-1)[valid], 1.0, atol=1e-3)
    assert np.abs(gp.numpy()[~valid]).max(initial=0.0) == 0.0


def test_pool_doc_tokens_rejects_non_divisor():
    emb, mask = _pool_corpus(L=16)
    with pytest.raises(ValueError, match="divide"):
        compress.pool_doc_tokens(torch.tensor(emb), torch.tensor(mask), factor=3)


@pytest.mark.parametrize("batch", [None, 8, 5], ids=["whole", "batch8", "batch5"])
def test_pool_index_matches_jax(batch):
    emb, mask = _pool_corpus(N=32, L=8, dim=32, seed=3)
    ids = [f"d{i}" for i in range(32)]
    want = jcompress.pool_index(JTokenIndex.from_arrays(emb, mask, ids), factor=2, iters=3)
    got = compress.pool_index(TokenIndex.from_arrays(emb, mask, ids, device="cpu"), factor=2,
                              iters=3, batch=batch)
    assert got.embeddings.dtype == torch.bfloat16 and got.doc_ids == ids
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.embeddings.float().numpy(),
                               np.asarray(want.embeddings, np.float32), rtol=0,
                               atol=BF16_SPACING)


def test_pooled_search_preserves_ranking():
    """``tests/test_compress.py``'s contract on the port: queries planted
    from a doc's tokens still retrieve it from the pooled index."""
    emb, mask = _pool_corpus(N=128, L=16, dim=32, seed=1)
    full = TokenIndex.from_arrays(emb, mask, [f"d{i}" for i in range(128)], device="cpu")
    pooled = compress.pool_index(full, factor=2, iters=5)
    assert pooled.embeddings.shape[1] == 8
    rng = np.random.default_rng(2)
    targets = list(range(0, 32, 4))
    Q = np.stack([_unit(emb[t, :8] + 0.05 * rng.normal(size=(8, 32))) for t in targets])
    _, idx_full = search_exhaustive(full, Q.astype(np.float32), k=5)
    _, idx_pool = search_exhaustive(pooled, Q.astype(np.float32), k=5)
    assert all(idx_full[i][0] == t for i, t in enumerate(targets))
    assert sum(t in idx_pool[i] for i, t in enumerate(targets)) >= len(targets) - 1


def test_pooling_composes_with_int8_index():
    rng = np.random.default_rng(0)
    N, Ld, dim = 48, 8, 32
    emb = _unit(rng.normal(size=(N, Ld, dim))).astype(np.float32)
    full = TokenIndex.from_arrays(emb, np.ones((N, Ld), bool), [f"d{i}" for i in range(N)],
                                  device="cpu")
    q8 = QuantizedTokenIndex.from_token_index(compress.pool_index(full, factor=2))
    assert q8.doc_maxlen == Ld // 2 and q8.codes.dtype == torch.int8
    Q = emb[:4, :6]
    _, idx_fp = search_exhaustive(full, Q, k=3)
    _, idx_q8 = search_exhaustive(q8, Q, k=3)
    assert np.array_equal(idx_fp[:, 0], np.arange(4)) and np.array_equal(idx_q8[:, 0], np.arange(4))
