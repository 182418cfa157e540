"""Kernel K1's plain version and the port's exact search against the JAX
package: ``maxsim_scores_pallas`` (interpret mode), ``colbert_score`` and
``engine/search.py::search_exhaustive`` on a tiny ``TokenIndex``.

Inputs are made with numpy from a seed and fed to both sides. On the CPU the
port's ``maxsim_scores`` wrapper takes its plain version.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine import index as jindex  # noqa: E402
from reranking_multimodal_retrievers_tpu.engine import search as jsearch  # noqa: E402
from reranking_multimodal_retrievers_tpu.ops.maxsim import colbert_score  # noqa: E402
from reranking_multimodal_retrievers_tpu.ops.maxsim_pallas import (  # noqa: E402
    maxsim_scores_pallas,
)
from reranking_multimodal_retrievers_tpu_torch.engine import index as tindex  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import search as tsearch  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops import maxsim as tmaxsim  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import (  # noqa: E402
    maxsim_scores,
)
from reranking_multimodal_retrievers_tpu_torch.ops.topk import (  # noqa: E402
    tiled_top_k,
    top_k_scores,
)

# L_q = 12 is not a multiple of 8; doc 5 is all padding
B, L_Q, N, L_D, DIM = 4, 12, 8, 10, 16


def _inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(B, L_Q, DIM)).astype(np.float32)
    D = rng.normal(size=(N, L_D, DIM)).astype(np.float32)
    lens = rng.integers(1, L_D + 1, size=N)
    mask = np.arange(L_D)[None, :] < lens[:, None]
    mask[5] = False
    if dtype == "bf16":  # bf16-representable values, held in fp32
        Q = np.asarray(jnp.asarray(Q, jnp.bfloat16).astype(jnp.float32))
        D = np.asarray(jnp.asarray(D, jnp.bfloat16).astype(jnp.float32))
    return Q, D, mask


def _port(Q, D, mask, dtype=torch.float32, score_dtype=torch.float32):
    launches = maxsim_scores.launches
    out = maxsim_scores(torch.tensor(Q, dtype=dtype), torch.tensor(D, dtype=dtype),
                        None if mask is None else torch.tensor(mask),
                        score_dtype=score_dtype)
    assert maxsim_scores.launches == launches  # CPU tensors: plain version
    return out.numpy()


@pytest.mark.parametrize("masked", [True, False])
def test_plain_k1_matches_pallas_fp32(masked):
    Q, D, mask = _inputs(0)
    m = mask if masked else None
    want = np.asarray(maxsim_scores_pallas(
        jnp.asarray(Q), jnp.asarray(D), None if m is None else jnp.asarray(m),
        B_blk=2, C_blk=4, interpret=True))
    got = _port(Q, D, m)
    assert got.shape == (B, N) and got.dtype == np.float32
    # fp32 sums of <= 12 maxima of 16-term dot products: 1e-4 abs; the
    # all-padding doc totals about -9999 * 12, where fp32 spacing is 1/128,
    # hence the 1e-6 relative term
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)
    if masked:
        assert got[:, 5].max() < -9000 * L_Q


def test_plain_k1_matches_pallas_bf16_inputs():
    """bf16 Q and D, fp32 token scores: products of bf16 values are exact in
    fp32 on both sides, so only the summation order differs (1e-4 abs)."""
    Q, D, mask = _inputs(1, dtype="bf16")
    want = np.asarray(maxsim_scores_pallas(
        jnp.asarray(Q, jnp.bfloat16), jnp.asarray(D, jnp.bfloat16), jnp.asarray(mask),
        B_blk=2, C_blk=4, interpret=True))
    got = _port(Q, D, mask, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)


def test_plain_k1_matches_pallas_bf16_scores():
    """score_dtype bf16: each token score is rounded to bf16 before the mask
    add and the max. A different fp32 summation order can move a score across
    a bf16 rounding boundary, so each of the 12 maxima may differ by one bf16
    spacing (2^-8 relative, scores below 8): tolerance 12 * 8 * 2^-8."""
    Q, D, mask = _inputs(2, dtype="bf16")
    want = np.asarray(maxsim_scores_pallas(
        jnp.asarray(Q), jnp.asarray(D), jnp.asarray(mask), B_blk=2, C_blk=4,
        interpret=True, score_dtype=jnp.bfloat16))
    got = _port(Q, D, mask, score_dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=L_Q * 8 * 2 ** -8, rtol=1e-3)


def test_colbert_score_matches_jax():
    Q, D, mask = _inputs(3)
    for q in (Q[:1], np.repeat(Q[:1], N, axis=0)):  # one query, aligned pairs
        want_s, want_m = colbert_score(jnp.asarray(q), jnp.asarray(D), jnp.asarray(mask))
        got_s, got_m = tmaxsim.colbert_score(torch.tensor(q), torch.tensor(D),
                                             torch.tensor(mask))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4, rtol=1e-6)
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5)
    # the plain K1 agrees with colbert_score one query at a time on every doc
    # with a valid token; on the all-padding doc K1 adds -9999 to each score
    # (totals near -9999 * L_q) where colbert_score fills exactly -9999
    got = _port(Q, D, mask)
    valid = mask.any(axis=1)
    for b in range(B):
        s, _ = tmaxsim.colbert_score(torch.tensor(Q[b:b + 1]), torch.tensor(D),
                                     torch.tensor(mask))
        np.testing.assert_allclose(got[b, valid], s.numpy()[valid], atol=1e-4, rtol=1e-6)
        assert got[b, ~valid].max() < -9000 * L_Q and s.numpy()[~valid].max() < -9000 * L_Q


def test_plain_k1_chunks_over_docs(monkeypatch):
    """The plain version's doc chunking does not change its result."""
    from reranking_multimodal_retrievers_tpu_torch.ops import maxsim_cuda

    Q, D, mask = _inputs(4)
    whole = _port(Q, D, mask)
    monkeypatch.setattr(maxsim_cuda, "_PLAIN_CHUNK_BYTES", 1)  # one doc a chunk
    # only the matmul's blocking changes: fp32 round-off, as above
    np.testing.assert_allclose(_port(Q, D, mask), whole, atol=1e-4, rtol=1e-6)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _tiny_index(seed, n_docs=13, pad_to=16, ragged=True):
    rng = np.random.default_rng(seed)
    emb = _unit(rng, n_docs, L_D, DIM)
    lens = rng.integers(2, L_D + 1, size=n_docs) if ragged else np.full(n_docs, L_D)
    mask = np.arange(L_D)[None, :] < lens[:, None]
    emb = emb * mask[..., None]
    ids = [f"doc{i}" for i in range(n_docs)]
    Q = _unit(rng, 3, L_Q, DIM)
    Q[:, -2:] = 0.0  # masked query rows are zero
    jidx = jindex.TokenIndex.from_arrays(emb, mask, ids, pad_multiple=pad_to)
    tidx = tindex.TokenIndex.from_arrays(emb, mask, ids, device="cpu", pad_multiple=pad_to)
    return jidx, tidx, Q


def test_search_topk_matches_jax():
    """Top-k ids and values against the JAX exact search over a TokenIndex
    padded from 13 to 16 docs: the three whole-padding docs never win."""
    jidx, tidx, Q = _tiny_index(5)
    assert tidx.num_padded_docs == 16 and tidx.num_docs == 13
    np.testing.assert_array_equal(tidx.embeddings.float().numpy(),
                                  np.asarray(jidx.embeddings.astype(jnp.float32)))
    want_v, want_i = jsearch.search_exhaustive(jidx, jnp.asarray(Q), k=5)
    got_v, got_i = tsearch.search_exhaustive(tidx, Q, k=5)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, atol=1e-4)
    assert got_i.max() < 13

    ids, vals = tsearch.Searcher(tidx, k=5).search(Q)
    assert ids == [[f"doc{j}" for j in row] for row in want_i]
    np.testing.assert_allclose(vals, want_v, atol=1e-4)


def test_unpadded_search_keeps_padding_docs_out():
    """``unpadded=True`` (every real doc has all L_d tokens) drops the token
    mask, so a whole-padding doc (zero embeddings) would total exactly 0 and
    outrank real docs with negative totals; the per-doc guard keeps it out,
    as on the JAX side."""
    jidx, tidx, Q = _tiny_index(6, ragged=False)
    Qn = -np.abs(Q)  # every real doc totals below zero
    emb = tidx.embeddings
    Q16 = torch.tensor(Qn).to(emb.dtype)
    fn = tsearch.make_search_fn(tidx.num_padded_docs, k=16, unpadded=True)
    got_v, got_i = fn(Q16, emb.abs(), tidx.mask)
    jfn = jsearch.make_search_fn(None, jidx.num_padded_docs, k=16, unpadded=True)
    want_v, want_i = jfn(jnp.asarray(Qn, jnp.bfloat16), jnp.abs(jidx.embeddings), jidx.mask)
    np.testing.assert_array_equal(got_i[:, :13].numpy(), np.asarray(want_i)[:, :13])
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-4, rtol=1e-6)
    assert got_i[:, :13].max() < 13  # padding docs rank last
    assert (got_v[:, 13:] < -9000 * L_Q).all()


def test_topk_matches_jax():
    rng = np.random.default_rng(7)
    s = rng.normal(size=(3, 10000)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), 20)
    for fn in (top_k_scores, lambda x, k: tiled_top_k(x, k, tile=1024)):
        v, i = fn(torch.tensor(s), 20)
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))


def test_wrapper_refuses_a_non_cuda_device():
    """A tensor that is on neither the CPU nor CUDA gets no plain fallback."""
    q = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        maxsim_scores(q, torch.empty(3, 4, 8, device="meta"))
