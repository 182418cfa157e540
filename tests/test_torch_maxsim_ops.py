"""The port's MaxSim reductions (``ops/maxsim.py``: ``in_batch_maxsim_scores``,
``padded_maxsim``, ``segmented_maxsim``, ``flipr_score_reduce`` and
``colbert_score``'s two interactions) against the JAX package's, on the
cases of ``tests/test_maxsim.py``, values and gradients.

Both sides in fp32 on the CPU (JAX at matmul precision "highest"). Values
within 1e-5: fp32 sums of at most a few tens of terms of order 1, in
another order. Gradients within 1e-5 too: each is a sum of a few products
of order 1 routed through the same argmax entries (ties share the gradient
evenly on both sides).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.ops import maxsim as jm  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops import maxsim as tm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(rng, n_docs=5, L_d=17, L_q=9, dim=8):
    Q = rng.normal(size=(n_docs, L_q, dim)).astype(np.float32)
    D = rng.normal(size=(n_docs, L_d, dim)).astype(np.float32)
    lens = rng.integers(1, L_d + 1, size=n_docs)
    D_mask = (np.arange(L_d)[None, :] < lens[:, None]).astype(np.int32)
    return Q, D * D_mask[:, :, None], D_mask


def _t(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


@pytest.mark.parametrize("one_query", [False, True])
@pytest.mark.parametrize("interaction", ["colbert", "flipr"])
def test_colbert_score_and_grad(one_query, interaction):
    rng = np.random.default_rng(0)
    Q, D, M = _batch(rng, L_q=12)
    if one_query:
        Q = Q[:1]
    kw = dict(interaction=interaction, query_maxlen=6, K2=3)
    want, want_masked = jm.colbert_score(jnp.asarray(Q), jnp.asarray(D), jnp.asarray(M), **kw)
    gq, gd = jax.grad(lambda q, d: jnp.sum(jm.colbert_score(q, d, jnp.asarray(M), **kw)[0]
                                           * jnp.arange(1.0, 6.0)),
                      argnums=(0, 1))(jnp.asarray(Q), jnp.asarray(D))
    q, d = _t(Q, True), _t(D, True)
    got, got_masked = tm.colbert_score(q, d, torch.tensor(M), **kw)
    (got * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got_masked.detach().numpy() == -9999.0,
                                  np.asarray(want_masked) == -9999.0)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(gq), **TOL)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd), **TOL)


def test_masked_query_tokens_contribute_zero():
    rng = np.random.default_rng(0)
    Q, D, M = _batch(rng)
    Qz = Q.copy()
    Qz[:, -3:] = 0.0
    got = tm.colbert_score(_t(Qz), _t(D), torch.tensor(M))[0]
    want = jm.colbert_score(jnp.asarray(Qz[:, :-3]), jnp.asarray(D), jnp.asarray(M))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flipr_short_expansion_adds_nothing():
    """Fewer expansion columns than K2: the reference adds nothing for them."""
    rng = np.random.default_rng(4)
    raw = rng.normal(size=(3, 7, 10)).astype(np.float32)
    M = np.ones((3, 7), np.int32)
    got = tm.flipr_score_reduce(_t(raw), torch.tensor(M), query_maxlen=8, K2=4)[0]
    want = jm.flipr_score_reduce(jnp.asarray(raw), jnp.asarray(M), query_maxlen=8, K2=4)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        tm.flipr_score_reduce(_t(raw), torch.tensor(M), query_maxlen=11)


def test_padded_maxsim_and_masked_tensor():
    rng = np.random.default_rng(0)
    Q, D, M = _batch(rng)
    raw = np.einsum("btd,bld->btl", D, Q)
    got = tm.padded_maxsim(_t(raw), torch.tensor(M))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.padded_maxsim(jnp.asarray(raw),
                                                                        jnp.asarray(M))), **TOL)
    masked = tm.colbert_score_reduce(_t(raw), torch.tensor(M))[1].numpy()
    assert (masked[~M.astype(bool)] == -9999.0).all()


def test_in_batch_maxsim_scores_and_grad():
    rng = np.random.default_rng(0)
    B_q, B_d, L_q, L_d, dim = 3, 6, 5, 11, 8
    Q = rng.normal(size=(B_q, L_q, dim)).astype(np.float32)
    D = rng.normal(size=(B_d, L_d, dim)).astype(np.float32)
    lens = rng.integers(1, L_d + 1, size=B_d)
    lens[2] = 0  # a doc with no valid token
    M = (np.arange(L_d)[None, :] < lens[:, None]).astype(np.int32)
    w = rng.normal(size=(B_q, B_d)).astype(np.float32)
    fn = lambda q, d: jnp.sum(jm.in_batch_maxsim_scores(q, d, jnp.asarray(M)) * w)  # noqa: E731
    gq, gd = jax.grad(fn, argnums=(0, 1))(jnp.asarray(Q), jnp.asarray(D))
    q, d = _t(Q, True), _t(D, True)
    got = tm.in_batch_maxsim_scores(q, d, torch.tensor(M))
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(
        jm.in_batch_maxsim_scores(jnp.asarray(Q), jnp.asarray(D), jnp.asarray(M))),
        rtol=1e-5, atol=1e-3)  # the empty doc totals -9999 * 5: 1e-3 is 2e-8 of it
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(gq), **TOL)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd), **TOL)
    assert not d.grad[2].any()  # nothing flows into a doc with no valid token


@pytest.mark.parametrize("doclens,extra", [([3, 1, 5, 2], 3), ([2, 0, 3], 0)])
def test_segmented_maxsim(doclens, extra):
    rng = np.random.default_rng(0)
    doclens = np.asarray(doclens, np.int32)
    packed = rng.normal(size=(int(doclens.sum()) + extra, 6)).astype(np.float32)
    want = np.asarray(jm.segmented_maxsim(jnp.asarray(packed), jnp.asarray(doclens),
                                          len(doclens)))
    got = tm.segmented_maxsim(_t(packed), torch.tensor(doclens).long(), len(doclens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if (doclens == 0).any():
        assert got[doclens == 0].eq(0).all()
