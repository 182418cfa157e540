"""The port's retrieve-then-rerank slice end to end at tiny size, against the
JAX package on the same inputs and weights:

encode_corpus -> TokenIndex -> RetrievalService top-k (ids identical to JAX's
search_exhaustive) -> RerankService over make_chunked_rerank_fn with a
FullContextRerankModel (logits against JAX's make_chunked_rerank_fn).

Everything runs on the CPU, where the kernel wrappers take their plain
versions: their CUDA launch counters stay where they were.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine import index as jindex  # noqa: E402
from reranking_multimodal_retrievers_tpu.engine import search as jsearch  # noqa: E402
from reranking_multimodal_retrievers_tpu.engine.rerank_eval import (  # noqa: E402
    make_chunked_rerank_fn as jmake_rerank,
)
from reranking_multimodal_retrievers_tpu.models import bert as jbert  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import flmr as jflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu.models.rerankers import (  # noqa: E402
    rerank_model as jrerank,
)
from reranking_multimodal_retrievers_tpu_torch.engine import (  # noqa: E402
    encode_corpus,
    make_chunked_rerank_fn,
    make_search_fn,
)
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import flmr as tflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (  # noqa: E402
    rerank_model as trerank,
)
from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (  # noqa: E402
    fused_self_attention,
)
from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import (  # noqa: E402
    maxsim_scores,
)
from reranking_multimodal_retrievers_tpu_torch.serving import (  # noqa: E402
    RerankService,
    RetrievalService,
)

N_DOCS, L_D, L_Q, B, K, L = 12, 12, 8, 3, 4, 16
_BERT = dict(use_pallas_attention=True)


def _tokens(rng, n, length, min_len):
    ids = rng.integers(8, 1000, size=(n, length)).astype(np.int32)
    lens = rng.integers(min_len, length + 1, size=n)
    am = (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)
    return ids * am, am


def test_retrieve_then_rerank_matches_jax():
    rng = np.random.default_rng(0)
    launches = (maxsim_scores.launches, fused_self_attention.launches)

    # ---- retrieval: FLMR doc/query encoders, index, exact top-k
    jcfg = jflmr.FLMRConfig.tiny(text_config=jbert.BertConfig.tiny(**_BERT))
    tcfg = tflmr.FLMRConfig.tiny(text_config=tbert.BertConfig.tiny(**_BERT))
    doc_ids, doc_am = _tokens(rng, N_DOCS, L_D, 3)
    q_ids, q_am = _tokens(rng, B, L_Q, L_Q)
    pix = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
    jm = jflmr.FLMRModelForRetrieval(jcfg)
    init = jax.jit(jm.init, static_argnames="num_negative_examples")
    params = jax.device_get(init(jax.random.PRNGKey(0), q_ids, q_am, doc_ids[:B],
                                 doc_am[:B], query_pixel_values=pix,
                                 num_negative_examples=0)["params"])
    tm = tflmr.FLMRModelForRetrieval(tcfg, device="cpu")
    tm.load_state_dict(weights.flmr_state_dict(params))

    batches = [(doc_ids[i:i + 6], doc_am[i:i + 6]) for i in range(0, N_DOCS, 6)]
    names = [f"d{i}" for i in range(N_DOCS)]

    @jax.jit
    def jdoc(batch):
        out = jm.apply({"params": params}, *batch, method=jflmr.FLMRModelForRetrieval.doc)
        return out.late_interaction_output, out.context_mask

    def tdoc(batch):
        out = tm.doc(torch.as_tensor(batch[0]).long(), torch.as_tensor(batch[1]))
        return out.late_interaction_output, out.context_mask

    jidx = jindex.encode_corpus(jdoc, batches, names, pad_multiple=16)
    tidx = encode_corpus(tdoc, batches, names, device="cpu", pad_multiple=16)
    assert tidx.num_padded_docs == 16
    np.testing.assert_array_equal(tidx.mask.numpy(), np.asarray(jidx.mask))
    # the doc matrices agree to fp32 round-off before the fp16/bf16 casts:
    # one bf16 spacing of a unit-norm component at most
    np.testing.assert_allclose(tidx.embeddings.float().numpy(),
                               np.asarray(jidx.embeddings.astype(jnp.float32)),
                               atol=2 ** -8)

    jq = jax.jit(lambda *a: jm.apply({"params": params}, *a,
                                     method=jflmr.FLMRModelForRetrieval.query)
                 )(q_ids, q_am, pix).late_interaction_output
    with torch.no_grad():
        tq = tm.query(torch.as_tensor(q_ids).long(), torch.as_tensor(q_am),
                      pixel_values=torch.as_tensor(pix)).late_interaction_output
    want_v, want_i = jsearch.search_exhaustive(jidx, jq, k=5)

    svc = RetrievalService(make_search_fn(tidx.num_padded_docs, k=5), tidx,
                           batch_queries=4, max_wait_ms=50)
    try:
        results = [f.result(timeout=60) for f in [svc.search(q) for q in tq]]
    finally:
        svc.close()
    assert [ids for ids, _ in results] == [[names[j] for j in row] for row in want_i]
    # totals of 8 + 4 + 4 maxima, each within bf16 round-off of the index
    np.testing.assert_allclose(np.stack([v for _, v in results]), want_v, atol=2e-2)

    # ---- rerank the retrieved candidates with a full-context cross-encoder
    jrcfg = jrerank.RerankConfig(
        flmr=jcfg, cross_encoder=jbert.BertConfig.tiny(num_hidden_layers=1, **_BERT))
    trcfg = trerank.RerankConfig(
        flmr=tcfg, cross_encoder=tbert.BertConfig.tiny(num_hidden_layers=1, **_BERT))
    cand = np.asarray(want_i)[:, :K]  # [B, K] doc rows
    ids = np.concatenate([np.repeat(q_ids, K, axis=0),
                          doc_ids[cand.reshape(-1)][:, : L - L_Q]], axis=1)
    am = np.concatenate([np.repeat(q_am, K, axis=0),
                         doc_am[cand.reshape(-1)][:, : L - L_Q]], axis=1)
    tt = np.concatenate([np.zeros((B * K, L_Q), np.int32),
                         np.ones((B * K, L - L_Q), np.int32)], axis=1)
    jr = jrerank.FullContextRerankModel(jrcfg)
    rinit = jax.jit(jr.init, static_argnames="num_negative_examples")
    rparams = jax.device_get(rinit(jax.random.PRNGKey(1), ids[:K], am[:K], tt[:K],
                                   pix[:1], num_negative_examples=K - 1)["params"])
    want = np.asarray(jmake_rerank(jr, nway=K, chunk_size=6, jit=False)(
        rparams, ids, am, tt, pix))

    tr = trerank.FullContextRerankModel(trcfg, device="cpu")
    tr.load_state_dict(weights.rerank_state_dict(rparams))
    rsvc = RerankService(make_chunked_rerank_fn(tr, nway=K, chunk_size=6), nway=K,
                         max_batch=B, max_wait_ms=50, device="cpu")
    try:
        futs = [rsvc.rerank(ids[b * K:(b + 1) * K], am[b * K:(b + 1) * K],
                            tt[b * K:(b + 1) * K], pix[b]) for b in range(B)]
        got = np.stack([f.result(timeout=60) for f in futs])
    finally:
        rsvc.close()
    assert got.shape == (B, K) and np.isfinite(got).all()
    # fp32 on both sides through 2 + 1 BERT layers and the ViT: 1e-4
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    assert not svc.batcher._worker.is_alive() and not rsvc.batcher._worker.is_alive()
    assert (maxsim_scores.launches, fused_self_attention.launches) == launches


def test_chunked_rerank_chunking_is_invisible():
    """Chunk size changes how rows are grouped, never the logits."""
    cfg = trerank.RerankConfig.tiny()
    tr = trerank.FullContextRerankModel(cfg, device="cpu")
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(rng.integers(1, 900, size=(6, 10)))
    am = torch.ones(6, 10, dtype=torch.long)
    tt = torch.zeros(6, 10, dtype=torch.long)
    pix = torch.as_tensor(rng.normal(size=(2, 3, 32, 32)).astype(np.float32))
    a = make_chunked_rerank_fn(tr, nway=3, chunk_size=6)(ids, am, tt, pix)
    b = make_chunked_rerank_fn(tr, nway=3, chunk_size=2)(ids, am, tt, pix)
    assert a.shape == (2, 3)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
