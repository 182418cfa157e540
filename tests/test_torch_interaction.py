"""The port's interaction rerankers (``models/rerankers/interaction.py``)
against the JAX package's: both interaction types with and without attention
fusion over the loss vocabulary, MORES's mixed-dtype flow with bf16 weights,
the fusion invariants, gradients, one train step against optax, and the
executor's input builders against the JAX retriever; the same weights
carried by ``models/weights.py``.

Both sides on the CPU (JAX at matmul precision "highest"). Tolerances: fp32
logits and losses within 1e-5 (relative and absolute), fp32 round-off
through two tiny layers; gradients per parameter within 5e-4 of the leaf's
largest |g| (the negative-sampling loss's gradient at near-equal logits is
a cancelling difference, about 1e-4 of its terms, whose fp32 round-off the
backward keeps at up to ~1e-4 of the result), with a floor of 1e-5 of the
model's largest |g| for leaves whose gradient vanishes or cancels in exact
arithmetic (a head's bias under negative sampling, as the softmax's
gradient sums to 0 over each group; an attention value bias, as the
probabilities sum to 1), which keep the fp32 round-off of their terms;
parameters after one AdamW step
within 1e-6 of the leaf's largest |p|, as in ``tests/test_torch_training.py``;
bf16 logits within one bf16 spacing (2^-7 relative); the retriever's
outputs within 1e-5.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from reranking_multimodal_retrievers_tpu import training as jtraining  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import flmr as jflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu.models.rerankers import interaction as jinter  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch import training  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.executors import (  # noqa: E402
    fusion_inputs, interaction_inputs)
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import flmr as tflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (  # noqa: E402
    InteractionRerankConfig, InteractionRerankModel, MORESSym)
from test_torch_flmr_train import port_config  # noqa: E402

VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = 2.0 ** -7
B, NWAY, LQ, LC, DIM = 2, 3, 6, 10, 16


def _port_config(jcfg):
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["cross_encoder"] = tbert.BertConfig(**dataclasses.asdict(jcfg.cross_encoder))
    return InteractionRerankConfig(**d)


def _batch(seed=0, fusion=False):
    rng = np.random.default_rng(seed)
    batch = dict(
        query_late_interaction=rng.normal(size=(B, LQ, DIM)).astype(np.float32),
        context_late_interaction=rng.normal(size=(B * NWAY, LC, DIM)).astype(np.float32),
        query_mask=np.ones((B, LQ), np.int32),
        context_mask=np.ones((B * NWAY, LC), np.int32))
    batch["query_mask"][1, 4:] = 0
    batch["context_mask"][2, 7:] = 0
    batch["context_mask"][4, 3:] = 0
    if fusion:
        batch["preflmr_scores"] = rng.normal(size=(B * NWAY, LC, LQ)).astype(np.float32)
        batch["fusion_multiplier"] = 1.5
    return batch


def _torch(batch):
    return {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def _pair(jcfg, batch):
    jm = jinter.InteractionRerankModel(jcfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), **batch,
                                    num_negative_examples=NWAY - 1)["params"])
    tm = InteractionRerankModel(_port_config(jcfg), device="cpu")
    tm.load_state_dict(weights.interaction_rerank_state_dict(params))
    return jm, params, tm


def _assert_grads_match(model, jax_grads, rel=5e-4):
    want = {k: v.numpy() for k, v in weights.interaction_rerank_state_dict(jax_grads).items()}
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    floor = 2e-2 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = named[name].grad
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(float(np.abs(w).max()), floor),
                                   err_msg=name)


@pytest.mark.parametrize("loss_fn,pos_weight", [
    ("BCE", 3.0), ("2H_BCE", 2.0), ("negative_sampling", None)])
@pytest.mark.parametrize("fusion", [False, True])
@pytest.mark.parametrize("interaction_type", ["CrossEncoder", "MORES"])
def test_interaction_model_matches_jax(interaction_type, fusion, loss_fn, pos_weight):
    """Logits, loss and every parameter's gradient in fp32."""
    batch = _batch(fusion=fusion)
    jcfg = jinter.InteractionRerankConfig.tiny(interaction_type=interaction_type,
                                               loss_fn=loss_fn, pos_weight=pos_weight)
    jm, params, tm = _pair(jcfg, batch)
    apply = lambda p: jm.apply({"params": p}, **batch, num_negative_examples=NWAY - 1)  # noqa
    want = apply(params)
    jgrads = jax.grad(lambda p: apply(p).loss)(params)
    out = tm(**_torch(batch), num_negative_examples=NWAY - 1)
    out.loss.backward()
    assert out.logits.shape == np.asarray(want.logits).shape
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(want.logits), **VALUE_TOL)
    assert float(out.loss.detach()) == pytest.approx(float(want.loss), rel=1e-5, abs=1e-5)
    _assert_grads_match(tm, jgrads)


def _bf16(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)


def test_mores_bf16_keeps_the_mixed_dtype_flow():
    """bf16 weights and inputs: the queries are mapped in bf16, the docs in
    fp32 (JAX ``interaction.py:141-142``), so each cross-attention's keys
    and values come from fp32 docs. Logits within one bf16 spacing of the
    JAX package's."""
    batch = _batch(seed=3)
    jcfg = jinter.InteractionRerankConfig.tiny(
        interaction_type="MORES",
        cross_encoder=jinter.BertConfig.tiny(max_position_embeddings=512,
                                             attention_scores_bf16=True))
    jm, params, _ = _pair(jcfg, batch)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), params)
    jbatch = {k: (jnp.asarray(v, jnp.bfloat16) if k.endswith("interaction") else v)
              for k, v in batch.items()}
    want = np.asarray(jm.apply({"params": _bf16(params)}, **jbatch,
                               num_negative_examples=NWAY - 1).logits, np.float32)
    tm = InteractionRerankModel(_port_config(jcfg), device="cpu")
    tm.load_state_dict(weights.interaction_rerank_state_dict(params))
    tm = tm.to(torch.bfloat16)
    seen = []
    for layer in tm.reranker.layers:
        layer.crossattention.register_forward_pre_hook(
            lambda m, args, kw: seen.append((args[0].dtype, kw["kv_states"].dtype)),
            with_kwargs=True)
    tb = {k: (torch.tensor(np.asarray(v, np.float32)).bfloat16() if k.endswith("interaction")
              else torch.tensor(v)) for k, v in jbatch.items()}
    with torch.no_grad():
        got = tm(**tb, num_negative_examples=NWAY - 1).logits
    assert seen == [(torch.bfloat16, torch.float32)] * jcfg.cross_encoder.num_hidden_layers
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL, atol=BF16_TOL / 4)


@pytest.mark.parametrize("interaction_type", ["CrossEncoder", "MORES"])
def test_fusion_invariants(interaction_type):
    """``tests/test_rerankers.py::test_interaction_rerank_fusion`` on the
    port: a zero adjacency is a no-op and fusion moves the logits; in MORES
    a -1e9 query-to-doc column equals masking that doc token."""
    batch = _torch(_batch(seed=1, fusion=True))
    scores = batch.pop("preflmr_scores")
    batch.pop("fusion_multiplier")
    cfg = InteractionRerankConfig.tiny(interaction_type=interaction_type)
    model = InteractionRerankModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))

    def run(**kw):
        with torch.no_grad():
            return model(**{**batch, **kw}, num_negative_examples=NWAY - 1).logits

    base = run()
    torch.testing.assert_close(run(preflmr_scores=scores, fusion_multiplier=0.0), base,
                               rtol=0, atol=1e-6)
    assert not torch.allclose(run(preflmr_scores=scores), base)
    if interaction_type == "MORES":
        rng = np.random.default_rng(2)
        H = cfg.cross_encoder.hidden_size
        rows = B * NWAY
        qry = torch.tensor(rng.normal(size=(rows, LQ, H)).astype(np.float32))
        doc = torch.tensor(rng.normal(size=(rows, LC, H)).astype(np.float32))
        ones_q, ones_d = torch.ones(rows, LQ), torch.ones(rows, LC, dtype=torch.int32)
        adj = torch.zeros(rows, LQ + LC, LQ + LC)
        adj[:, :LQ, LQ + 3] = -1e9
        masked = ones_d.clone()
        masked[:, 3] = 0
        sym = model.reranker
        assert isinstance(sym, MORESSym)
        with torch.no_grad():
            via_adj = sym(qry, doc, ones_q, ones_d, attention_adj=adj)[0]
            via_mask = sym(qry, doc, ones_q, masked)[0]
        torch.testing.assert_close(via_adj, via_mask, rtol=0, atol=1e-5)


def test_mores_train_step_matches_optax():
    """One ``make_rerank_train_step`` step of MORES (negative_sampling, AdamW
    at lr 1e-4, as ``configs/evqa_rerank_interaction.json``) against the
    JAX executor's step (``reranker_executor.py:508-536``) with optax: the
    loss, the gradients the step took, and every parameter after the update.
    Adam's first step moves an element by ``-lr * g / (|g| + eps)``, which
    at ``|g| ~ eps`` turns a last-bit gradient difference into a visible
    one: each update may differ by what the two gradients imply, plus
    1e-6 of the leaf's largest |p|."""
    batch = _batch(seed=4)
    jcfg = jinter.InteractionRerankConfig.tiny(interaction_type="MORES",
                                               loss_fn="negative_sampling")
    jm, params, tm = _pair(jcfg, batch)
    lr, eps = 1e-4, 1e-8
    kw = dict(optimizer_name="AdamW", lr=lr)
    tx, _ = jtraining.make_optimizer(params, **kw)

    def loss_fn(p):
        return jm.apply({"params": p}, **batch, num_negative_examples=NWAY - 1).loss

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    want = weights.interaction_rerank_state_dict(
        jax.device_get(optax.apply_updates(params, updates)))
    want_g = weights.interaction_rerank_state_dict(jax.device_get(jgrads))
    before = {k: v.clone() for k, v in tm.state_dict().items()}

    opt, sched, _ = training.make_optimizer(tm, **kw)
    step = training.make_rerank_train_step(tm, opt, sched, num_negative_examples=NWAY - 1)
    grads = {}
    for n, p in tm.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
    state, metrics = step(training.TrainState.create(tm, opt, sched), _torch(batch))
    assert state.step == 1
    assert float(metrics["loss"]) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)
    for n, p in tm.named_parameters():  # a leaf the loss does not reach: no hook, zero
        p.grad = grads.setdefault(n, torch.zeros_like(p))
    _assert_grads_match(tm, jgrads)

    def adam(g):
        return -lr * g / (g.abs() + eps)

    for name, p in tm.state_dict().items():
        w, b = want[name], before[name]
        allowed = (adam(grads[name]) - adam(want_g[name])).abs()
        excess = ((p - b) - (w - b)).abs() - allowed
        assert excess.max().item() <= 1e-6 * max(1.0, w.abs().max().item()), name


@pytest.fixture(scope="module")
def retriever_pair():
    jcfg = jflmr.FLMRConfig.tiny()
    rng = np.random.default_rng(5)
    nq, nway, lq, lc = 2, 2, 8, 12
    batch = dict(
        query_input_ids=rng.integers(10, 1000, size=(nq, lq)).astype(np.int32),
        query_attention_mask=np.ones((nq, lq), np.int32),
        query_pixel_values=rng.normal(size=(nq, 3, 32, 32)).astype(np.float32),
        context_input_ids=rng.integers(10, 1000, size=(nq * nway, lc)).astype(np.int32),
        context_attention_mask=np.ones((nq * nway, lc), np.int32))
    batch["query_attention_mask"][1, 6:] = 0
    batch["query_input_ids"][1, 6:] = 0
    batch["context_attention_mask"][1, 9:] = 0
    batch["context_input_ids"][1, 9:] = 0
    batch["context_input_ids"][0, 4] = 5  # a punctuation id: masked in the doc
    jm = jflmr.FLMRModelForRetrieval(jcfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), **batch,
                                    num_negative_examples=nway - 1)["params"])
    tm = tflmr.FLMRModelForRetrieval(port_config(jcfg), device="cpu")
    tm.load_state_dict(weights.flmr_state_dict(params))
    tb = {k: torch.tensor(v).long() if v.dtype.kind in "iu" else torch.tensor(v)
          for k, v in batch.items()}
    return jm, params, tm, batch, tb, nway


def test_interaction_inputs_match_the_jax_retriever(retriever_pair):
    jm, params, tm, batch, tb, _ = retriever_pair
    qout = jm.apply({"params": params}, batch["query_input_ids"], batch["query_attention_mask"],
                    pixel_values=batch["query_pixel_values"], method=type(jm).query)
    dout = jm.apply({"params": params}, batch["context_input_ids"],
                    batch["context_attention_mask"], method=type(jm).doc)
    got = interaction_inputs(tm, tb["query_input_ids"], tb["query_attention_mask"],
                             tb["context_input_ids"], tb["context_attention_mask"],
                             query_pixel_values=tb["query_pixel_values"])
    assert not any(v.requires_grad for v in got.values())
    np.testing.assert_allclose(got["query_late_interaction"].numpy(),
                               np.asarray(qout.late_interaction_output), **VALUE_TOL)
    np.testing.assert_allclose(got["context_late_interaction"].numpy(),
                               np.asarray(dout.late_interaction_output), **VALUE_TOL)
    np.testing.assert_array_equal(got["query_mask"].numpy(), np.asarray(qout.query_mask))
    assert got["context_mask"].dtype == torch.int32
    np.testing.assert_array_equal(got["context_mask"].numpy(),
                                  np.asarray(dout.context_mask).astype(np.int32))


def test_fusion_inputs_match_the_jax_retriever(retriever_pair):
    jm, params, tm, batch, tb, nway = retriever_pair
    want = jm.apply({"params": params}, **batch, num_negative_examples=nway - 1,
                    use_in_batch_negatives=False)
    got = fusion_inputs(tm, tb["query_input_ids"], tb["query_attention_mask"],
                        tb["context_input_ids"], tb["context_attention_mask"],
                        num_negative_examples=nway - 1,
                        query_pixel_values=tb["query_pixel_values"], fusion_multiplier=2.0)
    assert got["fusion_multiplier"] == 2.0 and not got["preflmr_scores"].requires_grad
    np.testing.assert_allclose(got["preflmr_scores"].numpy(), np.asarray(want.scores_raw),
                               **VALUE_TOL)
