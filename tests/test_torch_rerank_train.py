"""The port's monoPreFLMR reranker training pieces against the JAX
package's: ``rerank_loss``'s gradients over the loss vocabulary,
``fusion_attention_adj``, the spliced ``RerankModel`` (forward, loss with
``replicate_reference_loss_bug`` on and off, attention fusion) and
``FullContextRerankModel``'s loss and gradients, on the tiny configs and
batches of ``tests/test_rerankers.py``, the same weights carried by
``models/weights.py``; and the reranker's train step.

Both sides in fp32 on the CPU (JAX at matmul precision "highest").
Tolerances: losses and logits within 1e-5 (relative and absolute), fp32
round-off through the tiny encoders; loss gradients with respect to the
logits within 1e-6 (a sigmoid or softmax of the same fp32 values); model
gradients per parameter within 1e-4 of its largest |g|, with a floor of
1e-7 of the model's largest |g| for leaves that are 0 in exact arithmetic
(as in ``tests/test_torch_flmr_train.py``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.models.rerankers import (  # noqa: E402
    FullContextRerankModel as JFullContext, RerankConfig as JRerankConfig,
    RerankModel as JRerankModel)
from reranking_multimodal_retrievers_tpu.models.rerankers import losses as jlosses  # noqa: E402
from reranking_multimodal_retrievers_tpu.models.rerankers.cross_encoder import (  # noqa: E402
    fusion_attention_adj as jfusion)
from reranking_multimodal_retrievers_tpu_torch import training  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (  # noqa: E402
    FullContextRerankModel, RerankConfig, RerankModel, fusion_attention_adj)
from reranking_multimodal_retrievers_tpu_torch.models.rerankers import losses  # noqa: E402
from test_torch_flmr_train import port_config  # noqa: E402

VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


@pytest.mark.parametrize("loss_fn,pos_weight,given", [
    ("BCE", None, False), ("BCE", 3.0, False), ("BCE", None, True),
    ("2H_BCE", None, False), ("2H_BCE", 2.0, False), ("2H_BCE", 2.0, True),
    ("negative_sampling", None, False), ("negative_sampling", None, True)])
def test_rerank_loss_and_grad_match_jax(loss_fn, pos_weight, given):
    rng = np.random.default_rng(0)
    B, n_neg = 3, 2
    rows = B * (n_neg + 1)
    l1 = rng.normal(size=(rows, 1)).astype(np.float32)
    l2 = rng.normal(size=(rows, 1)).astype(np.float32)
    labels = None
    if given:  # the positive of each group somewhere other than first
        labels = np.zeros(rows, np.float32)
        labels[[1, 3, 8]] = 1.0

    def jloss(a, b):
        logits, lbl = jlosses.prepare_logits_labels(loss_fn, a, b, B, n_neg, labels)
        return jlosses.rerank_loss(loss_fn, logits, lbl, pos_weight)

    want = jloss(jnp.asarray(l1), jnp.asarray(l2))
    g1, g2 = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(l1), jnp.asarray(l2))
    a, b = _t(l1, True), _t(l2, True)
    logits, lbl = losses.prepare_logits_labels(
        loss_fn, a, b, B, n_neg, None if labels is None else torch.tensor(labels))
    got = losses.rerank_loss(loss_fn, logits, lbl, pos_weight)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6, abs=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy() if b.grad is not None else np.zeros_like(l2),
                               np.asarray(g2), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("q_ret", [3, 2])
def test_fusion_attention_adj_matches_jax(q_ret):
    rng = np.random.default_rng(1)
    B, Lc, Lq = 2, 5, 3
    scores = rng.normal(size=(B, Lc, q_ret)).astype(np.float32)
    want = jfusion(jnp.asarray(scores), Lq, Lc, fusion_multiplier=2.0)
    got = fusion_attention_adj(_t(scores), Lq, Lc, fusion_multiplier=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        fusion_attention_adj(_t(scores), q_ret - 1, Lc)


def _port_rerank_config(jcfg):
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["flmr"] = port_config(jcfg.flmr)
    d["cross_encoder"] = tbert.BertConfig(**dataclasses.asdict(jcfg.cross_encoder))
    return RerankConfig(**d)


def _spliced_batch():
    rng = np.random.default_rng(0)
    B, nway, Lq, Lc = 2, 2, 8, 32
    return dict(
        query_input_ids=rng.integers(10, 1000, size=(B, Lq)).astype(np.int32),
        query_attention_mask=np.ones((B, Lq), np.int32),
        query_pixel_values=rng.normal(size=(B, 3, 32, 32)).astype(np.float32),
        context_input_ids=rng.integers(10, 1000, size=(B * nway, Lc)).astype(np.int32),
        context_attention_mask=np.ones((B * nway, Lc), np.int32),
    ), nway - 1


def _torch_batch(batch):
    return {k: torch.tensor(v).long() if v.dtype.kind in "iu" else torch.tensor(v)
            for k, v in batch.items()}


def _assert_grads_match(model, jax_grads, rel=1e-4):
    want = {k: v.numpy() for k, v in weights.rerank_state_dict(jax_grads).items()}
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = named[name].grad
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(float(np.abs(w).max()), floor),
                                   err_msg=name)


@pytest.mark.parametrize("bug", [False, True])
@pytest.mark.parametrize("fusion", [False, True])
def test_spliced_rerank_model_matches_jax(bug, fusion):
    batch, n_neg = _spliced_batch()
    jcfg = JRerankConfig.tiny(replicate_reference_loss_bug=bug)
    extra = {}
    if fusion:  # the retriever's token scores: [rows, Lc, Lq + image rows]
        vc = jcfg.flmr.vision_config
        img_rows = jcfg.flmr.mapping_network_prefix_length + (vc.image_size // vc.patch_size) ** 2
        rng = np.random.default_rng(3)
        extra = dict(preflmr_scores=rng.normal(size=(4, 32, 8 + img_rows)).astype(np.float32),
                     fusion_multiplier=1.5)
    jm = JRerankModel(jcfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), **batch,
                                    num_negative_examples=n_neg, **extra)["params"])
    apply = lambda p: jm.apply({"params": p}, **batch, num_negative_examples=n_neg,  # noqa: E731
                               **extra)
    want = apply(params)
    jgrads = jax.grad(lambda p: apply(p).loss)(params)

    tm = RerankModel(_port_rerank_config(jcfg), device="cpu")
    tm.load_state_dict(weights.rerank_state_dict(params))
    textra = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in extra.items()}
    out = tm(**_torch_batch(batch), num_negative_examples=n_neg, **textra)
    out.loss.backward()
    assert out.logits.shape == (4, 1)
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(want.logits), **VALUE_TOL)
    assert float(out.loss.detach()) == pytest.approx(float(want.loss), **{"rel": 1e-5, "abs": 1e-5})
    _assert_grads_match(tm, jgrads)


@pytest.mark.parametrize("text_only", [False, True])
def test_full_context_rerank_loss_and_grads_match_jax(text_only):
    rng = np.random.default_rng(0)
    B, nway, L = 2, 2, 40
    batch = dict(
        input_ids=rng.integers(10, 1000, size=(B * nway, L)).astype(np.int32),
        attention_mask=np.ones((B * nway, L), np.int32),
        token_type_ids=np.repeat([[0] * 16 + [1] * 24], B * nway, axis=0).astype(np.int32),
        query_pixel_values=rng.normal(size=(B, 3, 32, 32)).astype(np.float32))
    batch["attention_mask"][1, 30:] = 0
    jcfg = JRerankConfig.tiny(loss_fn="2H_BCE", pos_weight=2.0)
    jm = JFullContext(jcfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), **batch,
                                    num_negative_examples=nway - 1)["params"])
    if text_only:
        batch["query_pixel_values"] = None
    apply = lambda p: jm.apply({"params": p}, **batch, num_negative_examples=nway - 1)  # noqa
    want = apply(params)
    jgrads = jax.grad(lambda p: apply(p).loss)(params)
    tm = FullContextRerankModel(_port_rerank_config(jcfg), device="cpu")
    tm.load_state_dict(weights.rerank_state_dict(params))
    tb = {k: None if v is None else torch.tensor(v) for k, v in batch.items()}
    for k in ("input_ids", "attention_mask", "token_type_ids"):
        tb[k] = tb[k].long()
    out = tm(**tb, num_negative_examples=nway - 1)
    out.loss.backward()
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(want.logits), **VALUE_TOL)
    assert float(out.loss.detach()) == pytest.approx(float(want.loss), rel=1e-5, abs=1e-5)
    _assert_grads_match(tm, jgrads)


def test_rerank_train_step_trains_and_keeps_frozen_leaves():
    """The reranker's step (JAX ``reranker_executor.py:508-536``): BCE over
    (1 + 2) candidates, AdamW at 1e-4, the vision encoder frozen. The loss
    falls on a fixed batch and frozen leaves stay bitwise."""
    rng = np.random.default_rng(0)
    B, nway, L = 2, 3, 40
    cfg = RerankConfig.tiny()
    model = FullContextRerankModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = dict(
        input_ids=torch.tensor(rng.integers(10, 1000, size=(B * nway, L))),
        attention_mask=torch.ones(B * nway, L, dtype=torch.long),
        token_type_ids=torch.tensor(np.repeat([[0] * 16 + [1] * 24], B * nway, axis=0)),
        query_pixel_values=torch.tensor(rng.normal(size=(B, 3, 32, 32)).astype(np.float32)))
    frozen = {k: v.clone() for k, v in model.state_dict().items() if "vision_encoder" in k}
    opt, sched, labels = training.make_optimizer(model, lr=1e-4,
                                                 frozen_patterns=("vision_encoder",))
    assert any(v == "frozen" for v in labels.values())
    step = training.make_rerank_train_step(model, opt, sched, num_negative_examples=nway - 1)
    state = training.TrainState.create(model, opt, sched)
    seen = []
    for _ in range(5):
        state, metrics = step(state, batch)
        seen.append(float(metrics["loss"]))
    assert state.step == 5 and seen[-1] < seen[0], seen
    for k, v in frozen.items():
        assert torch.equal(model.state_dict()[k], v), k
