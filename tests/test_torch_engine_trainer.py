"""The port's triples trainer (``engine/trainer.py``) against the JAX
package's, on the CPU: the batches, the schedule, three training steps from
the same weights (carried by ``models/weights.py::flmr_state_dict``) over
the CE and KL-distillation paths with and without in-batch negatives, and
the id stream of self-initialised runs.

Tolerances:
- schedule values within 1e-7 of lr (Python floats against optax's fp32);
- per-step losses within 1e-5 (relative and absolute): the forward of the
  tiny text-only FLMR in fp32, summed in another order, as in
  ``tests/test_torch_flmr_train.py``;
- final weights by the per-element limits of
  ``tests/test_torch_training.py``, over three steps: Adam moves an element
  by about ``lr * sign(g)`` a step, so an element whose gradient is
  round-off on both sides may move up to ``lr`` a step the other way, and
  every element lies within ``2 * lr`` a step (plus the decay) of JAX's;
  elements whose gradient is large in every step (at least 1e-2 of their
  leaf's largest in JAX's first moved step) agree within 1e-3 of lr a step.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine import trainer as jtrainer  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import flmr as jflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import trainer  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine.data import Collection, Queries  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.training import checkpointing  # noqa: E402

LOSS_TOL = dict(rel=1e-5, abs=1e-5)
STEPS, LR = 3, 1e-3


def fixtures(tmp_path, with_scores, n=8):
    """``tests/test_engine_trainer.py``'s triples: 8 queries, 16 passages."""
    queries = {i: f"question {i}" for i in range(n)}
    collection = [f"passage text {i}" for i in range(16)]
    rng = np.random.default_rng(0)
    rows = []
    for qid in range(n):
        pos, neg = int(rng.integers(0, 16)), int(rng.integers(0, 16))
        rows.append([qid, [pos, 9.0], [neg, 1.0]] if with_scores else [qid, pos, neg])
    path = tmp_path / f"triples_{with_scores}.jsonl"
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path), queries, collection


def config(cls, **kw):
    base = dict(bsize=4, nway=2, maxsteps=STEPS, warmup=1, lr=LR, query_maxlen=8,
                doc_maxlen=12)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("with_scores", [False, True], ids=["pids", "scored"])
def test_lazy_batcher_matches_jax(tmp_path, with_scores):
    path, q, c = fixtures(tmp_path, with_scores)
    got = list(trainer.LazyBatcher(path, Queries(q), Collection(data=c), bsize=3, nway=2))
    want = list(jtrainer.LazyBatcher(path, q, c, bsize=3, nway=2))
    assert len(got) == len(want) == 2
    for (gq, gp, gt), (wq, wp, wt) in zip(got, want):
        assert gq == wq and gp == wp
        assert (gt is None) == (wt is None) == (not with_scores)
        if with_scores:
            np.testing.assert_array_equal(gt, wt)


@pytest.mark.parametrize("warmup", [None, 0, 5])
def test_schedule_matches_optax_join_branch(warmup):
    """The JAX trainer's ``join_schedules`` branch, step by step."""
    maxsteps = 12
    want = optax.join_schedules(
        [optax.linear_schedule(0.0, LR, warmup or 1),
         optax.linear_schedule(LR, 0.0, max(maxsteps - (warmup or 0), 1))],
        [warmup or 1])
    got = trainer.triples_schedule(LR, warmup, maxsteps)
    for step in range(maxsteps + 4):
        assert abs(got(step) - float(want(step))) <= 1e-7 * LR, (warmup, step)
    assert got(0) == 0.0  # even without warmup, the first step runs at lr 0


def _jax_params(cfg, nway):
    """The JAX trainer's own initial parameters (its two warm-up batches)."""
    rng = np.random.default_rng(cfg.seed)
    qi = rng.integers(3, 50, size=(2, cfg.query_maxlen)).astype(np.int32)
    di = rng.integers(3, 50, size=(2 * nway, cfg.doc_maxlen)).astype(np.int32)
    model = jflmr.FLMRModelForRetrieval(jflmr.FLMRConfig.tiny(
        use_vision_encoder=False, query_concat_output_from_vision_encoder=False,
        use_transformer_mapping_network=False))
    return model.init(jax.random.PRNGKey(cfg.seed), qi, np.ones_like(qi), di, np.ones_like(di),
                      use_in_batch_negatives=False, num_negative_examples=nway - 1)["params"]


def _spy_jax_steps(monkeypatch):
    """Each JAX step's (batch, loss), read from the trainer's jitted step."""
    seen, jit = [], jax.jit

    def spy(fn, *a, **k):
        jitted = jit(fn, *a, **k)
        if getattr(fn, "__name__", "") != "step_has_target":
            return jitted

        def step(p, opt_state, batch):
            out = jitted(p, opt_state, batch)
            seen.append(({k: None if v is None else np.asarray(v) for k, v in batch.items()},
                         float(out[2])))
            return out

        return step

    monkeypatch.setattr(jax, "jit", spy)
    return seen


def _spy_port_steps(monkeypatch):
    """Each port step's loss, read where it is backpropagated."""
    seen, apply = [], trainer.apply_update

    def spy(state, loss, guard=True, **kw):
        seen.append(float(loss.detach()))
        return apply(state, loss, guard, **kw)

    monkeypatch.setattr(trainer, "apply_update", spy)
    return seen


@pytest.mark.parametrize("use_ib", [False, True], ids=["no_ib", "ib"])
@pytest.mark.parametrize("with_scores", [False, True], ids=["ce", "kl"])
def test_train_matches_jax(tmp_path, monkeypatch, with_scores, use_ib):
    path, q, c = fixtures(tmp_path, with_scores, n=12)
    jcfg = config(jtrainer.TriplesTrainerConfig, use_ib_negatives=use_ib, distillation_alpha=0.5)
    params0 = jax.device_get(_jax_params(jcfg, 2))
    jax_steps = _spy_jax_steps(monkeypatch)
    want_params, want_ema = jtrainer.train(jcfg, path, q, c, params=params0)
    want_params = weights.flmr_state_dict(jax.device_get(want_params))
    port_losses = _spy_port_steps(monkeypatch)
    got_params, got_ema = trainer.train(
        config(trainer.TriplesTrainerConfig, use_ib_negatives=use_ib, distillation_alpha=0.5),
        path, q, c, params=weights.flmr_state_dict(params0), device="cpu")
    want_losses = [loss for _, loss in jax_steps]
    assert len(port_losses) == len(want_losses) == STEPS
    for g, w in zip(port_losses, want_losses):
        assert g == pytest.approx(w, **LOSS_TOL)
    assert got_ema == pytest.approx(want_ema, **LOSS_TOL)

    # JAX's gradients of the first moved step (step 2; step 1 runs at lr 0)
    batch = jax_steps[1][0]
    jm = jflmr.FLMRModelForRetrieval(jflmr.FLMRConfig.tiny(
        use_vision_encoder=False, query_concat_output_from_vision_encoder=False,
        use_transformer_mapping_network=False))

    def loss(p):
        out = jm.apply({"params": p}, batch["q_ids"], batch["q_mask"], batch["d_ids"],
                       batch["d_mask"], use_in_batch_negatives=use_ib, num_negative_examples=1)
        if with_scores:  # the JAX trainer's KL-distillation
            t = jax.nn.log_softmax(batch["target"] * jcfg.distillation_alpha, axis=-1)
            value = (jax.numpy.exp(t) * (t - jax.nn.log_softmax(out.scores, axis=-1))).sum(-1).mean()
        else:
            value = out.loss
        return value + out.in_batch_negative_loss if use_ib else value

    grads = weights.flmr_state_dict(jax.device_get(jax.grad(loss)(params0)))
    # a leaf whose gradient is 0 in exact arithmetic (a key bias) holds
    # round-off alone: its floor is 1e-3 of the model's largest |g|, as in
    # tests/test_torch_flmr_train.py
    floor = 1e-3 * max(float(g.abs().max()) for g in grads.values())
    before = weights.flmr_state_dict(params0)
    moved = STEPS - 1
    assert set(got_params) == set(want_params)
    for name, w in want_params.items():
        diff = (got_params[name] - w).abs()
        limit = moved * 2 * LR * (1 + trainer.ADAMW_WEIGHT_DECAY * before[name].abs().max())
        assert diff.max() <= limit, name
        g = grads[name].abs()
        sure = g >= 1e-2 * max(float(g.max()), floor)
        assert not sure.any() or diff[sure].max() <= moved * 1e-3 * LR, name
    assert any(not torch.equal(got_params[n], before[n]) for n in before)


def test_self_initialised_runs_draw_the_same_ids(tmp_path, monkeypatch):
    """Without params both trainers draw two warm-up batches first, so they
    feed the same ids (the weights differ: each package draws its own)."""
    path, q, c = fixtures(tmp_path, False)
    cfg = dict(maxsteps=2, query_maxlen=6, doc_maxlen=10)
    jax_steps = _spy_jax_steps(monkeypatch)
    jtrainer.train(config(jtrainer.TriplesTrainerConfig, **cfg), path, q, c)
    seen = []
    model = trainer.default_model(12345, device="cpu")
    forward = model.forward

    def spy(qi, qm, di, dm, **kw):
        seen.append((qi.numpy(), di.numpy()))
        return forward(qi, qm, di, dm, **kw)

    monkeypatch.setattr(model, "forward", spy)
    params, ema = trainer.train(config(trainer.TriplesTrainerConfig, **cfg), path, q, c,
                                model=model, device="cpu")
    assert len(seen) == len(jax_steps) == 2 and np.isfinite(ema)
    for (qi, di), (batch, _) in zip(seen, jax_steps):
        np.testing.assert_array_equal(qi, batch["q_ids"])
        np.testing.assert_array_equal(di, batch["d_ids"])
    assert all(torch.isfinite(p).all() for p in params.values())


def test_train_checkpoints(tmp_path):
    """``tests/test_engine_trainer.py``'s checkpoint case: every step saved,
    and the last checkpoint restores the returned weights."""
    path, q, c = fixtures(tmp_path, False)
    ck = str(tmp_path / "ck")
    params, _ = trainer.train(config(trainer.TriplesTrainerConfig, maxsteps=2,
                                     checkpoint_dir=ck, save_every=1), path, q, c,
                              device="cpu")
    assert os.listdir(ck)
    manager = checkpointing.CheckpointManager(ck)
    restored = manager.restore(manager.resolve(), device="cpu")["params"]
    assert set(restored) == set(params)
    assert all(torch.equal(restored[k], params[k]) for k in params)


def test_mesh_raises(tmp_path):
    path, q, c = fixtures(tmp_path, False)
    with pytest.raises(TypeError):  # a mesh is a parallel.Mesh
        trainer.train(config(trainer.TriplesTrainerConfig), path, q, c, mesh=object(),
                      device="cpu")
