"""The port's ``CheckpointManager`` (``training/checkpointing.py``) against
the JAX package's: the same ``index.json`` after the same saves, top-k
pruning on a monitored metric, unscored checkpoints kept by recency,
``best`` and ``last`` kept, resolution explicit path > best > last, the
``strict=False`` partial restore, and a train state that resumes bitwise.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.training import checkpointing as jckpt  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch import training  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.training import checkpointing as ckpt  # noqa: E402
from test_torch_flmr_train import flagship_pair, torch_batch  # noqa: E402

# (step, metrics) saves: recall improves, dips, improves; the last two lack it
SAVES = [(1, {"recall_at_5": 0.2, "loss": 1.0}), (2, {"recall_at_5": 0.5, "loss": 0.8}),
         (3, {"recall_at_5": 0.3, "loss": 0.7}), (4, {"recall_at_5": 0.6, "loss": 0.6}),
         (5, {"loss": 0.5}), (6, {"loss": 0.4})]


def _index(path):
    with open(os.path.join(path, "index.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("monitor,mode,top_k", [("recall_at_5", "max", 2),
                                               ("loss", "min", 1),
                                               ("recall_at_5", "max", -1),
                                               (None, "max", 1)])
def test_index_and_pruning_match_jax(tmp_path, monitor, mode, top_k):
    state = {"w": np.arange(4, dtype=np.float32)}
    managers = {}
    for side, module in (("jax", jckpt), ("port", ckpt)):
        mgr = module.CheckpointManager(str(tmp_path / side), monitor=monitor, mode=mode,
                                       save_top_k=top_k)
        for step, metrics in SAVES:
            mgr.save(state, step=step, metrics=metrics)
        managers[side] = mgr
    want, got = _index(tmp_path / "jax"), _index(tmp_path / "port")
    assert got == want
    kept = {c["name"] for c in got["checkpoints"]}
    assert kept == {n for n in os.listdir(tmp_path / "port") if n != "index.json"}
    assert got["last"] == "step_6" and got["last"] in kept
    if got["best"]:
        assert got["best"]["name"] in kept
    for explicit in (None, "/some/where"):
        assert (managers["port"].resolve(explicit).replace(str(tmp_path / "port"), "")
                == managers["jax"].resolve(explicit).replace(str(tmp_path / "jax"), ""))


def test_prune_keeps_unscored_by_recency(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "ckpts"), monitor="recall_at_5", mode="max",
                                 save_top_k=2)
    for step in (1, 2, 3):
        mgr.save({"w": np.zeros(2, np.float32)}, step=step, metrics={"loss": 1.0 / step})
    names = {c["name"] for c in mgr._index["checkpoints"]}
    assert names == {"step_2", "step_3"}
    for n in names:
        assert os.path.isdir(tmp_path / "ckpts" / n)


def test_resolve_order_and_resave(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), monitor="acc", save_top_k=3)
    assert mgr.resolve() is None
    mgr.save({"w": np.zeros(1, np.float32)}, step=1)
    assert mgr.resolve() == os.path.join(str(tmp_path), "step_1")  # last
    mgr.save({"w": np.ones(1, np.float32)}, step=2, metrics={"acc": 0.9})
    mgr.save({"w": np.ones(1, np.float32)}, step=3, metrics={"acc": 0.1})
    assert mgr.resolve() == os.path.join(str(tmp_path), "step_2")  # best before last
    assert mgr.resolve("/explicit") == "/explicit"
    mgr.save({"w": np.full(1, 7, np.float32)}, step=3, metrics={"acc": 0.2})  # re-save
    assert [c["name"] for c in mgr._index["checkpoints"]].count("step_3") == 1
    again = ckpt.CheckpointManager(str(tmp_path), monitor="acc", save_top_k=3)
    assert again.resolve() == mgr.resolve()  # the index is read back
    got = ckpt.CheckpointManager.restore(os.path.join(str(tmp_path), "step_3"), device="cpu")
    assert torch.equal(got["w"], torch.full((1,), 7.0))


def test_partial_restore_keeps_the_targets_other_entries(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    path = mgr.save({"a": {"x": np.ones(2, np.float32)}, "b": np.zeros(1, np.float32)}, step=1)
    target = {"a": {"x": torch.zeros(2), "y": torch.full((1,), 5.0)}, "c": torch.ones(3)}
    got = ckpt.CheckpointManager.restore(path, target, device="cpu")
    assert torch.equal(got["a"]["x"], torch.ones(2))  # from the checkpoint
    assert torch.equal(got["a"]["y"], target["a"]["y"]) and torch.equal(got["c"], target["c"])
    assert "b" not in got


def _state(tm, **kw):
    opt, sched, _ = training.make_optimizer(tm, lr=1e-3, scheduler="linear", num_warmup_steps=1,
                                            num_training_steps=10, weight_decay=0.1,
                                            frozen_patterns=("vision_encoder",), **kw)
    return training.TrainState.create(tm, opt, sched)


def test_train_state_round_trip_resumes_bitwise(tmp_path):
    """Save at step 2, restore into a fresh model and optimizer; the next
    step from each gives bitwise equal parameters, moments and lr."""
    _, _, tm, batch = flagship_pair()
    state = _state(tm)
    step = training.make_train_step(tm, state.optimizer, state.scheduler)
    b = torch_batch(batch)
    for _ in range(2):
        state, _ = step(state, b)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    path = mgr.save(state, step=state.step, metrics={"loss": 1.0})

    _, _, fresh, _ = flagship_pair()
    with torch.no_grad():
        for p in fresh.parameters():
            p.mul_(0.5)  # unlike the saved weights until restored
    restored = ckpt.CheckpointManager.restore(path, _state(fresh))
    assert restored.step == 2 and restored.scheduler.last_epoch == state.scheduler.last_epoch
    step2 = training.make_train_step(fresh, restored.optimizer, restored.scheduler)
    state, m1 = step(state, b)
    restored, m2 = step2(restored, b)
    assert float(m1["total_loss"]) == float(m2["total_loss"])
    for (n, p), q in zip(tm.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), n
    for s1, s2 in zip(state.optimizer.state.values(), restored.optimizer.state.values()):
        for k in s1:
            assert torch.equal(s1[k], s2[k]), k
    assert state.scheduler.get_last_lr() == restored.scheduler.get_last_lr()


def test_pack_unpack_opt_state():
    _, _, tm, batch = flagship_pair()
    state = _state(tm)
    step = training.make_train_step(tm, state.optimizer, state.scheduler)
    state, _ = step(state, torch_batch(batch))
    packed = ckpt.pack_opt_state(state.optimizer)
    fresh = _state(tm).optimizer
    ckpt.unpack_opt_state(fresh, packed)
    for s1, s2 in zip(state.optimizer.state.values(), fresh.state.values()):
        for k in s1:
            assert torch.equal(s1[k], s2[k]), k
