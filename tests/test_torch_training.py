"""The port's training layer (``training/optimization.py``,
``training/train_state.py``) against the JAX package's: schedules, parameter
labels, the optimizer on fixed gradients, one FLMR train step, and the NaN
guard.

Tolerances, each stated where it is used: schedules 1e-7 (Python floats
against optax's fp32); the optimizer on the same fixed gradients 1e-6
relative (the same AdamW arithmetic, fp32 round-off in another order, against the leaf's scale); one
model step looser, as derived at :func:`test_one_train_step_matches_jax`.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
from torch import nn  # noqa: E402

from reranking_multimodal_retrievers_tpu import training as jtraining  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch import training  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.training import optimization  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.training import train_state  # noqa: E402
from test_torch_flmr_train import flagship_pair, torch_batch  # noqa: E402

FROZEN, GROUP = ("vision_encoder",), ("vision_projection", "transformer_mapping")


@pytest.mark.parametrize("warmup", [0, 10])
@pytest.mark.parametrize("kind", ["linear", "cosine", None])
def test_schedule_matches_optax(kind, warmup):
    kw = dict(num_warmup_steps=warmup, num_training_steps=30)
    want = jtraining.make_schedule(kind, 3e-4, **kw)
    got = training.make_schedule(kind, 3e-4, **kw)
    for step in range(41):
        assert abs(got(step) - float(want(step))) <= 1e-7 * 3e-4, (kind, warmup, step)
    if warmup == 0:
        assert got(0) == pytest.approx(3e-4)  # no warmup: the full lr at step 0


def test_label_params_by_name():
    _, params, tm, _ = flagship_pair()
    labels = training.label_params(tm, GROUP, FROZEN)
    jl = jtraining.label_params(params, GROUP, FROZEN)
    assert set(labels) == set(weights.flmr_state_dict(params))
    jflat = {"/".join(str(p.key) for p in path): lab
             for path, lab in jax.tree_util.tree_leaves_with_path(jl)}
    for lab in ("frozen", "mapping", "main"):  # the same number of leaves each
        assert (sum(v == lab for v in labels.values())
                == sum(v == lab for v in jflat.values())), lab
    assert all(v == "frozen" for k, v in labels.items() if "vision_encoder" in k)
    assert labels["transformer_mapping_output_linear.weight"] == "mapping"


class _Tree(nn.Module):
    """Four leaves named as the label patterns see them: a main, a frozen and
    a mapping weight, and a main bias."""

    def __init__(self, values):
        super().__init__()
        self.enc = nn.ParameterDict({"w": nn.Parameter(torch.tensor(values["enc"]["w"]))})
        self.vision_encoder = nn.ParameterDict(
            {"w": nn.Parameter(torch.tensor(values["vision_encoder"]["w"]))})
        self.vision_projection = nn.ParameterDict(
            {"w": nn.Parameter(torch.tensor(values["vision_projection"]["w"]))})
        self.head = nn.ParameterDict({"b": nn.Parameter(torch.tensor(values["head"]["b"]))})


@pytest.mark.parametrize("name", ["AdamW", "Adam"])
def test_optimizer_on_fixed_grads_matches_optax(name):
    """Two groups, a frozen leaf, weight decay 0.1, a warmup-linear schedule
    and a global-norm clip at 1.0 whose norm counts the frozen leaf: 5 steps
    fed the same gradients (some above the clip, some below) on both sides.
    Parameters within 1e-6 of their leaf's largest |p|: the same AdamW
    arithmetic in fp32, rounded in another order, which leaves each step a
    last-bit difference (1.2e-7 at |p| ~ 1) that five steps add up."""
    rng = np.random.default_rng(0)
    shapes = {"enc": {"w": (6, 5)}, "vision_encoder": {"w": (4,)},
              "vision_projection": {"w": (3, 2)}, "head": {"b": (5,)}}
    params = {m: {k: rng.normal(size=s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    kw = dict(optimizer_name=name, lr=1e-2, mapping_network_lr=3e-2, scheduler="linear",
              num_warmup_steps=2, num_training_steps=10, weight_decay=0.1,
              group_patterns=("vision_projection",), frozen_patterns=FROZEN, grad_clip=1.0)
    tx, _ = jtraining.make_optimizer(params, **kw)
    jp, js = params, tx.init(params)
    model = _Tree(params)
    opt, sched, labels = training.make_optimizer(model, **kw)
    assert labels == {"enc.w": "main", "vision_encoder.w": "frozen",
                      "vision_projection.w": "mapping", "head.b": "main"}
    for step in range(5):
        scale = 2.0 if step % 2 else 0.1  # norms of about 4.5 and 0.2 about the clip
        grads = {m: {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in d.items()}
                 for m, d in shapes.items()}
        updates, js = tx.update(grads, js, jp)
        jp = optax.apply_updates(jp, updates)
        for m, d in grads.items():
            for k, g in d.items():
                getattr(model, m)[k].grad = torch.tensor(g)
        opt.step()
        sched.step()
    for m, d in jp.items():
        for k, want in d.items():
            got = getattr(model, m)[k].detach().numpy()
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=1e-6 * float(np.abs(want).max()),
                                       err_msg=f"{m}.{k}")
    np.testing.assert_array_equal(model.vision_encoder["w"].detach().numpy(),
                                  params["vision_encoder"]["w"])


@pytest.mark.parametrize("two_groups", [False, True])
def test_adafactor_on_fixed_grads_matches_optax(two_groups):
    """``make_optimizer(..., "Adafactor")`` against the JAX package's
    ``optax.adafactor(schedule)`` on the same fixed gradients for 6 steps:
    a [256, 192] matrix (factored: both axes >= 128), a [64, 32] matrix and
    a vector (full second moments), a 0-d scalar that starts at 0 (its
    block RMS floored at 1e-3), a frozen leaf, and one or two lr groups
    under a warmup-linear schedule. Parameters within 1e-6 of their leaf's
    largest |p|: optax's fp32 arithmetic in the same order, each step
    leaving last-bit differences (reductions summed in another order)."""
    rng = np.random.default_rng(1)
    shapes = {"enc": {"w": (256, 192)}, "vision_encoder": {"w": (4,)},
              "vision_projection": {"w": (64, 32)}, "head": {"b": (5,), "s": ()}}
    params = {m: {k: np.asarray(rng.normal(size=s), np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    params["head"]["s"] = np.zeros((), np.float32)
    kw = dict(optimizer_name="Adafactor", lr=1e-2, scheduler="linear", num_warmup_steps=2,
              num_training_steps=10, frozen_patterns=FROZEN, grad_clip=None)
    if two_groups:
        kw.update(mapping_network_lr=3e-2, group_patterns=("vision_projection",))
    else:
        kw.update(group_patterns=())
    tx, _ = jtraining.make_optimizer(params, **kw)
    jp, js = params, tx.init(params)
    model = _Tree({m: {k: v for k, v in d.items() if k != "s"} for m, d in params.items()})
    model.head["s"] = nn.Parameter(torch.tensor(params["head"]["s"]))
    opt, sched, labels = training.make_optimizer(model, **kw)
    assert isinstance(opt, optimization.Adafactor)
    assert labels["vision_projection.w"] == ("mapping" if two_groups else "main")
    assert optimization.factored_dims((256, 192)) == (1, 0)
    assert optimization.factored_dims((64, 32)) is None
    for step in range(6):
        scale = 3.0 if step % 2 else 0.01  # updates above and below the clip
        grads = {m: {k: np.asarray(scale * rng.normal(size=s), np.float32)
                     for k, s in d.items()} for m, d in shapes.items()}
        updates, js = tx.update(grads, js, jp)
        jp = optax.apply_updates(jp, updates)
        for m, d in grads.items():
            for k, g in d.items():
                getattr(model, m)[k].grad = torch.tensor(g)
        opt.step()
        sched.step()
    for m, d in jp.items():
        for k, want in d.items():
            want = np.asarray(want)
            got = getattr(model, m)[k].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * float(np.abs(want).max()),
                                       err_msg=f"{m}.{k}")
    assert float(model.head["s"].detach()) != 0.0
    np.testing.assert_array_equal(model.vision_encoder["w"].detach().numpy(),
                                  params["vision_encoder"]["w"])


def test_unported_options_raise():
    model = _Tree({m: {k: np.zeros(2, np.float32)} for m, k in
                   (("enc", "w"), ("vision_encoder", "w"), ("vision_projection", "w"),
                    ("head", "b"))})
    with pytest.raises(ValueError):
        training.make_optimizer(model, optimizer_name="SGD")
    opt, sched, _ = training.make_optimizer(model)
    # a mesh is a parallel.Mesh, and tensor parallelism needs one
    with pytest.raises(TypeError):
        training.make_train_step(model, opt, sched, mesh=object())
    with pytest.raises(ValueError):
        training.make_train_step(model, opt, sched, tensor_parallel=True)


def _jax_step(jm, params, batch, kw, loss_key="ib_loss"):
    tx, _ = jtraining.make_optimizer(params, **kw)
    step = jtraining.make_train_step(lambda p, **k: jm.apply({"params": p}, **k), tx,
                                     loss_key=loss_key)
    state, metrics = step(jtraining.TrainState.create(params, tx),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.device_get(state.params), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("loss_key", ["ib_loss", "sum"])
def test_one_train_step_matches_jax(loss_key):
    """One AdamW step of the flagship FLMR from the same weights on the same
    batch (two groups, frozen vision tower, weight decay 0.1, clip 1.0).

    The metrics agree within 1e-5, as the forward does. The parameters
    cannot agree as tightly everywhere: Adam's first step moves an element
    by ``lr * g / (|g| + 1e-8)``, about ``lr * sign(g)``, so an element whose
    gradient is round-off on both sides (|g| far below its leaf's largest)
    may move by up to ``lr`` in opposite directions. So: elements whose JAX
    gradient is at least 1e-2 of their leaf's largest (there the two
    gradients agree to 1e-2 of |g| or better, by the 1e-4 of
    ``test_torch_flmr_train``) within 1e-3 of their group's lr; every
    element within 2 lr plus the decay; frozen leaves bitwise unchanged."""
    jm, params, tm, batch = flagship_pair()
    lrs = {"main": 1e-3, "mapping": 1e-2}
    kw = dict(optimizer_name="AdamW", lr=lrs["main"], mapping_network_lr=lrs["mapping"],
              scheduler="linear", num_warmup_steps=0, num_training_steps=10,
              weight_decay=0.1, frozen_patterns=FROZEN, group_patterns=GROUP, grad_clip=1.0)
    want_params, want_metrics = _jax_step(jm, params, batch, kw, loss_key)
    jgrads = jax.device_get(jax.grad(
        lambda p: jm.apply({"params": p}, **batch, num_negative_examples=1)
        .in_batch_negative_loss)(params)) if loss_key == "ib_loss" else None

    opt, sched, labels = training.make_optimizer(tm, **kw)
    step = training.make_train_step(tm, opt, sched, loss_key=loss_key)
    state, metrics = step(training.TrainState.create(tm, opt, sched), torch_batch(batch))
    assert state.step == 1 and float(metrics["grads_finite"]) == 1.0
    for k, v in want_metrics.items():
        assert float(metrics[k]) == pytest.approx(v, rel=1e-5, abs=1e-5), k
    want = weights.flmr_state_dict(want_params)
    before = weights.flmr_state_dict(params)
    grads = weights.flmr_state_dict(jgrads) if jgrads is not None else None
    for name, p in tm.named_parameters():
        got, w = p.detach(), want[name]
        if labels[name] == "frozen":
            assert torch.equal(got, before[name]) and torch.equal(w, before[name]), name
            continue
        lr = lrs[labels[name]]
        diff = (got - w).abs()
        assert diff.max() <= 2 * lr * (1 + 0.1 * before[name].abs().max()), name
        if grads is not None:
            g = grads[name].abs()
            sure = g >= 1e-2 * g.max()
            assert diff[sure].max() <= 1e-3 * lr, name


def test_nan_batch_skips_update_then_recovers():
    """A NaN pixel: grads_finite 0, parameters, AdamW moments and the lr
    schedule's position unchanged bitwise, the step still counted; the next
    clean step updates (as ``tests/test_training.py``), with the vision
    tower frozen, whose NaN gradients must not carry over."""
    _, _, tm, batch = flagship_pair()
    opt, sched, _ = training.make_optimizer(tm, lr=1e-3, scheduler="linear",
                                            num_warmup_steps=2, num_training_steps=10,
                                            frozen_patterns=FROZEN)
    step = training.make_train_step(tm, opt, sched)
    state = training.TrainState.create(tm, opt, sched)
    good = torch_batch(batch)
    state, _ = step(state, good)  # a first update, so that the moments exist
    bad = dict(good)
    bad["query_pixel_values"] = good["query_pixel_values"].clone()
    bad["query_pixel_values"][0, 0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    moments = {i: {k: v.clone() for k, v in s.items()} for i, s in
               enumerate(opt.state.values())}
    lr_before, epoch_before = sched.get_last_lr(), sched.last_epoch
    state, metrics = step(state, bad)
    assert float(metrics["grads_finite"]) == 0.0 and state.step == 2
    assert not np.isfinite(float(metrics["ib_loss"]))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    for i, s in enumerate(opt.state.values()):
        for k, v in s.items():
            assert torch.equal(v, moments[i][k]), k
    assert sched.get_last_lr() == lr_before and sched.last_epoch == epoch_before
    assert all(p.grad is None for p in tm.parameters())
    state, metrics = step(state, good)
    assert float(metrics["grads_finite"]) == 1.0 and state.step == 3
    assert np.isfinite(float(metrics["total_loss"]))
    assert any(not torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    assert sched.last_epoch == epoch_before + 1


def test_train_step_reduces_loss_and_keeps_frozen_leaves():
    _, _, tm, batch = flagship_pair()
    frozen = {k: v.clone() for k, v in tm.state_dict().items() if "vision_encoder" in k}
    opt, sched, _ = training.make_optimizer(tm, lr=1e-3, mapping_network_lr=1e-4,
                                            frozen_patterns=FROZEN,
                                            group_patterns=("vision_projection",))
    step = training.make_train_step(tm, opt, sched)
    state = training.TrainState.create(tm, opt, sched)
    losses = []
    for _ in range(4):
        state, metrics = step(state, torch_batch(batch))
        losses.append(float(metrics["total_loss"]))
    assert losses[-1] < losses[0], losses
    for k, v in frozen.items():
        assert torch.equal(tm.state_dict()[k], v), k
    # frozen leaves keep requires_grad: their gradients enter the guard
    assert all(p.requires_grad for p in tm.parameters())


def test_grads_finite_sees_every_leaf():
    lin = nn.Linear(3, 2)
    loss = lin(torch.ones(1, 3)).sum()
    loss.backward()
    assert bool(train_state.grads_finite(lin, loss))
    lin.bias.grad[0] = float("inf")
    assert not bool(train_state.grads_finite(lin, loss))


def test_clip_counts_every_leaf():
    """The global norm includes leaves in no group (frozen), as optax's clip
    ahead of ``multi_transform`` does."""
    a, b = nn.Parameter(torch.zeros(2)), nn.Parameter(torch.zeros(1))
    a.grad, b.grad = torch.tensor([3.0, 0.0]), torch.tensor([4.0])
    optimization.clip_grads_by_global_norm_([a, b], 1.0)
    np.testing.assert_allclose(a.grad.numpy(), [0.6, 0.0], rtol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), [0.8], rtol=1e-6)
    a.grad, b.grad = torch.tensor([0.3, 0.0]), torch.tensor([0.4])
    optimization.clip_grads_by_global_norm_([a, b], 1.0)  # below the clip: unchanged
    np.testing.assert_array_equal(a.grad.numpy(), np.float32([0.3, 0.0]))


def test_embedding_lookup_backward_sums_repeated_ids():
    """BERT's embeddings look up with a backward whose sums run in a fixed
    order (CUDA's embedding backward adds a long run of one id, such as a
    padding id or every token's type, in an order that varies between
    runs): ``index_put_`` with accumulation for a vocabulary, one mask a row
    for a table of a few rows. The forward is ``F.embedding``'s bitwise and
    the gradient is its, within fp32 round-off, with ids repeated
    thousands of times; no graph under no_grad."""
    from reranking_multimodal_retrievers_tpu_torch.models.bert import embedding

    g = torch.Generator().manual_seed(0)
    for rows in (30, 2):
        table = torch.randn(rows, 16, generator=g, requires_grad=True)
        ids = torch.randint(0, rows, (64, 40), generator=g)
        ids[:, 20:] = 0  # a long run of one id
        up = torch.randn(64, 40, 16, generator=g)
        out = embedding(ids, table)
        assert torch.equal(out, torch.nn.functional.embedding(ids, table))
        out.backward(up)
        want = torch.zeros(rows, 16).index_add_(0, ids.reshape(-1), up.reshape(-1, 16))
        np.testing.assert_allclose(table.grad.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)
        with torch.no_grad():
            assert embedding(ids, table).grad_fn is None
