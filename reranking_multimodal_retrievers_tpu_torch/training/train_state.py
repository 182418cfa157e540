"""The train step (port of ``training/train_state.py``).

One step: the model's training forward, the backward of the chosen loss
over every parameter, the NaN guard, and the optimizer's update. The JAX
package's step is one jitted program; here it is eager PyTorch, and the
guard's branch costs one host sync a step (the finiteness flag is read on
the host to decide whether the optimizer runs).

The reference backpropagates the in-batch-negative loss only, so
``loss_key`` defaults to ``ib_loss``.

Over a mesh (``parallel/``) each rank steps on its rows of the global batch:
the in-batch negatives span the global batch through an all-gather over the
data group, the gradients are averaged over the data group, the metrics are
reduced to their global values and the NaN guard's flag is reduced over
every rank, so that all of them take or skip a step together. The result is
the single-process step over the global batch, as the JAX package's sharded
step equals its unsharded one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Tuple

import torch
from torch import nn

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The step count and what holds the weights and the optimizer's state.
    ``step`` counts every step taken, skipped ones too; the scheduler counts
    applied updates only, as optax's count does."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any

    @classmethod
    def create(cls, model, optimizer, scheduler) -> "TrainState":
        return cls(step=0, model=model, optimizer=optimizer, scheduler=scheduler)


def grads_finite(model: nn.Module, loss: torch.Tensor) -> torch.Tensor:
    """A 0-d bool on the loss's device: the loss and the gradient of every
    parameter (frozen ones included) are finite. The gradients go through
    the fused multi-tensor check that ``torch.amp.GradScaler`` uses, a few
    launches for all of them where one ``isfinite().all()`` each costs two
    launches a leaf; its unscale by 1.0 leaves every gradient bitwise."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    found = torch.zeros((), device=loss.device)
    torch._amp_foreach_non_finite_check_and_unscale_(grads, found, found.new_ones(()))
    return (found == 0) & torch.isfinite(loss).all()


def _fill_missing_grads(model: nn.Module) -> None:
    """A parameter the loss does not reach gets a zero gradient, as
    ``jax.grad`` gives it; without one, AdamW would skip it (no moment
    update, no weight decay) where optax updates it."""
    for p in model.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)


GRAD_BUCKET_BYTES = 64 << 20  # gradients all-reduced together, at most


def average_grads(model: nn.Module, mesh, params=None) -> None:
    """Average the gradients of ``params`` (every parameter of ``model``
    with a gradient by default) over ``mesh``'s data group, in buckets of
    flattened tensors of one dtype."""
    if mesh is None or mesh.n_data == 1:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    from ..parallel.mesh import all_reduce

    params = model.parameters() if params is None else params
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        bucket, size = [], 0
        for g in group + [None]:
            if g is not None and (not bucket or size + g.numel() * g.element_size()
                                  <= GRAD_BUCKET_BYTES):
                bucket.append(g)
                size += g.numel() * g.element_size()
                continue
            flat = all_reduce(_flatten_dense_tensors(bucket), mesh.data_group)
            flat /= mesh.n_data
            for dst, src in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                dst.copy_(src)
            bucket, size = ([g], g.numel() * g.element_size()) if g is not None else ([], 0)


def _all_ranks(flag: bool, mesh, device) -> bool:
    """Whether ``flag`` holds on every rank of ``mesh``."""
    if mesh is None or mesh.size == 1:
        return flag
    import torch.distributed as dist

    from ..parallel.mesh import all_reduce

    t = torch.tensor(float(flag), device=device)
    return bool(all_reduce(t, dist.group.WORLD, op=dist.ReduceOp.MIN) > 0)


def apply_update(state: TrainState, loss: torch.Tensor, guard: bool = True,
                 mesh=None) -> bool:
    """Backward of ``loss``, then the update. With ``guard``, the NaN guard
    of JAX ``train_state.py:101-123``: only when the loss and every gradient
    are finite do the optimizer (behind its clip) update and the scheduler
    advance; otherwise parameters, optimizer state and scheduler stay as they
    were. ``state.step`` advances either way. Returns whether the update
    was applied.

    With ``mesh``, the gradients are first averaged over its data group
    (every parameter's, frozen ones too, since the clip's norm and the guard
    read them) and the guard's decision is taken by every rank together."""
    loss.backward()
    _fill_missing_grads(state.model)
    average_grads(state.model, mesh)
    finite = not guard or _all_ranks(bool(grads_finite(state.model, loss)), mesh,
                                     loss.device)  # the guard's host sync
    if finite:
        state.optimizer.step()
        state.scheduler.step()
    # every gradient, frozen leaves' too (they are in no param group), so
    # that none carries over into the next step
    state.model.zero_grad(set_to_none=True)
    state.step += 1
    return finite


def _check_state(state: TrainState, model, optimizer, scheduler) -> None:
    if (state.model is not model or state.optimizer is not optimizer
            or state.scheduler is not scheduler):
        raise ValueError("the state holds another model, optimizer or scheduler than "
                         "this step was made for")


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler,
                    mesh=None, loss_key: str = "ib_loss", num_negative_examples: int = 1,
                    use_in_batch_negatives: bool = True,
                    tensor_parallel: bool = False) -> Callable[..., Tuple[TrainState, Metrics]]:
    """The FLMR retriever's train step: ``step(state, batch) -> (state,
    metrics)`` for a :class:`TrainState` over ``model``, ``optimizer`` and
    ``scheduler``, where ``batch`` holds the keyword arguments of
    ``FLMRModelForRetrieval.forward``.

    ``loss_key``: ``ib_loss`` (the reference's), ``loss`` or ``sum``. The
    metrics are those of the JAX step: ``loss``, ``ib_loss``, ``total_loss``
    (the loss backpropagated) and ``grads_finite`` (1.0, or 0.0 for a skipped
    step), detached 0-d fp32 tensors on the model's device.

    ``mesh`` (``parallel.make_mesh``): ``batch`` holds this rank's rows of
    the global batch (``parallel.shard_batch``), the parameters are the same
    on every rank of a model group (``parallel.replicate``), and the metrics
    are the global batch's. ``tensor_parallel``: the model was split over the
    mesh's model axis first (``parallel.tensor_parallel.shard_module``)."""
    from ..parallel.mesh import check_mesh

    check_mesh(mesh)
    if loss_key not in ("ib_loss", "loss", "sum"):
        raise ValueError(f"loss_key must be 'ib_loss', 'loss' or 'sum', got {loss_key!r}")
    if tensor_parallel and (mesh is None or (mesh.n_model > 1 and not any(
            hasattr(p, "tp_dim") for p in model.parameters()))):
        raise ValueError("tensor_parallel needs a mesh and a model split over its model "
                         "axis (parallel.tensor_parallel.shard_module)")
    gather = mesh.data_group if mesh is not None and mesh.n_data > 1 else None

    def global_mean(x: torch.Tensor) -> torch.Tensor:
        """The mean over the data group of each rank's batch mean: the
        global batch's mean, shards being equal."""
        if gather is None:
            return x
        from ..parallel.mesh import all_reduce

        return all_reduce(x, gather) / mesh.n_data

    def step_fn(state: TrainState, batch: Mapping[str, torch.Tensor]):
        _check_state(state, model, optimizer, scheduler)
        out = model(**batch, num_negative_examples=num_negative_examples,
                    use_in_batch_negatives=use_in_batch_negatives,
                    **({"gather_group": gather} if gather is not None else {}))
        ib = out.in_batch_negative_loss
        if loss_key == "ib_loss":
            loss = ib
        elif loss_key == "loss":
            loss = out.loss
        else:
            loss = out.loss + ib
        finite = apply_update(state, loss, mesh=mesh)
        aligned = global_mean(out.loss.detach())
        ib_value = ib.detach() if ib is not None else out.loss.new_zeros(())
        total = {"ib_loss": ib_value, "loss": aligned}.get(loss_key, aligned + ib_value)
        metrics = {"loss": aligned, "ib_loss": ib_value, "total_loss": total,
                   "grads_finite": out.loss.new_tensor(float(finite))}
        return state, metrics

    return step_fn


def make_rerank_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler,
                           num_negative_examples: int) -> Callable[..., Tuple[TrainState, Metrics]]:
    """The monoPreFLMR reranker's train step (JAX
    ``executors/reranker_executor.py:508-536``): ``step(state, batch) ->
    (state, {"loss"})`` with ``batch`` the keyword arguments of the
    reranker's forward, whose ``loss`` is backpropagated. Like the JAX step
    it has no NaN guard (and no host sync): every step updates."""

    def step_fn(state: TrainState, batch: Mapping[str, torch.Tensor]):
        _check_state(state, model, optimizer, scheduler)
        out = model(**batch, num_negative_examples=num_negative_examples)
        apply_update(state, out.loss, guard=False)
        return state, {"loss": out.loss.detach()}

    return step_fn
