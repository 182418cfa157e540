"""The train step (port of ``training/train_state.py``).

One step: the model's training forward, the backward of the chosen loss
over every parameter, the NaN guard, and the optimizer's update. The JAX
package's step is one jitted program; here it is eager PyTorch, and the
guard's branch costs one host sync a step (the finiteness flag is read on
the host to decide whether the optimizer runs).

The reference backpropagates the in-batch-negative loss only, so
``loss_key`` defaults to ``ib_loss``.
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


def apply_update(state: TrainState, loss: torch.Tensor, guard: bool = True) -> bool:
    """Backward of ``loss``, then the update. With ``guard``, the NaN guard
    of JAX ``train_state.py:101-123``: only when the loss and every gradient
    are finite do the optimizer (behind its clip) update and the scheduler
    advance; otherwise parameters, optimizer state and scheduler stay as they
    were. ``state.step`` advances either way. Returns whether the update
    was applied."""
    loss.backward()
    _fill_missing_grads(state.model)
    finite = not guard or bool(grads_finite(state.model, loss))  # the guard's host sync
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
    step), detached 0-d fp32 tensors on the model's device."""
    if mesh is not None or tensor_parallel:
        raise NotImplementedError("multi-device training (mesh, tensor_parallel) is not ported yet")
    if loss_key not in ("ib_loss", "loss", "sum"):
        raise ValueError(f"loss_key must be 'ib_loss', 'loss' or 'sum', got {loss_key!r}")

    def step_fn(state: TrainState, batch: Mapping[str, torch.Tensor]):
        _check_state(state, model, optimizer, scheduler)
        out = model(**batch, num_negative_examples=num_negative_examples,
                    use_in_batch_negatives=use_in_batch_negatives)
        ib = out.in_batch_negative_loss
        if loss_key == "ib_loss":
            loss = ib
        elif loss_key == "loss":
            loss = out.loss
        else:
            loss = out.loss + ib
        finite = apply_update(state, loss)
        metrics = {"loss": out.loss.detach(),
                   "ib_loss": ib.detach() if ib is not None else out.loss.new_zeros(()),
                   "total_loss": loss.detach(),
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
