"""Optimizers, schedules and parameter groups (port of
``training/optimization.py``).

The JAX package builds an optax transform: AdamW or Adam per group, a
``main`` and a ``mapping`` group with their own learning rates, ``frozen``
leaves under ``set_to_zero``, all behind an optional global-norm clip. Here
that is one ``torch.optim`` optimizer with two param groups, frozen
parameters in no group (no update, no weight decay; they keep
``requires_grad`` so that their gradients are computed and checked, as
``jax.value_and_grad`` over the whole tree computes them), a ``LambdaLR``
that gives each group its schedule's value, and the clip as a pre-step hook
over every parameter, frozen ones included, as
``optax.chain(clip_by_global_norm, multi_transform)`` takes the norm.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``: constant ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """``optax.join_schedules`` of two schedules: the second restarts its
    count at ``boundary``."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if decay_steps <= 0:
        raise ValueError(f"a cosine schedule needs positive decay steps, got {decay_steps}")

    def schedule(count):
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def make_schedule(name: Optional[str], lr: float, num_warmup_steps: int = 0,
                  num_training_steps: Optional[int] = None,
                  eta_min: float = 1e-5) -> Schedule:
    """``linear`` | ``cosine`` | constant (any other name), each with linear
    warmup; a function of the update count that returns optax's value.
    ``num_warmup_steps=0`` means no warmup: step 0 runs at the full lr. The
    cosine decay spans ``num_training_steps`` including the warmup, down to
    ``eta_min``."""
    if name == "linear":
        if num_training_steps is None:
            raise ValueError("a linear schedule needs num_training_steps")
        decay = _linear(lr, 0.0, max(num_training_steps - num_warmup_steps, 1))
        if num_warmup_steps <= 0:
            return decay
        return _join(_linear(0.0, lr, num_warmup_steps), decay, num_warmup_steps)
    if name == "cosine":
        if num_training_steps is None:
            raise ValueError("a cosine schedule needs num_training_steps")
        if num_warmup_steps <= 0:
            return _cosine(lr, num_training_steps, eta_min / lr if lr else 0.0)
        return _join(_linear(0.0, lr, num_warmup_steps),
                     _cosine(lr, num_training_steps - num_warmup_steps,
                             eta_min / lr if lr else 0.0),
                     num_warmup_steps)
    if num_warmup_steps > 0:
        return _join(_linear(0.0, lr, num_warmup_steps), lambda count: lr, num_warmup_steps)
    return lambda count: lr


def label_params(model: nn.Module,
                 group_patterns: Sequence[str] = ("late_interaction_adapter",),
                 frozen_patterns: Sequence[str] = ()) -> Dict[str, str]:
    """Label each parameter ``frozen`` | ``mapping`` | ``main`` by a
    substring of its name (frozen patterns first)."""
    labels = {}
    for name, _ in model.named_parameters():
        if any(pat in name for pat in frozen_patterns):
            labels[name] = "frozen"
        elif any(pat in name for pat in group_patterns):
            labels[name] = "mapping"
        else:
            labels[name] = "main"
    return labels


def clip_grads_by_global_norm_(params: Sequence[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm``: when the norm of every gradient taken
    together reaches ``max_norm``, scale each by ``max_norm / norm``
    (``(g / norm) * max_norm``, optax's order); below it, leave them be."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm  # on the device: no host sync
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


def make_optimizer(model: nn.Module, optimizer_name: str = "AdamW", lr: float = 1e-3,
                   mapping_network_lr: Optional[float] = None,
                   scheduler: Optional[str] = None, num_warmup_steps: int = 0,
                   num_training_steps: Optional[int] = None, weight_decay: float = 0.0,
                   group_patterns: Sequence[str] = ("late_interaction_adapter",),
                   frozen_patterns: Sequence[str] = (),
                   grad_clip: Optional[float] = None):
    """The (optionally two-group) optimizer over ``model``'s parameters.

    Returns ``(optimizer, lr_scheduler, labels)``. Each group's lr is its
    schedule's value at the update count: the scheduler steps once per
    applied update. ``weight_decay`` applies to AdamW only, as in the JAX
    package. Adafactor is not ported (``torch.optim.Adafactor`` is not
    ``optax.adafactor``)."""
    if optimizer_name == "Adafactor":
        raise NotImplementedError("Adafactor is not ported (torch's Adafactor is not optax's)")
    if optimizer_name not in ("AdamW", "Adam"):
        raise ValueError(f"Invalid optimizer name: {optimizer_name}")
    labels = label_params(model, group_patterns, frozen_patterns)
    schedules = {
        "main": make_schedule(scheduler, lr, num_warmup_steps, num_training_steps),
        "mapping": make_schedule(scheduler,
                                 mapping_network_lr if mapping_network_lr is not None else lr,
                                 num_warmup_steps, num_training_steps),
    }
    named = dict(model.named_parameters())
    # lr 1.0 in each group: LambdaLR sets it to 1.0 * schedule(count),
    # the schedule's value exactly
    groups = [{"params": [named[n] for n, lab in labels.items() if lab == g], "lr": 1.0,
               "name": g} for g in ("main", "mapping")]
    groups = [g for g in groups if g["params"]]
    if optimizer_name == "AdamW":
        optimizer = torch.optim.AdamW(groups, lr=1.0, weight_decay=weight_decay)
    else:
        optimizer = torch.optim.Adam(groups, lr=1.0)
    lr_scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, [schedules[g["name"]] for g in groups])
    if grad_clip:
        every = list(named.values())
        optimizer.register_step_pre_hook(
            lambda opt, args, kwargs: clip_grads_by_global_norm_(every, grad_clip))
    return optimizer, lr_scheduler, labels
