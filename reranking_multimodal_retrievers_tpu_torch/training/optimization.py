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
Adafactor is the port's own :class:`Adafactor`, ``optax.adafactor``'s
arithmetic (``torch.optim.Adafactor`` is another algorithm).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
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
    (``(g / norm) * max_norm``, optax's order); below it, leave them be.

    A parameter split over a tensor-parallel group (``tp_dim``, set by
    ``parallel/tensor_parallel.py``) holds part of its matrix: the squares
    of those parts are summed over the group, those of whole (replicated)
    parameters counted once, so that the norm is the whole model's."""
    with_grad = [p for p in params if p.grad is not None]
    grads = [p.grad for p in with_grad]
    if not grads:
        return
    whole = [g.float().square().sum() for p, g in zip(with_grad, grads)
             if not hasattr(p, "tp_dim")]
    split = [(p, g.float().square().sum()) for p, g in zip(with_grad, grads)
             if hasattr(p, "tp_dim")]
    if split:
        from ..parallel.mesh import all_reduce

        whole.append(all_reduce(torch.stack([sq for _, sq in split]).sum(), split[0][0].tp_group))
    norm = torch.stack(whole).sum().sqrt()
    keep = norm < max_norm  # on the device: no host sync
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


def factored_dims(shape: Sequence[int], min_dim_size_to_factor: int = 128):
    """``optax``'s ``_factored_dims``: ``(d1, d0)``, the second largest and
    the largest axis of ``shape`` (numpy's argsort order on ties), when the
    second largest has at least ``min_dim_size_to_factor`` entries; else
    None (fewer than two axes, or a small one)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(learning_rate)`` with optax's defaults, as the JAX
    package builds it: factored second moments over the two largest axes
    when both have >= ``MIN_DIM_SIZE_TO_FACTOR`` entries (else a full one),
    decayed by ``1 - (t + 1)^-0.8`` at update ``t`` (counted from 0) with
    ``EPS`` added to each squared gradient; the update clipped to a block
    RMS of at most ``CLIPPING_THRESHOLD``, scaled by the group's lr and by
    the parameter's block RMS (at least ``MIN_PARAM_SCALE``), and
    subtracted. No momentum, no weight decay. The arithmetic is fp32 in
    optax's order (``optax._src.factorized.scale_by_factored_rms``, then
    ``clip_by_block_rms``, ``scale_by_learning_rate``,
    ``scale_by_param_block_rms``, ``scale(-1)``)."""

    DECAY_RATE = 0.8
    EPS = 1e-30
    CLIPPING_THRESHOLD = 1.0
    MIN_DIM_SIZE_TO_FACTOR = 128
    MIN_PARAM_SCALE = 1e-3

    # a parameter split over a tensor-parallel group (``tp_dim``) is updated
    # from its whole matrix and gradient, gathered over the group, and its
    # state is kept whole: the factored moments are statistics of whole rows
    # and columns (``parallel/tensor_parallel.py`` leaves that state as it is)
    whole_state = True

    def __init__(self, params, lr: float = 1.0):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, group)
        return loss

    def _update(self, p: torch.Tensor, group) -> None:
        if hasattr(p, "tp_dim"):
            from ..parallel.tensor_parallel import gather_param

            whole = gather_param(p)
            u = self._direction(p, whole, gather_param(p, p.grad), group)
            part = torch.distributed.get_rank(p.tp_group)
            p.add_(-u.chunk(whole.shape[p.tp_dim] // p.shape[p.tp_dim], dim=p.tp_dim)[part])
        else:
            p.add_(-self._direction(p, p, p.grad, group))
        self.state[p]["step"] += 1

    def _direction(self, key: torch.Tensor, p: torch.Tensor, g: torch.Tensor, group):
        """The update of parameter ``p`` (whole) for gradient ``g``, its
        state under ``key``; subtracted by the caller."""
        state = self.state[key]
        dims = factored_dims(tuple(p.shape), self.MIN_DIM_SIZE_TO_FACTOR)
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"] = torch.zeros_like(p.mean(dim=d0))
                state["v_col"] = torch.zeros_like(p.mean(dim=d1))
        # optax's fp32 ``1 - (t + 1)^-0.8``, a scalar the host knows
        decay = float(np.float32(1) - np.float32(state["step"] + 1) ** np.float32(-self.DECAY_RATE))
        g_sq = g * g + self.EPS
        if dims is None:
            v = decay * state["v"] + (1.0 - decay) * g_sq
            state["v"] = v
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            v_row = decay * state["v_row"] + (1.0 - decay) * g_sq.mean(dim=d0)
            v_col = decay * state["v_col"] + (1.0 - decay) * g_sq.mean(dim=d1)
            state["v_row"], state["v_col"] = v_row, v_col
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
        u = u / torch.clamp((u * u).mean().sqrt() / self.CLIPPING_THRESHOLD, min=1.0)
        u = u * group["lr"]
        rms = (p * p).mean().sqrt()
        return u * torch.where(rms <= self.MIN_PARAM_SCALE,
                               torch.full_like(rms, self.MIN_PARAM_SCALE), rms)



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
    package; ``Adafactor`` is :class:`Adafactor` at optax's defaults."""
    if optimizer_name not in ("AdamW", "Adam", "Adafactor"):
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
    elif optimizer_name == "Adafactor":
        optimizer = Adafactor(groups, lr=1.0)
    else:
        optimizer = torch.optim.Adam(groups, lr=1.0)
    lr_scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, [schedules[g["name"]] for g in groups])
    if grad_clip:
        every = list(named.values())
        optimizer.register_step_pre_hook(
            lambda opt, args, kwargs: clip_grads_by_global_norm_(every, grad_clip))
    return optimizer, lr_scheduler, labels
