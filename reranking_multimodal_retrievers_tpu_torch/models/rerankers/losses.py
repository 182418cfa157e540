"""Reranker loss construction (port of ``models/rerankers/losses.py``):
``prepare_logits_labels``, ``rerank_loss`` (differentiable: the loss of the
reranker's training step) and ``primary_logits``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def default_group_labels(batch_size: int, num_negative_examples: int,
                         device=None) -> torch.Tensor:
    """[1, 0, ..., 0] repeated per query, as a [B * (1 + N), 1] column."""
    group = torch.zeros(num_negative_examples + 1, device=device)
    group[0] = 1.0
    return group.repeat(batch_size).reshape(-1, 1)


def prepare_logits_labels(loss_fn_name: str, logits: torch.Tensor,
                          logits_secondary: torch.Tensor, batch_size: int,
                          num_negative_examples: int,
                          labels: Optional[torch.Tensor] = None):
    """Shape (logits, labels) for the loss named ``loss_fn_name``
    (reference `utils.py:228-254`)."""
    if labels is not None:
        labels = torch.as_tensor(labels, dtype=torch.float32,
                                 device=logits.device).reshape(-1, 1)
    if loss_fn_name in ("BCE", "2H_BCE"):
        if labels is None:
            labels = default_group_labels(batch_size, num_negative_examples, logits.device)
        if loss_fn_name == "2H_BCE":
            labels = labels.reshape(-1).int()
            logits = torch.cat([logits, logits_secondary], dim=1)
    elif loss_fn_name == "negative_sampling":
        logits = logits.reshape(-1, num_negative_examples + 1)
        if labels is None:
            labels = torch.zeros(batch_size, dtype=torch.int32, device=logits.device)
        else:
            labels = torch.argmax(
                labels.reshape(-1, num_negative_examples + 1), dim=1).int()
    else:
        raise ValueError(f"Unknown loss function {loss_fn_name}")
    return logits, labels


def rerank_loss(loss_fn_name: str, logits: torch.Tensor, labels: torch.Tensor,
                pos_weight: Optional[float] = None) -> torch.Tensor:
    """Reference `utils.py:208-224`: BCE with logits, weighted 2-class CE, or
    CE over each (1 + N) group. Returns a 0-d fp32 tensor."""
    if loss_fn_name == "BCE":
        logits = logits.float().reshape(-1)
        labels = labels.float().reshape(-1)
        w_pos = pos_weight if pos_weight is not None else 1.0
        per = -(w_pos * labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
        return per.mean()
    if loss_fn_name in ("2H_BCE", "negative_sampling"):
        logits = logits.float()
        labels = labels.long().reshape(-1)
        per = torch.logsumexp(logits, dim=-1) - logits.gather(1, labels[:, None])[:, 0]
        if loss_fn_name == "2H_BCE" and pos_weight is not None:
            w = torch.where(labels == 1, pos_weight, 1.0)
            return (per * w).sum() / w.sum().clamp_min(1e-9)
        return per.mean()
    raise ValueError(f"Unknown loss function {loss_fn_name}")


def primary_logits(loss_fn_name: str, logits: torch.Tensor) -> torch.Tensor:
    """The ranking logits: the positive-class head after 2H_BCE."""
    if loss_fn_name == "2H_BCE":
        return logits[:, 1:2]
    if loss_fn_name == "negative_sampling":
        return logits.reshape(-1, 1)
    return logits
