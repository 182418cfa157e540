"""Megatron-style tensor parallelism over the mesh's model axis (port of
``parallel/tensor_parallel.py``).

The JAX package states the layout as parameter shardings and lets GSPMD
place the collectives. Here :func:`shard_module` keeps each rank's slice of
every split weight and turns the owning layers into their parallel form,
with the two collectives explicit:

- column-parallel (output features split): the attention Q/K/V projections
  and the FFN up-projections (``query/key/value``, ``q_proj/k_proj/v_proj``,
  ``q/k/v``, ``intermediate``, ``fc1``, ``wi/wi_0/wi_1``), biases split
  alike, and a LoRA adapter's ``lora_b``. The input enters through an
  identity whose backward all-reduces the gradient over the model group;
- row-parallel (input features split): the attention output projections
  and the FFN down-projections (``out/out_proj/o``, ``output``, ``fc2``,
  ``wo``) and a LoRA adapter's ``lora_a``. The partial products are
  all-reduced, then the (whole) bias is added once;
- T5's ``relative_attention_bias`` split over heads, with Q/K/V;
- everything else (embeddings, layer norms, heads, mapping layers)
  replicated.

A ``torch.nn.Linear`` weight is ``[out, in]``: column-parallel splits dim 0,
row-parallel dim 1 (the JAX kernel is ``[in, out]``). The owner of a
parameter is the nearest enclosing module whose name is not ``dense`` (the
HF names put ``intermediate.dense``, ``attention.output.dense`` and
``output.dense`` one level below the module that classifies them); FLMR's
vision projection keeps its layers as ``model.0`` and ``model.2``, the JAX
package's ``fc1`` and ``fc2``. The BLIP-2 vision tower
(``models/blip2.py::Blip2VisionModel``) stays whole, as its JAX names
(``layer_N_fc1``) classify it. The
attention blocks take their head count from the width they hold, so each
rank runs its share of the heads, through K2 where the model fuses.

Every split parameter carries ``tp_dim`` (the dimension split) and
``tp_group``: the optimizer's global-norm clip and Adafactor's factored
moments read them to see whole matrices (``training/optimization.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.lora import LoRALinear
from .mesh import MODEL_AXIS, Mesh, all_gather, copy_to_group, reduce_from_group

# owner-module names -> column-parallel (output features split)
_COLUMN = frozenset({
    "query", "key", "value", "q_proj", "k_proj", "v_proj", "q", "k", "v",
    "intermediate", "fc1", "wi", "wi_0", "wi_1",
})
# owner-module names -> row-parallel (input features split, bias whole)
_ROW = frozenset({"out", "out_proj", "o", "output", "fc2", "wo"})


_SEQUENTIAL = {"0": "fc1", "2": "fc2"}  # FLMR's VisionProjection.model


def _owner(names):
    if len(names) >= 3 and names[-3] == "model" and names[-2] in _SEQUENTIAL:
        return _SEQUENTIAL[names[-2]]
    for name in reversed(names[:-1]):
        if name != "dense":
            return name
    return ""


def partition_spec(name: str, param: torch.Tensor) -> Optional[int]:
    """The dimension of parameter ``name`` (a dotted ``named_parameters``
    name) split over the model axis, or None when it is replicated."""
    names = name.split(".")
    kind, owner, ndim = names[-1], _owner(names), param.ndim
    if owner in _COLUMN:
        if kind in ("weight", "lora_b") and ndim == 2:
            return 0
        if kind == "bias" and ndim == 1:
            return 0
    if owner in _ROW and kind in ("weight", "lora_a") and ndim == 2:
        return 1
    if owner == "relative_attention_bias" and kind == "weight" and ndim == 2:
        return 1  # [buckets, heads]
    return None


def split_dims(model: nn.Module) -> Dict[str, Optional[int]]:
    """``name -> split dim (or None)`` for every parameter of ``model``:
    :func:`partition_spec`, but the BLIP-2 vision tower whole."""
    from ..models.blip2 import Blip2VisionModel

    whole = [n for n, m in model.named_modules() if isinstance(m, Blip2VisionModel)]
    return {name: None if any(w == "" or name.startswith(w + ".") for w in whole)
            else partition_spec(name, p) for name, p in model.named_parameters()}


def describe(model: nn.Module) -> Dict[str, str]:
    """``name -> "dim d over model"`` for the split parameters (tests and
    debugging; replicated ones are left out)."""
    return {name: f"dim {d} over {MODEL_AXIS}" for name, d in split_dims(model).items()
            if d is not None}


class _ColumnLinear(nn.Linear):
    def forward(self, x):
        return F.linear(copy_to_group(x, self.tp_group), self.weight, self.bias)


class _RowLinear(nn.Linear):
    def forward(self, x):
        y = reduce_from_group(F.linear(x, self.weight), self.tp_group)
        return y if self.bias is None else y + self.bias


class _ColumnLoRA(LoRALinear):
    """Base weight, bias and ``lora_b`` split on the output features; the
    rank-r activation ``x A^T`` is whole on every rank and enters ``lora_b``
    through the all-reduced-backward identity, so ``lora_a``'s gradient is
    whole too."""

    def forward(self, x):
        g = self.tp_group
        y = F.linear(copy_to_group(x, g), self.weight, self.bias)
        h = copy_to_group(F.linear(x, self.lora_a.to(x.dtype)), g)
        return y + self.scaling * F.linear(h, self.lora_b.to(x.dtype))


class _RowLoRA(LoRALinear):
    """Base weight and ``lora_a`` split on the input features; the rank-r
    activation is all-reduced before the whole ``lora_b``."""

    def forward(self, x):
        g = self.tp_group
        y = reduce_from_group(F.linear(x, self.weight), g)
        if self.bias is not None:
            y = y + self.bias
        h = reduce_from_group(F.linear(x, self.lora_a.to(x.dtype)), g)
        return y + self.scaling * F.linear(h, self.lora_b.to(x.dtype))


_PARALLEL = {
    (nn.Linear, 0): _ColumnLinear, (nn.Linear, 1): _RowLinear,
    (LoRALinear, 0): _ColumnLoRA, (LoRALinear, 1): _RowLoRA,
}


def _slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim]
    if n % mesh.n_model:
        raise ValueError(f"dimension {dim} of size {n} does not split over "
                         f"{mesh.n_model} model ranks")
    return t.chunk(mesh.n_model, dim=dim)[mesh.model_index].contiguous()


def shard_module(mesh: Mesh, model: nn.Module,
                 optimizer: Optional[torch.optim.Optimizer] = None) -> nn.Module:
    """Split ``model`` in place over ``mesh``'s model axis (the JAX
    package's ``shard_tree`` of the params and, with ``optimizer``, of its
    state: every state tensor of a split parameter's full shape is split
    alike). Returns ``model``."""
    if mesh.n_model == 1:
        return model
    full_shapes = {}
    dims = split_dims(model)
    for name, p in model.named_parameters():
        d = dims[name]
        if d is None:
            continue
        full_shapes[p] = p.shape
        p.data = _slice(p.data, d, mesh)
        p.tp_dim, p.tp_group = d, mesh.model_group
    for name, m in model.named_modules():
        w = getattr(m, "weight", None)
        d = getattr(w, "tp_dim", None) if isinstance(w, nn.Parameter) else None
        if d is None or not isinstance(m, nn.Linear):
            continue
        base = LoRALinear if isinstance(m, LoRALinear) else nn.Linear
        if type(m) not in (base, _PARALLEL[(base, d)]):
            raise ValueError(f"{name}: a {type(m).__name__} takes no tensor-parallel split")
        m.__class__ = _PARALLEL[(base, d)]
        m.tp_group = mesh.model_group
    if optimizer is not None and not getattr(optimizer, "whole_state", False):
        for p, st in optimizer.state.items():
            if p in full_shapes:
                for k, v in st.items():
                    if torch.is_tensor(v) and v.shape == full_shapes[p]:
                        st[k] = _slice(v, p.tp_dim, mesh)
    return model


def gather_param(p: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole value of split parameter ``p`` (or of ``t``, a tensor of
    ``p``'s local shape, such as its gradient), gathered over the model
    group; ``p`` itself when it is not split."""
    t = p.data if t is None else t
    d = getattr(p, "tp_dim", None)
    if d is None:
        return t
    return all_gather(t, p.tp_group, dim=d)
