"""The device mesh over ``torch.distributed`` (port of ``parallel/mesh.py``).

The JAX package's mesh is one controller: one process, global arrays, and
collectives that XLA inserts. Here the same layout is SPMD over processes:
one rank a device (``parallel/launch.py`` starts them), a :class:`Mesh` that
holds the rank's place in the ``(data, model)`` grid and its two process
groups, and every collective explicit. Rank ``r`` sits at data index
``r // n_model`` and model index ``r % n_model``, the order in which the JAX
package reshapes its device list.

- data parallelism: each rank keeps its rows of the global batch
  (:func:`shard_batch`), gradients are averaged over the data group;
- tensor parallelism (``parallel/tensor_parallel.py``): weight matrices split
  over the model group, one all-reduce a block.

With one rank (no process group) the mesh is ``1 x 1`` and every collective
returns its input.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass
class Mesh:
    """This rank's view of a ``n_data x n_model`` grid of ranks."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: Any = None  # ranks with this rank's model index
    model_group: Any = None  # ranks with this rank's data index

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes files."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is None or a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (parallel.make_mesh), got "
                        f"{type(mesh).__name__}")


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def check_fits(n_data: int, n_model: int, available: int) -> None:
    """Raise the JAX package's ``ValueError`` when a ``n_data x n_model``
    mesh wants more devices than ``available``."""
    if n_data * n_model > available:
        raise ValueError(
            f"mesh wants {n_data} (data) x {n_model} (model) = "
            f"{n_data * n_model} devices but only {available} are "
            "available — lower --n_devices / n_model or add devices "
            "(start one rank a device with parallel/launch.py)")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """Build this rank's ``(data, model)`` mesh over the ranks of the default
    process group (every rank must call it, with the same arguments).

    ``n_data`` defaults to the world size over ``n_model``. ``device`` is
    this rank's device: by default its current CUDA card when the process
    group runs on CUDA ranks, else the CPU."""
    size = world_size()
    if n_data is None:
        n_data = size // n_model
    check_fits(n_data, n_model, size)
    if n_data * n_model != size:
        raise ValueError(f"a {n_data} x {n_model} mesh needs exactly {n_data * n_model} "
                         f"ranks, the process group has {size}")
    rank = dist.get_rank() if size > 1 else 0
    if device is None:
        device = _default_device()
    mesh = Mesh(n_data=n_data, n_model=n_model, rank=rank, device=torch.device(device))
    if size > 1:
        # every rank creates every group, in the same order
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == mesh.model_index:
                mesh.data_group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == mesh.data_index:
                mesh.model_group = g
    return mesh


_rank_device: Optional[torch.device] = None


def set_rank_device(device: torch.device) -> None:
    """Record the device this rank was bound to (``parallel/launch.py``)."""
    global _rank_device
    _rank_device = torch.device(device)


def _default_device() -> torch.device:
    if _rank_device is not None:
        return _rank_device
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ---------------------------------------------------------------- collectives
#
# gloo runs all_gather on host tensors only (and NCCL on card tensors only):
# under gloo a card tensor goes through the host. That is the layout of
# several ranks time-sharing one card; its collectives cost host copies.

def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``t`` over ``group`` (a new tensor; ``t`` is kept)."""
    if _group_size(group) == 1:
        return t.clone()
    if _via_host(t, group):
        h = t.detach().cpu()
        dist.all_reduce(h, op=op, group=group)
        return h.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (every
    rank's ``t`` has the same shape). Bool tensors travel as uint8."""
    n = _group_size(group)
    if n == 1:
        return t
    src = t.detach()
    dtype = src.dtype
    if dtype == torch.bool:
        src = src.to(torch.uint8)
    host = _via_host(src, group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    if host:
        out = out.to(t.device)
    return out.to(dtype)


class _GatherRows(torch.autograd.Function):
    """Forward: the group's rows concatenated; backward: the gradient summed
    over the group, then this rank's rows. Where every rank computes the
    same loss of the gathered rows, the backward so gives each rank
    ``group size`` times its rows' gradient, which the data-parallel mean of
    the parameter gradients divides out again."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = x.shape[0]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return all_reduce(g.contiguous(), ctx.group)[r * ctx.n:(r + 1) * ctx.n], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather of ``x``'s rows over ``group`` (the JAX
    package's ``jax.lax.all_gather(x, axis, tiled=True)``)."""
    if _group_size(group) == 1:
        return x
    if not x.requires_grad:
        return all_gather(x, group)
    return _GatherRows.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduced backward: the entry of a column-parallel
    layer, whose input every rank of the group holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduced forward, identity backward: the exit of a row-parallel
    layer, whose partial products the group sums."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if _group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if _group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


# ------------------------------------------------------------------- layout

def _rows(x, mesh: Mesh, axis: int):
    n = x.shape[axis]
    if n % mesh.n_data:
        raise ValueError(f"{n} rows do not shard evenly over {mesh.n_data} data ranks")
    step = n // mesh.n_data
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(mesh.data_index * step, (mesh.data_index + 1) * step)
    return x[tuple(idx)]


def shard_batch(mesh: Mesh, tree, axis: int = 0):
    """This rank's block of every array (tensor or numpy) in a dict, list or
    tuple, along ``axis`` over the data axis: the ``P(DATA_AXIS)`` layout.
    Tensors land on the mesh's device; other values pass unchanged."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, axis) for v in tree)
    if isinstance(tree, np.ndarray) and tree.ndim:
        return torch.as_tensor(_rows(tree, mesh, axis)).to(mesh.device)
    if isinstance(tree, torch.Tensor) and tree.ndim:
        return _rows(tree, mesh, axis).to(mesh.device)
    return tree


def replicate(mesh: Mesh, tree):
    """Make every rank hold rank 0's values: a module's parameters and
    buffers, or the tensors of a dict, list or tuple, broadcast in place
    (a tensor returned as it is, on the mesh's device)."""
    if isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            _broadcast_(t.data, mesh)
        return tree
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to(mesh.device)
        _broadcast_(t, mesh)
        return t
    return tree


def _broadcast_(t: torch.Tensor, mesh: Mesh) -> None:
    if mesh.size == 1:
        return
    if t.is_cuda and dist.get_backend() == "gloo":
        h = t.cpu()
        dist.broadcast(h, src=0)
        t.copy_(h)
    else:
        dist.broadcast(t, src=0)


def broadcast_object(obj, mesh: Optional[Mesh] = None):
    """Rank 0's ``obj`` on every rank (a picklable host value)."""
    if (mesh is not None and mesh.size == 1) or world_size() == 1:
        return obj
    box: List[Any] = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad a host array so ``x.shape[axis]`` divides ``multiple``; returns
    ``(padded, original_length)``."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width, constant_values=fill), n
