"""Several devices over ``torch.distributed`` (port of ``parallel/``): the
mesh, its collectives, the rank launcher and tensor-parallel layouts."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from .tensor_parallel import (
    describe as tp_describe,
    partition_spec as tp_partition_spec,
    shard_module as tp_shard_module,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "shard_batch",
    "replicate",
    "pad_to_multiple",
    "tp_partition_spec",
    "tp_shard_module",
    "tp_describe",
]
