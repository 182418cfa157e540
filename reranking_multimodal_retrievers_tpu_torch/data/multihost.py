"""Per-rank input pipeline (port of ``data/multihost.py``).

Each rank loads a disjoint shard of the dataset: process ``i`` of ``P`` takes
rows ``i, i+P, ...`` (round-robin keeps shard sizes within one, and short
shards are padded by wrap so every rank runs the same number of steps).
:class:`MultiHostDataLoader` takes the GLOBAL batch size and yields the
rank's local batch, its arrays as tensors on the rank's device. The JAX
package then assembles one global ``jax.Array`` from the processes' batches;
here nothing is assembled: the global batch is the union of the ranks'
batches, and a data-parallel step reduces over them itself.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from .loaders import DataLoader


class ProcessShardDataset:
    """View of a map-style dataset holding every ``process_count``-th row
    starting at ``process_index`` (round-robin keeps shard sizes within 1)."""

    def __init__(self, dataset, process_index: int, process_count: int):
        assert 0 <= process_index < process_count
        self.dataset = dataset
        self.process_index = process_index
        self.process_count = process_count
        n = len(dataset)
        self._indices = list(range(process_index, n, process_count))
        # equal shard lengths, so that every rank runs the same number of
        # steps: short shards wrap. A shard can be EMPTY (fewer rows than
        # ranks); wrap-doubling an empty list stays empty, so it takes the
        # global round-robin row instead and serves _common_len rows too
        self._common_len = max(n // process_count, 1) if n else 0
        if n:
            if not self._indices:
                self._indices = [process_index % n]
            while len(self._indices) < self._common_len:
                self._indices = self._indices * 2
            self._indices = self._indices[: self._common_len]
        self.collate_fn = getattr(dataset, "collate_fn", None)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self.dataset[self._indices[int(i)]]


class MultiHostDataLoader:
    """Per-rank loader. ``batch_size`` is the GLOBAL batch size; each rank
    loads ``batch_size // process_count`` rows a step. Yields dicts whose
    numpy arrays are tensors on ``device`` (the mesh's device by default);
    other values (question ids, strings) stay as they are.

    ``process_index``/``process_count`` default to the mesh's data index
    and data size (ranks of one model group load the same rows)."""

    def __init__(self, dataset, batch_size: int, mesh=None, shuffle: bool = True,
                 seed: int = 0, collate_fn=None, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, device=None):
        pi = (mesh.data_index if mesh is not None else 0) if process_index is None \
            else process_index
        pc = (mesh.n_data if mesh is not None else 1) if process_count is None \
            else process_count
        assert batch_size % pc == 0, (batch_size, pc)
        self.mesh = mesh
        self.device = torch.device(device) if device is not None else (
            mesh.device if mesh is not None else torch.device("cpu"))
        self.local_batch = batch_size // pc
        shard = ProcessShardDataset(dataset, pi, pc)
        self.local_loader = DataLoader(shard, batch_size=self.local_batch, shuffle=shuffle,
                                       drop_last=True, seed=seed, collate_fn=collate_fn)

    def __len__(self):
        return len(self.local_loader)

    def set_epoch(self, epoch: int):
        self.local_loader.set_epoch(epoch)

    def _localize(self, batch: dict) -> dict:
        return {k: (torch.as_tensor(v).to(self.device)
                    if isinstance(v, np.ndarray) and v.ndim >= 1 else v)
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        for batch in self.local_loader:
            batch.pop("_real_count", None)
            yield self._localize(batch)
