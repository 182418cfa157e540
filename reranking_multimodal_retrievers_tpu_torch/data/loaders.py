"""Batching loaders (port of ``data/loaders.py``).

Replaces the reference's ``torch.utils.data.DataLoader`` plumbing
(`src/data_ops/common_data_opts.py:177-290`) with a NumPy loader producing
fixed-shape batches, as the JAX package's does: train loaders shuffle
per-epoch with a seeded generator and drop the ragged tail; eval loaders pad
the tail batch by repeating the last sample and report ``_real_count``.
The image processor is ``data/image_io.py``'s (no PIL);
``CLIPImageProcessorNP`` keeps the JAX package's name for it.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import numpy as np

from .image_io import CLIPImageProcessor

CLIPImageProcessorNP = CLIPImageProcessor

class DataLoader:
    """Deterministic batching over a map-style dataset with a collate_fn."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_last: bool = False,
        seed: int = 0,
        collate_fn: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.seed = seed
        self.epoch = 0
        self.collate_fn = collate_fn or getattr(dataset, "collate_fn", None) or _default_collate

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        bs = self.batch_size
        end = (n // bs) * bs if self.drop_last else n
        for start in range(0, end, bs):
            idx = order[start : start + bs]
            real = len(idx)
            if real < bs and self.pad_last:
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - real)])
            samples = [self.dataset[int(i)] for i in idx]
            batch = self.collate_fn(samples)
            batch["_real_count"] = real
            yield batch


def _default_collate(samples: List[dict]) -> dict:
    keys = samples[0].keys()
    out = {}
    for k in keys:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out
