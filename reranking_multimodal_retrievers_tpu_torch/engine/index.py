"""Device-resident token index for exact late-interaction retrieval (port of
``engine/index.py``: ``TokenIndex`` on one device, and ``encode_corpus``).

Layout:
  embeddings [N_pad, L_d, dim]  bf16, L2-normalised rows, zero-padded
  mask       [N_pad, L_d]       bool (skiplist/pad mask from the doc encoder)
  doc_ids    list[str]          host-side id table (N entries, N <= N_pad)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


@dataclass
class TokenIndex:
    embeddings: torch.Tensor  # [N_pad, L_d, dim] bf16
    mask: torch.Tensor  # [N_pad, L_d] bool
    doc_ids: List[str]

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def num_padded_docs(self) -> int:
        return int(self.embeddings.shape[0])

    @property
    def doc_maxlen(self) -> int:
        return int(self.embeddings.shape[1])

    @property
    def dim(self) -> int:
        return int(self.embeddings.shape[2])

    @classmethod
    def from_arrays(cls, embeddings, mask, doc_ids: Sequence[str],
                    device: DeviceLike = "cuda",
                    pad_multiple: Optional[int] = None) -> "TokenIndex":
        """Build an index on ``device`` from numpy arrays or tensors: the doc
        axis is zero-padded to a multiple of ``pad_multiple`` (padding docs
        have an all-False mask), embeddings are stored in bf16."""
        dev = resolve_device(device)
        emb = torch.as_tensor(embeddings).to(device=dev, dtype=torch.bfloat16)
        msk = torch.as_tensor(mask).to(device=dev, dtype=torch.bool)
        if pad_multiple:
            emb, msk = _pad_rows(emb, pad_multiple), _pad_rows(msk, pad_multiple)
        return cls(embeddings=emb.contiguous(), mask=msk.contiguous(), doc_ids=list(doc_ids))


def encode_corpus(doc_encode_fn: Callable, batches: Iterable, doc_ids: Sequence[str],
                  device: DeviceLike = "cuda",
                  pad_multiple: Optional[int] = None) -> TokenIndex:
    """Encode a corpus into a :class:`TokenIndex` on ``device``.

    ``doc_encode_fn(batch) -> (embeddings [B, L_d, dim], mask [B, L_d])``;
    the tail batch may be padded, rows past ``len(doc_ids)`` are dropped. As
    in the JAX package, embeddings pass through fp16 on their way to the bf16
    index."""
    dev = resolve_device(device)
    embs, masks = [], []
    with torch.inference_mode():
        for batch in batches:
            e, m = doc_encode_fn(batch)
            embs.append(torch.as_tensor(e).to(dev).to(torch.float16))
            masks.append(torch.as_tensor(m).to(dev).bool())
    n = len(doc_ids)
    return TokenIndex.from_arrays(torch.cat(embs)[:n], torch.cat(masks)[:n], doc_ids,
                                  device=dev, pad_multiple=pad_multiple)
