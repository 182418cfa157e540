"""Device-resident token indexes for exact late-interaction retrieval (port
of ``engine/index.py`` on one device: ``TokenIndex``, ``QuantizedTokenIndex``
and ``encode_corpus``).

TokenIndex layout:
  embeddings [N_pad, L_d, dim]  bf16, L2-normalised rows, zero-padded
  mask       [N_pad, L_d]       bool (skiplist/pad mask from the doc encoder)
  doc_ids    list[str]          host-side id table (N entries, N <= N_pad)

QuantizedTokenIndex holds int8 ``codes`` of the same shape and one fp32
scale per doc in place of the embeddings.

``save``/``load`` use the JAX package's on-disk format, so a directory one
package writes the other reads: ``embeddings.npy`` (fp16) or ``codes.npy`` +
``scales.npy``, ``mask.npy`` packed with ``np.packbits`` along the token
axis, and ``meta.json`` with the doc ids and the shape.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.quant import symmetric_scale

QUANTIZE_SLAB_DOCS = 4096  # docs quantized at a time by from_token_index


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _save_mask(path: str, mask: torch.Tensor) -> None:
    np.save(os.path.join(path, "mask.npy"), np.packbits(mask.cpu().numpy(), axis=-1))


def load_meta_and_mask(path: str):
    """``meta.json`` and the unpacked bool mask of a saved index directory."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    packed = np.load(os.path.join(path, "mask.npy"))
    mask = np.unpackbits(packed, axis=-1)[:, :meta["shape"][1]].astype(bool)
    return meta, mask


def quantize_docs(embeddings: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-doc symmetric int8 codes of ``embeddings [n, L_d, dim]`` (any float
    dtype) on their device: padding tokens are zeroed first, so they never
    set a scale; ``scale = max(amax, 1e-8) / 127`` in fp32 and codes round
    half to even, exactly as the JAX package's numpy code does. Returns
    ``(codes [n, L_d, dim] int8, scales [n] fp32)``."""
    e = torch.where(mask.bool()[..., None], embeddings.float(), 0.0)
    scales = symmetric_scale(e.abs().amax(dim=(1, 2)))
    codes = torch.round(e / scales[:, None, None]).clamp_(-127, 127).to(torch.int8)
    return codes, scales


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

    @property
    def query_dtype(self) -> torch.dtype:
        """The dtype the search program takes queries in."""
        return self.embeddings.dtype

    @property
    def search_arrays(self) -> Tuple[torch.Tensor, ...]:
        """The device arrays the search program takes after the queries."""
        return self.embeddings, self.mask

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

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        emb = self.embeddings.cpu().to(torch.float16).numpy()
        np.save(os.path.join(path, "embeddings.npy"), emb)
        _save_mask(path, self.mask)
        meta = {"doc_ids": self.doc_ids, "shape": list(emb.shape), "dtype": str(emb.dtype)}
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda") -> "TokenIndex":
        meta, mask = load_meta_and_mask(path)
        emb = np.load(os.path.join(path, "embeddings.npy"))
        return cls.from_arrays(emb, mask, meta["doc_ids"], device=device)


@dataclass
class QuantizedTokenIndex:
    """Flat int8 token index with one symmetric scale per doc: half the
    device memory of :class:`TokenIndex`, scored by kernel K3
    (``ops/maxsim_int8_cuda.py``), which applies the doc scale after the
    token max."""

    codes: torch.Tensor  # [N_pad, L_d, dim] int8
    scales: torch.Tensor  # [N_pad] fp32
    mask: torch.Tensor  # [N_pad, L_d] bool
    doc_ids: List[str]

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def num_padded_docs(self) -> int:
        return int(self.codes.shape[0])

    @property
    def doc_maxlen(self) -> int:
        return int(self.codes.shape[1])

    @property
    def dim(self) -> int:
        return int(self.codes.shape[2])

    @property
    def query_dtype(self) -> torch.dtype:
        """Queries stay float: the search program quantizes them."""
        return torch.float32

    @property
    def search_arrays(self) -> Tuple[torch.Tensor, ...]:
        """The device arrays the search program takes after the queries."""
        return self.codes, self.scales, self.mask

    @classmethod
    def from_arrays(cls, embeddings, mask, doc_ids: Sequence[str],
                    device: DeviceLike = "cuda",
                    pad_multiple: Optional[int] = None) -> "QuantizedTokenIndex":
        """Quantize float doc embeddings (numpy arrays or tensors) into
        per-doc-scaled int8 codes on ``device``; the doc axis is zero-padded
        to a multiple of ``pad_multiple``."""
        dev = resolve_device(device)
        emb = torch.as_tensor(embeddings).to(device=dev, dtype=torch.float32)
        msk = torch.as_tensor(mask).to(device=dev, dtype=torch.bool)
        if pad_multiple:
            emb, msk = _pad_rows(emb, pad_multiple), _pad_rows(msk, pad_multiple)
        codes, scales = quantize_docs(emb, msk)
        return cls(codes=codes, scales=scales, mask=msk.contiguous(), doc_ids=list(doc_ids))

    @classmethod
    def from_token_index(cls, index: TokenIndex) -> "QuantizedTokenIndex":
        """Quantize ``index`` on its own device, ``QUANTIZE_SLAB_DOCS`` docs at
        a time, so no fp32 copy of the whole index exists and nothing crosses
        to the host. Keeps the index's padded shape."""
        emb, msk = index.embeddings, index.mask
        n, slab = emb.shape[0], QUANTIZE_SLAB_DOCS
        codes = torch.empty(emb.shape, dtype=torch.int8, device=emb.device)
        scales = torch.empty(n, dtype=torch.float32, device=emb.device)
        with torch.inference_mode():
            for s in range(0, n, slab):
                codes[s:s + slab], scales[s:s + slab] = quantize_docs(
                    emb[s:s + slab], msk[s:s + slab])
        return cls(codes=codes, scales=scales, mask=msk, doc_ids=list(index.doc_ids))

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "codes.npy"), self.codes.cpu().numpy())
        np.save(os.path.join(path, "scales.npy"), self.scales.cpu().numpy())
        _save_mask(path, self.mask)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"doc_ids": self.doc_ids, "shape": list(self.codes.shape)}, f)

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda") -> "QuantizedTokenIndex":
        dev = resolve_device(device)
        meta, mask = load_meta_and_mask(path)
        codes = torch.as_tensor(np.load(os.path.join(path, "codes.npy"))).to(dev)
        scales = torch.as_tensor(np.load(os.path.join(path, "scales.npy"))).to(dev)
        return cls(codes=codes.contiguous(), scales=scales.contiguous(),
                   mask=torch.as_tensor(mask).to(dev), doc_ids=meta["doc_ids"])


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
