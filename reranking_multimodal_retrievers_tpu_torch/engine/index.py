"""Device-resident token indexes for exact late-interaction retrieval (port
of ``engine/index.py`` on one device: ``TokenIndex``, ``QuantizedTokenIndex``
and ``encode_corpus``).

TokenIndex layout:
  embeddings [N_pad, L_d, dim]  bf16, L2-normalised rows, zero-padded
  mask       [N_pad, L_d]       bool (skiplist/pad mask from the doc encoder)
  doc_ids    list[str]          host-side id table (N entries, N <= N_pad)

QuantizedTokenIndex holds int8 ``codes`` of the same shape and one fp32
scale per doc in place of the embeddings.

Over a mesh (``parallel/``) the doc axis is padded with whole-padding docs to
a multiple of the data size and every rank holds its contiguous block of
``N_pad / n_data`` docs (the JAX package's ``P(DATA_AXIS)``): ``embeddings``
(or ``codes``, ``scales``) and ``mask`` are the rank's rows, ``doc_ids`` the
whole table and ``num_padded_docs`` the global count, so global doc ids are
the JAX package's. ``load`` reads only the rank's rows; ``encode_corpus``
encodes only the batches that hold them.

``save``/``load`` use the JAX package's on-disk format, so a directory one
package writes the other reads: ``embeddings.npy`` (fp16) or ``codes.npy`` +
``scales.npy``, ``mask.npy`` packed with ``np.packbits`` along the token
axis, and ``meta.json`` with the doc ids and the shape.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.quant import symmetric_scale
from ..parallel.mesh import Mesh, all_gather

QUANTIZE_SLAB_DOCS = 4096  # docs quantized at a time by from_token_index


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def padded_count(n: int, mesh: Optional[Mesh], pad_multiple: Optional[int] = None) -> int:
    """The padded doc count of ``n`` docs: a multiple of ``pad_multiple``
    (the data size by default, as the JAX package pads) and of the data
    size, so that the doc axis shards evenly."""
    n_shards = mesh.n_data if mesh is not None else 1
    multiple = math.lcm(pad_multiple or n_shards, n_shards)
    return -(-n // multiple) * multiple


def shard_block(n_padded: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """``[start, stop)`` of the rank's contiguous block of ``n_padded`` docs."""
    if mesh is None:
        return 0, n_padded
    step = n_padded // mesh.n_data
    return mesh.data_index * step, (mesh.data_index + 1) * step


def _block_rows(x, n: int, n_padded: int, mesh: Optional[Mesh], fill=0):
    """Rows ``[start, stop)`` of the rank's block of ``x`` (``n`` real rows,
    numpy, memory-mapped or a tensor) as a tensor, rows of ``fill`` past
    ``n``."""
    a, b = shard_block(n_padded, mesh)
    t = x[a:min(b, n)]
    if not isinstance(t, torch.Tensor):  # a copy: memory-mapped rows are read-only
        t = torch.as_tensor(np.array(t))
    pad = (b - a) - t.shape[0]
    if pad == 0:
        return t
    return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), fill)])


def _save_mask(path: str, mask: torch.Tensor) -> None:
    np.save(os.path.join(path, "mask.npy"), _packed(mask))


def _packed(mask: torch.Tensor) -> np.ndarray:
    return np.packbits(mask.cpu().numpy(), axis=-1)


def _save_blocks(path: str, mesh: Mesh, blocks, meta: dict) -> None:
    """Write a sharded index as one directory, with no rank holding more
    than its own block: rank 0 makes each ``<name>.npy`` at its whole shape
    (``N_pad`` rows) and ``meta.json``, then every rank of the first model
    index writes its rows of each file through a memory map. ``blocks``:
    ``name -> the rank's rows`` (numpy)."""
    from numpy.lib.format import open_memmap

    n_padded = meta["shape"][0]
    if mesh.is_main:
        os.makedirs(path, exist_ok=True)
        for name, block in blocks.items():
            open_memmap(os.path.join(path, f"{name}.npy"), mode="w+", dtype=block.dtype,
                        shape=(n_padded,) + block.shape[1:]).flush()
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    mesh.barrier()
    if mesh.model_index == 0:
        a, b = shard_block(n_padded, mesh)
        for name, block in blocks.items():
            out = open_memmap(os.path.join(path, f"{name}.npy"), mode="r+")
            out[a:b] = block
            out.flush()
            del out
    mesh.barrier()


def _gather_to_host(tensors, mesh: Mesh, slab: int):
    """The whole of each rank's block of ``tensors`` (all of one row count),
    in host memory on every rank, in rank order: gathered ``slab`` rows of
    each rank at a time, so that no card holds more than its block and one
    slab from each rank."""
    g, W, n = mesh.data_group, mesh.n_data, tensors[0].shape[0]
    outs = [torch.empty((W, n) + tuple(t.shape[1:]), dtype=t.dtype) for t in tensors]
    for s in range(0, n, slab):
        e = min(s + slab, n)
        for t, out in zip(tensors, outs):
            part = all_gather(t[s:e].contiguous(), g)
            out[:, s:e] = part.view((W, e - s) + tuple(t.shape[1:])).cpu()
    return [out.view((W * n,) + tuple(out.shape[2:])) for out in outs]


def load_meta_and_mask(path: str, mmap: bool = False):
    """``meta.json`` and the unpacked bool mask of a saved index directory;
    with ``mmap``, the mask is a lazy view that unpacks only the rows it is
    sliced to."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    packed = np.load(os.path.join(path, "mask.npy"), mmap_mode="r" if mmap else None)
    if mmap:
        return meta, _PackedMask(packed, meta["shape"][1])
    mask = np.unpackbits(packed, axis=-1)[:, :meta["shape"][1]].astype(bool)
    return meta, mask


class _PackedMask:
    """A memory-mapped packed mask that unpacks the rows it is sliced to."""

    def __init__(self, packed, L: int):
        self.packed, self.L = packed, L

    def __len__(self):
        return len(self.packed)

    def __getitem__(self, rows):
        return np.unpackbits(self.packed[rows], axis=-1)[:, :self.L].astype(bool)


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
    embeddings: torch.Tensor  # [N_pad, L_d, dim] bf16 (the rank's block over a mesh)
    mask: torch.Tensor  # [N_pad, L_d] bool
    doc_ids: List[str]
    mesh: Optional[Mesh] = None

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def num_padded_docs(self) -> int:
        """The global padded doc count."""
        return int(self.embeddings.shape[0]) * (self.mesh.n_data if self.mesh else 1)

    def gathered(self) -> "TokenIndex":
        """The whole index in every rank's host memory, as the JAX package
        reads a sharded index into one numpy array (itself without a
        mesh)."""
        if self.mesh is None or self.mesh.n_data == 1:
            return self
        emb, mask = _gather_to_host([self.embeddings, self.mask], self.mesh,
                                    QUANTIZE_SLAB_DOCS)
        return TokenIndex(emb, mask, self.doc_ids)

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
                    pad_multiple: Optional[int] = None,
                    mesh: Optional[Mesh] = None) -> "TokenIndex":
        """Build an index on ``device`` (the mesh's device, with a mesh) from
        numpy arrays or tensors: the doc axis is zero-padded to a multiple of
        ``pad_multiple`` (padding docs have an all-False mask), embeddings
        are stored in bf16. With ``mesh``, the rank keeps its block."""
        if mesh is not None:
            n = len(embeddings)
            n_pad = padded_count(n, mesh, pad_multiple)
            embeddings = _block_rows(embeddings, n, n_pad, mesh)
            mask = _block_rows(mask, n, n_pad, mesh)
            device, pad_multiple = mesh.device, None
        dev = resolve_device(device)
        emb = torch.as_tensor(embeddings).to(device=dev, dtype=torch.bfloat16)
        msk = torch.as_tensor(mask).to(device=dev, dtype=torch.bool)
        if pad_multiple:
            emb, msk = _pad_rows(emb, pad_multiple), _pad_rows(msk, pad_multiple)
        return cls(embeddings=emb.contiguous(), mask=msk.contiguous(), doc_ids=list(doc_ids),
                   mesh=mesh)

    def save(self, path: str) -> None:
        """Write the index (the whole of it: over a mesh each rank writes
        its block into the one directory)."""
        emb = self.embeddings.cpu().to(torch.float16).numpy()
        meta = {"doc_ids": self.doc_ids, "shape": [self.num_padded_docs, *emb.shape[1:]],
                "dtype": str(emb.dtype)}
        if self.mesh is not None and self.mesh.n_data > 1:
            _save_blocks(path, self.mesh, {"embeddings": emb, "mask": _packed(self.mask)}, meta)
            return
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "embeddings.npy"), emb)
        _save_mask(path, self.mask)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda",
             mesh: Optional[Mesh] = None) -> "TokenIndex":
        """Read a saved index; with ``mesh``, only the rank's rows."""
        meta, mask = load_meta_and_mask(path, mmap=mesh is not None)
        emb = np.load(os.path.join(path, "embeddings.npy"),
                      mmap_mode="r" if mesh is not None else None)
        return cls.from_arrays(emb, mask, meta["doc_ids"], device=device, mesh=mesh)


@dataclass
class QuantizedTokenIndex:
    """Flat int8 token index with one symmetric scale per doc: half the
    device memory of :class:`TokenIndex`, scored by kernel K3
    (``ops/maxsim_int8_cuda.py``), which applies the doc scale after the
    token max."""

    codes: torch.Tensor  # [N_pad, L_d, dim] int8 (the rank's block over a mesh)
    scales: torch.Tensor  # [N_pad] fp32
    mask: torch.Tensor  # [N_pad, L_d] bool
    doc_ids: List[str]
    mesh: Optional[Mesh] = None

    @property
    def num_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def num_padded_docs(self) -> int:
        """The global padded doc count."""
        return int(self.codes.shape[0]) * (self.mesh.n_data if self.mesh else 1)

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
                    pad_multiple: Optional[int] = None,
                    mesh: Optional[Mesh] = None) -> "QuantizedTokenIndex":
        """Quantize float doc embeddings (numpy arrays or tensors) into
        per-doc-scaled int8 codes on ``device``; the doc axis is zero-padded
        to a multiple of ``pad_multiple``. With ``mesh``, the rank quantizes
        and keeps its block (the scales are per doc: the same codes)."""
        if mesh is not None:
            n = len(embeddings)
            n_pad = padded_count(n, mesh, pad_multiple)
            embeddings = _block_rows(embeddings, n, n_pad, mesh)
            mask = _block_rows(mask, n, n_pad, mesh)
            device, pad_multiple = mesh.device, None
        dev = resolve_device(device)
        emb = torch.as_tensor(embeddings).to(device=dev, dtype=torch.float32)
        msk = torch.as_tensor(mask).to(device=dev, dtype=torch.bool)
        if pad_multiple:
            emb, msk = _pad_rows(emb, pad_multiple), _pad_rows(msk, pad_multiple)
        codes, scales = quantize_docs(emb, msk)
        return cls(codes=codes, scales=scales, mask=msk.contiguous(), doc_ids=list(doc_ids),
                   mesh=mesh)

    @classmethod
    def from_token_index(cls, index: TokenIndex) -> "QuantizedTokenIndex":
        """Quantize ``index`` on its own device, ``QUANTIZE_SLAB_DOCS`` docs at
        a time, so no fp32 copy of the whole index exists and nothing crosses
        to the host. Keeps the index's padded shape, and its mesh (each rank
        quantizes its block)."""
        emb, msk = index.embeddings, index.mask
        n, slab = emb.shape[0], QUANTIZE_SLAB_DOCS
        codes = torch.empty(emb.shape, dtype=torch.int8, device=emb.device)
        scales = torch.empty(n, dtype=torch.float32, device=emb.device)
        with torch.inference_mode():
            for s in range(0, n, slab):
                codes[s:s + slab], scales[s:s + slab] = quantize_docs(
                    emb[s:s + slab], msk[s:s + slab])
        return cls(codes=codes, scales=scales, mask=msk, doc_ids=list(index.doc_ids),
                   mesh=index.mesh)

    def save(self, path: str) -> None:
        """Write the index (over a mesh, each rank its block into the one
        directory)."""
        meta = {"doc_ids": self.doc_ids,
                "shape": [self.num_padded_docs, *self.codes.shape[1:]]}
        if self.mesh is not None and self.mesh.n_data > 1:
            _save_blocks(path, self.mesh, {"codes": self.codes.cpu().numpy(),
                                           "scales": self.scales.cpu().numpy(),
                                           "mask": _packed(self.mask)}, meta)
            return
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "codes.npy"), self.codes.cpu().numpy())
        np.save(os.path.join(path, "scales.npy"), self.scales.cpu().numpy())
        _save_mask(path, self.mask)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda",
             mesh: Optional[Mesh] = None) -> "QuantizedTokenIndex":
        """Read a saved index; with ``mesh``, only the rank's rows (padding
        rows beyond the saved ones get zero codes and an all-zero doc's
        scale, as ``quantize_docs`` gives them)."""
        mmap = "r" if mesh is not None else None
        meta, mask = load_meta_and_mask(path, mmap=mesh is not None)
        codes = np.load(os.path.join(path, "codes.npy"), mmap_mode=mmap)
        scales = np.load(os.path.join(path, "scales.npy"), mmap_mode=mmap)
        if mesh is not None:
            n = len(codes)
            n_pad = padded_count(n, mesh)
            codes, mask = (_block_rows(x, n, n_pad, mesh) for x in (codes, mask))
            scales = _block_rows(scales, n, n_pad, mesh,
                                 fill=float(symmetric_scale(torch.zeros(1))[0]))
            device = mesh.device
        dev = resolve_device(device)
        return cls(codes=torch.as_tensor(codes).to(dev).contiguous(),
                   scales=torch.as_tensor(scales).to(dev).contiguous(),
                   mask=torch.as_tensor(mask).to(dev), doc_ids=meta["doc_ids"], mesh=mesh)


def batch_rows(batch) -> int:
    """The row count of a batch: of its first array (a dict's first value,
    a tuple's first element)."""
    while isinstance(batch, (dict, list, tuple)):
        batch = next(iter(batch.values())) if isinstance(batch, dict) else batch[0]
    return int(batch.shape[0])


def encode_corpus(doc_encode_fn: Callable, batches: Iterable, doc_ids: Sequence[str],
                  device: DeviceLike = "cuda",
                  pad_multiple: Optional[int] = None,
                  mesh: Optional[Mesh] = None) -> TokenIndex:
    """Encode a corpus into a :class:`TokenIndex` on ``device``.

    ``doc_encode_fn(batch) -> (embeddings [B, L_d, dim], mask [B, L_d])``;
    the tail batch may be padded, rows past ``len(doc_ids)`` are dropped. As
    in the JAX package, embeddings pass through fp16 on their way to the bf16
    index. With ``mesh`` each rank encodes only the batches (consecutive
    docs from 0) that hold rows of its block and keeps those rows; a rank
    whose block is padding only encodes the last batch for the row shape."""
    n = len(doc_ids)
    dev = resolve_device(mesh.device if mesh is not None else device)
    a, b = shard_block(padded_count(n, mesh, pad_multiple), mesh)
    embs, masks = [], []
    start, first, batch = 0, None, None
    with torch.inference_mode():
        for batch in batches:
            rows = batch_rows(batch) if mesh is not None else 0
            if mesh is None or (start < min(b, n) and start + rows > a):
                first = start if first is None else first
                e, m = doc_encode_fn(batch)
                embs.append(torch.as_tensor(e).to(dev).to(torch.float16))
                masks.append(torch.as_tensor(m).to(dev).bool())
            start += rows
        if mesh is not None and first is None:
            e, m = doc_encode_fn(batch)
            embs.append(torch.as_tensor(e).to(dev).to(torch.float16)[:0])
            masks.append(torch.as_tensor(m).to(dev).bool()[:0])
            first = a
    if mesh is None:
        return TokenIndex.from_arrays(torch.cat(embs)[:n], torch.cat(masks)[:n], doc_ids,
                                      device=dev, pad_multiple=pad_multiple)
    keep = slice(a - first, max(min(b, n), a) - first)
    emb, msk = torch.cat(embs)[keep].to(torch.bfloat16), torch.cat(masks)[keep]
    # padding docs past the corpus fill the block
    return TokenIndex(embeddings=_block_rows(emb, len(emb), b - a, None).contiguous(),
                      mask=_block_rows(msk, len(msk), b - a, None).contiguous(),
                      doc_ids=list(doc_ids), mesh=mesh)
