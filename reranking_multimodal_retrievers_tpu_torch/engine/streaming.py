"""Exact retrieval over a token index held in host RAM and streamed through
device memory slab by slab (port of ``engine/streaming.py``).

For corpora larger than device memory: the index stays in host RAM (or in a
memory-mapped ``TokenIndex.save`` directory) and every search streams it
through the card in slabs of ``slab_docs`` docs. On CUDA:

  host slab s+1 -> pinned staging buffer -> side-stream copy -> device buffer
  device buffer s -> K1/K3 per-slab top-k  (main stream)
  running top-k  -> exact [B, k] + [B, k] merge with ``torch.topk``

Two pinned staging buffers and two device buffers of one slab each hold the
data in flight, whatever the corpus size. CUDA events order the two streams:
a device buffer is refilled only after the scoring that read it, a staging
buffer only after the copy that read it, and a slab is scored only after its
copy. The copy of slab s+1 overlaps the scoring of slab s; filling a staging
buffer is a host memcpy that overlaps both.

The per-slab top-k + merge is the same two-stage reduction as a sharded
search, so the streamed values are those of the device-resident search over
the same index (the kernels give each doc the same value whatever slab it
is in). Tail-padding docs of the last slab come back as ``-inf`` / ``-1``.
On a CPU device the slabs are scored by the kernels' plain versions, with no
staging; that is how the tests run it.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .index import load_meta_and_mask, quantize_docs
from .search import _local_search, _local_search_int8, quantize_queries


@dataclass
class HostTokenIndex:
    """Host-RAM (or memory-mapped) token index. ``embeddings`` may be
    fp16 or fp32; slabs are cast to bf16 on the device. ``mask=None``
    declares every token of every doc real."""

    embeddings: np.ndarray  # [N, L_d, dim], host-resident
    mask: Optional[np.ndarray]  # [N, L_d] bool, or None (every token real)
    doc_ids: Optional[List[str]] = None

    @property
    def num_docs(self) -> int:
        return int(self.embeddings.shape[0])

    @property
    def doc_maxlen(self) -> int:
        return int(self.embeddings.shape[1])

    @property
    def dim(self) -> int:
        return int(self.embeddings.shape[2])

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "HostTokenIndex":
        """Open a ``TokenIndex.save`` directory without reading the
        embeddings into memory (``mmap=True``): slab reads go through the
        page cache."""
        meta, mask = load_meta_and_mask(path)
        emb = np.load(os.path.join(path, "embeddings.npy"), mmap_mode="r" if mmap else None)
        return cls(embeddings=emb, mask=mask, doc_ids=meta["doc_ids"])


@dataclass
class HostQuantizedTokenIndex:
    """Int8 host index with one symmetric scale per doc (the layout of
    ``QuantizedTokenIndex``): half the host RAM and half the bytes over the
    host link, scored by kernel K3."""

    codes: np.ndarray  # [N, L_d, dim] int8
    scales: np.ndarray  # [N] fp32
    mask: Optional[np.ndarray]  # [N, L_d] bool or None
    doc_ids: Optional[List[str]] = None

    @property
    def num_docs(self) -> int:
        return int(self.codes.shape[0])

    @property
    def doc_maxlen(self) -> int:
        return int(self.codes.shape[1])

    @property
    def dim(self) -> int:
        return int(self.codes.shape[2])

    @classmethod
    def from_host_index(cls, index: HostTokenIndex,
                        slab_docs: int = 16384) -> "HostQuantizedTokenIndex":
        """Quantize on the host, ``slab_docs`` docs at a time (bounded peak
        memory), with the same codes and scales as ``QuantizedTokenIndex``."""
        n = index.num_docs
        codes = np.empty(index.embeddings.shape, np.int8)
        scales = np.empty((n,), np.float32)
        for s in range(0, n, slab_docs):
            e = _as_tensor(index.embeddings[s:s + slab_docs])
            m = (torch.ones(e.shape[:2], dtype=torch.bool) if index.mask is None
                 else _as_tensor(index.mask[s:s + slab_docs]))
            c, sc = quantize_docs(e, m)
            codes[s:s + slab_docs] = c.numpy()
            scales[s:s + slab_docs] = sc.numpy()
        return cls(codes=codes, scales=scales, mask=index.mask, doc_ids=index.doc_ids)


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a`` without a copy. Read-only arrays (a
    memory-mapped index) are only ever read through it."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.asarray(a))


class StreamingSearcher:
    """Exact top-k search over a host-resident index (``HostTokenIndex`` or
    ``HostQuantizedTokenIndex``), streamed through one device per search.

    The staging and device buffers are allocated at the first search on a
    CUDA device and kept for the next ones. ``last_fill_seconds`` holds the
    host time the last search spent copying slabs into staging buffers."""

    def __init__(self, index, k: int = 100, slab_docs: int = 16384,
                 device: DeviceLike = "cuda"):
        self.index = index
        self.k = k
        self.slab_docs = int(slab_docs)
        self.device = resolve_device(device)
        self._quantized = isinstance(index, HostQuantizedTokenIndex)
        self._n_slabs = -(-index.num_docs // self.slab_docs)
        self._k_slab = min(k, self.slab_docs)
        self._buffers = None
        self.last_fill_seconds = 0.0

    # ---------------------------------------------------------------- slabs
    def _slab_specs(self):
        """(dtype, shape) of each array a slab carries: the codes and scales
        (int8 index) or the embeddings, then the mask."""
        idx, S = self.index, self.slab_docs
        if self._quantized:
            arrays = [(torch.int8, (S, idx.doc_maxlen, idx.dim)), (torch.float32, (S,))]
        else:
            dtype = _as_tensor(idx.embeddings[:0]).dtype
            arrays = [(dtype, (S, idx.doc_maxlen, idx.dim))]
        return arrays + [(torch.bool, (S, idx.doc_maxlen))]

    def _fill(self, dst, s: int) -> None:
        """Write slab ``s`` into the CPU tensors ``dst``, tail-padded with
        zero docs whose mask is all False (and scale 0, as in the JAX
        package)."""
        idx = self.index
        lo = s * self.slab_docs
        hi = min(lo + self.slab_docs, idx.num_docs)
        n = hi - lo
        host = [idx.codes, idx.scales] if self._quantized else [idx.embeddings]
        for t, a in zip(dst, host):
            t[:n].copy_(_as_tensor(a[lo:hi]))
            t[n:].zero_()
        mask = dst[-1]
        if idx.mask is None:
            mask[:n] = True
        else:
            mask[:n].copy_(_as_tensor(idx.mask[lo:hi]))
        mask[n:] = False

    def _score(self, q_args, slab):
        """Per-slab top-k ``(values [B, k_slab], indices [B, k_slab])``."""
        if self._quantized:
            return _local_search_int8(*q_args, *slab, k=self._k_slab)
        emb, mask = slab
        return _local_search(q_args[0], emb.to(torch.bfloat16), mask, k=self._k_slab)

    # --------------------------------------------------------------- search
    def search(self, Q) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k of every query against the whole host corpus.

        Args:
          Q: [B, L_q, dim] float query token matrices (numpy or tensor).
        Returns:
          (scores [B, k] fp32, doc positions [B, k] int64, as numpy; with
          k > num_docs the tail is -inf / -1).
        """
        Q = torch.as_tensor(Q).to(self.device)
        B = Q.shape[0]
        with torch.inference_mode():
            if self._quantized:
                q_args = quantize_queries(Q.float())
            else:
                q_args = (Q.to(torch.bfloat16),)
            best_v = torch.full((B, self.k), float("-inf"), device=self.device)
            best_i = torch.full((B, self.k), -1, dtype=torch.int64, device=self.device)
            slabs = (self._stream_cuda() if self.device.type == "cuda"
                     else self._stream_cpu())
            for s, slab, done in slabs:
                vals, idx = self._score(q_args, slab)
                cat_v = torch.cat([best_v, vals], dim=1)
                cat_i = torch.cat([best_i, idx + s * self.slab_docs], dim=1)
                best_v, pos = torch.topk(cat_v, self.k, dim=1)
                best_i = torch.gather(cat_i, 1, pos)
                done()
            vals, idx = best_v.cpu().numpy(), best_i.cpu().numpy()
        # positions past num_docs (tail padding, or k > num_docs) get the
        # -inf / -1 convention. A tail doc (all-False mask) totals about
        # -9999 * L_q, bf16 or int8, and only follows real docs
        bad = (idx < 0) | (idx >= self.index.num_docs)
        return np.where(bad, -np.inf, vals).astype(np.float32), np.where(bad, -1, idx)

    def search_ids(self, Q):
        """Like :meth:`search` but maps positions to ``doc_ids``."""
        vals, idx = self.search(Q)
        ids = [[self.index.doc_ids[j] for j in row if j >= 0] for row in idx]
        return ids, vals

    def _stream_cpu(self):
        """Yield ``(s, slab tensors, done)`` for each slab, on the CPU."""
        fill_s = 0.0
        for s in range(self._n_slabs):
            t0 = time.perf_counter()
            slab = [torch.empty(shape, dtype=dt) for dt, shape in self._slab_specs()]
            self._fill(slab, s)
            fill_s += time.perf_counter() - t0
            yield s, slab, lambda: None
        self.last_fill_seconds = fill_s

    def _stream_cuda(self):
        """Yield ``(s, device slab tensors, done)`` for each slab, double
        buffered; the caller enqueues the slab's scoring on the current
        stream and then calls ``done()``."""
        if self._buffers is None:
            specs = self._slab_specs()
            self._buffers = dict(
                staging=[[torch.empty(shape, dtype=dt, pin_memory=True) for dt, shape in specs]
                         for _ in range(2)],
                device=[[torch.empty(shape, dtype=dt, device=self.device) for dt, shape in specs]
                        for _ in range(2)],
                side=torch.cuda.Stream(self.device))
        staging, dev, side = (self._buffers[n] for n in ("staging", "device", "side"))
        main = torch.cuda.current_stream(self.device)
        copied = [torch.cuda.Event() for _ in range(2)]  # copy from staging[i] to dev[i] done
        scored = [torch.cuda.Event() for _ in range(2)]  # scoring of dev[i] done
        fill_s = 0.0

        def prefetch(s):
            nonlocal fill_s
            i = s % 2
            copied[i].synchronize()  # the previous copy out of staging[i] has ended
            t0 = time.perf_counter()
            self._fill(staging[i], s)
            fill_s += time.perf_counter() - t0
            side.wait_event(scored[i])  # dev[i] is no longer being read
            with torch.cuda.stream(side):
                for d, h in zip(dev[i], staging[i]):
                    d.copy_(h, non_blocking=True)
                copied[i].record(side)

        prefetch(0)
        for s in range(self._n_slabs):
            i = s % 2
            main.wait_event(copied[i])

            def done(i=i, s=s):
                scored[i].record(main)
                if s + 1 < self._n_slabs:
                    prefetch(s + 1)

            yield s, dev[i], done
        torch.cuda.current_stream(self.device).synchronize()
        self.last_fill_seconds = fill_s
