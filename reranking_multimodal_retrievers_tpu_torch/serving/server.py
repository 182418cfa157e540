"""Serving layer: micro-batching over the port's device programs (port of
``serving/server.py``).

- :class:`MicroBatcher` coalesces single-item requests: callers submit items
  and block on a Future; a worker thread groups up to ``max_batch`` items
  (waiting at most ``max_wait_ms`` for stragglers), runs one batch and hands
  each caller its own result.
- :class:`RerankService`: one query's K candidates per request; the worker
  pads the group to ``max_batch`` queries and runs one chunked
  ``[B*K, L]`` rerank forward (``engine/rerank_eval.py``).
- :class:`RetrievalService`: one query's token matrix per request; the
  worker batches them into the exact-MaxSim search program over a bf16
  ``TokenIndex`` or an int8 ``QuantizedTokenIndex``.

Every service owns a worker thread: call ``close()`` when done, or the
thread keeps polling.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, List

import torch

from ..device import DeviceLike, resolve_device


class MicroBatcher:
    """Coalesce single-item requests into batches.

    Args:
      run_batch: ``fn(items: list) -> list``, called on the worker thread
        with 1..max_batch items; returns one result per item.
      max_batch: the largest group per call.
      max_wait_ms: how long the first request of a group waits for more.
    """

    def __init__(self, run_batch: Callable[[List[Any]], List[Any]],
                 max_batch: int = 8, max_wait_ms: float = 2.0):
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # serialises submit()'s stop-check + enqueue against close()'s
        # stop-set + drain, so no Future is left unresolved
        self._submit_lock = threading.Lock()
        self.batch_sizes = deque(maxlen=4096)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, item: Any) -> "Future":
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("MicroBatcher is closed")
            fut: Future = Future()
            self._q.put((item, fut))
        return fut

    def __call__(self, item: Any) -> Any:
        return self.submit(item).result()

    def close(self):
        """Stop the worker and fail any still-queued requests."""
        with self._submit_lock:
            self._stop.set()
        self._worker.join(timeout=5)
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("MicroBatcher closed"))

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            group = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(group) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    group.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            items = [it for it, _ in group]
            futs = [f for _, f in group]
            self.batch_sizes.append(len(items))
            try:
                results = self.run_batch(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for {len(items)} items")
                for f, r in zip(futs, results):
                    f.set_result(r)
            except Exception as e:  # a boundary that must keep serving:
                for f in futs:      # every caller gets the error
                    if not f.done():
                        f.set_exception(e)


class RerankService:
    """Candidate reranking behind a micro-batcher.

    ``rerank_fn(input_ids, attention_mask, token_type_ids, pixel) -> [B, K]``
    is the chunked rerank program (``engine.make_chunked_rerank_fn``);
    requests are one query's ``[K, L]`` rows, padded up to ``max_batch``
    queries. Inputs are moved to ``device`` (CUDA by default)."""

    def __init__(self, rerank_fn, nway: int, max_batch: int = 8,
                 max_wait_ms: float = 2.0, device: DeviceLike = "cuda"):
        self.rerank_fn = rerank_fn
        self.nway = nway
        self.max_batch = max_batch
        self.device = resolve_device(device)
        self.batcher = MicroBatcher(self._run, max_batch, max_wait_ms)

    def rerank(self, input_ids, attention_mask, token_type_ids=None,
               pixel_values=None) -> "Future":
        """One query's K candidates -> Future of ``[K]`` fp32 logits (numpy)."""
        if input_ids.shape[0] != self.nway:
            raise ValueError(f"expected {self.nway} candidate rows, got {tuple(input_ids.shape)}")
        return self.batcher.submit(
            (torch.as_tensor(input_ids), torch.as_tensor(attention_mask),
             None if token_type_ids is None else torch.as_tensor(token_type_ids),
             None if pixel_values is None else torch.as_tensor(pixel_values)))

    def _run(self, items):
        # a group may mix requests with and without pixel_values; zero images
        # are not "no image", so each kind runs as its own batch
        with_pix = [i for i, it in enumerate(items) if it[3] is not None]
        without = [i for i, it in enumerate(items) if it[3] is None]
        if with_pix and without:
            out = [None] * len(items)
            for idxs in (with_pix, without):
                res = self._run_group([items[i] for i in idxs])
                for j, i in enumerate(idxs):
                    out[i] = res[j]
            return out
        return self._run_group(items)

    def _run_group(self, items):
        n = len(items)
        pad = self.max_batch - n  # static geometry: always the full batch
        dev = self.device
        ids = torch.cat([it[0] for it in items])
        am = torch.cat([it[1] for it in items])
        tt = torch.cat([it[2] if it[2] is not None else torch.zeros_like(it[0])
                        for it in items])
        if pad:
            rows = pad * self.nway
            ids, am, tt = (torch.cat([x, x.new_zeros((rows,) + tuple(x.shape[1:]))])
                           for x in (ids, am, tt))
        pix = None
        if items[0][3] is not None:
            shapes = {tuple(it[3].shape) for it in items}
            if len(shapes) > 1:
                raise ValueError(f"mixed pixel_values shapes in one batch group: {shapes}")
            pix = torch.stack([it[3] for it in items])
            if pad:
                pix = torch.cat([pix, pix.new_zeros((pad,) + tuple(pix.shape[1:]))])
            pix = pix.to(dev)
        logits = self.rerank_fn(ids.to(dev), am.to(dev), tt.to(dev), pix)
        logits = logits.float().cpu().numpy().reshape(self.max_batch, self.nway)
        return [logits[i] for i in range(n)]

    def close(self):
        self.batcher.close()


class RetrievalService:
    """Exact-MaxSim retrieval behind a micro-batcher.

    ``search_fn(Q, *index.search_arrays) -> (values, indices)`` is the
    index's search program: ``engine.make_search_fn`` for a ``TokenIndex``,
    ``engine.make_search_fn_int8`` for a ``QuantizedTokenIndex``. Requests
    are one query's ``[L_q, dim]`` token matrix, batched up to
    ``batch_queries`` and cast to ``index.query_dtype``."""

    def __init__(self, search_fn, index, batch_queries: int = 8,
                 max_wait_ms: float = 2.0):
        self.search_fn = search_fn
        self.index = index
        self.B = batch_queries
        self.batcher = MicroBatcher(self._run, batch_queries, max_wait_ms)

    def search(self, Q) -> "Future":
        """One query's ``[L_q, dim]`` matrix -> Future of
        ``(doc_ids list, scores [k] numpy)``."""
        return self.batcher.submit(torch.as_tensor(Q))

    def _run(self, items):
        n = len(items)
        index = self.index
        Q = torch.stack([q.to(device=index.mask.device, dtype=index.query_dtype)
                         for q in items])
        if n < self.B:
            Q = torch.cat([Q, Q.new_zeros((self.B - n,) + tuple(Q.shape[1:]))])
        vals, idx = self.search_fn(Q, *index.search_arrays)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        n_docs = len(self.index.doc_ids)
        return [([self.index.doc_ids[j] for j in idx[i] if j < n_docs], vals[i])
                for i in range(n)]

    def close(self):
        self.batcher.close()
