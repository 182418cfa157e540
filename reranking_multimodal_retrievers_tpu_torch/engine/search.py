"""Exact MaxSim search over a device-resident token index (port of
``engine/search.py`` on one device: ``_local_search``, ``_local_search_int8``,
``make_search_fn``, ``make_search_fn_int8``, ``search_exhaustive`` and
``Searcher``).

Scoring goes through kernel K1 (``ops/maxsim_cuda.py``) for a bf16
``TokenIndex`` and kernel K3 (``ops/maxsim_int8_cuda.py``) for an int8
``QuantizedTokenIndex``, over doc slabs, then ``torch.topk``. The JAX
package's Mosaic limits (the 2^23-token slab assert, the VMEM tile budget
and the %8/%128 alignment gate) do not apply: the kernels take any shape
(K3 any ``dim % 32 == 0``), and slabs only bound the size of one launch.

Over a mesh (``parallel/``) the index is sharded over the data axis
(``engine/index.py``): each rank searches its block through K1 or K3, offsets
its ids by its block's start, and the ranks' ``[B, k]`` values and ids are
all-gathered and merged in the JAX package's order (``[W, B, k] -> [B, W*k]``,
then a top-k that keeps the lower position first among equal values, as
``jax.lax.top_k`` does). Every rank ends with the same result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

from ..ops.maxsim import MASK_FILL_VALUE
from ..ops.maxsim_cuda import maxsim_scores
from ..ops.maxsim_int8_cuda import maxsim_scores_int8
from ..ops.quant import quantize_rows
from ..parallel.mesh import all_gather
from .index import QuantizedTokenIndex, TokenIndex

SLAB_DOCS = 32768  # docs scored per kernel launch


def _local_search(Q, D, M, *, k: int, score_dtype=torch.float32,
                  unpadded: bool = False):
    """Score every doc of ``D`` against the queries and return the top-k
    ``(values [B, k], indices [B, k])``.

    ``unpadded=True`` (every real doc has exactly L_d real tokens) drops the
    per-token mask from the kernel; whole-padding docs (all-False mask rows)
    are then kept out of the top-k by a per-doc pass. With the mask, K1
    already puts them at about ``-9999 * L_q``."""
    M_kernel = None if unpadded else M
    scores = torch.cat([
        maxsim_scores(Q, D[s:s + SLAB_DOCS],
                      None if M_kernel is None else M_kernel[s:s + SLAB_DOCS],
                      score_dtype=score_dtype)
        for s in range(0, D.shape[0], SLAB_DOCS)
    ], dim=1)
    return _top_k(scores, M, k, Q.shape[1], guard=unpadded)


def _top_k(scores, M, k: int, L_q: int, guard: bool):
    """Top-k of ``scores [B, N]``; under ``guard`` whole-padding docs first
    go through :func:`guard_padding_docs`."""
    if guard:
        scores = guard_padding_docs(scores, M, L_q)
    return torch.topk(scores, k, dim=1)


def guard_padding_docs(scores, M, L_q: int):
    """``scores [B, N]`` with every whole-padding doc (all-False row of
    ``M [N, L_d]``) set to ``MASK_FILL_VALUE * L_q``, so that it never
    outranks a real doc. That is exactly the JAX package's total for such a
    doc, whose masked token scores it replaces by -9999 where K1 adds
    -9999 to them."""
    return torch.where(M.any(dim=1)[None, :], scores,
                       torch.tensor(MASK_FILL_VALUE * L_q, device=scores.device))


def _local_search_int8(Qq, qs, Dq, ds, M, *, k: int, unpadded: bool = False):
    """Int8 variant of :func:`_local_search` over a QuantizedTokenIndex:
    ``Qq [B, L_q, dim]`` int8 with ``qs [B, L_q]`` fp32 scales against
    ``Dq [N, L_d, dim]`` int8 with ``ds [N]`` fp32 scales, through K3.

    Whole-padding docs are kept out of the top-k whatever ``unpadded`` is.
    This departs from the JAX package, which guards them only under
    ``unpadded``: a padding doc has zero codes, so its int8 total is about 0
    and would outrank real docs whose totals are negative."""
    M_kernel = None if unpadded else M
    scores = torch.cat([
        maxsim_scores_int8(Qq, qs, Dq[s:s + SLAB_DOCS], ds[s:s + SLAB_DOCS],
                           None if M_kernel is None else M_kernel[s:s + SLAB_DOCS])
        for s in range(0, Dq.shape[0], SLAB_DOCS)
    ], dim=1)
    return _top_k(scores, M, k, Qq.shape[1], guard=True)


def quantize_queries(Q):
    """Float query matrices ``[B, L_q, dim]`` -> int8 codes and per-token
    fp32 scales ``[B, L_q]`` (symmetric per row, ``ops/quant.py``)."""
    Qq, qscale = quantize_rows(Q)
    return Qq, qscale[..., 0].contiguous()


def _merge(vals, idx, k: int, mesh):
    """The global top-k from each rank's local ``(vals, idx)`` ``[B, k_l]``
    (global ids): gathered
    ``[W, B, k_l] -> [B, W*k_l]`` and ranked with a stable sort, so that
    equal values keep their gathered order (``jax.lax.top_k``'s)."""
    B = vals.shape[0]
    g = mesh.data_group
    all_vals = all_gather(vals[None], g).movedim(0, 1).reshape(B, -1)
    all_idx = all_gather(idx[None], g).movedim(0, 1).reshape(B, -1)
    top, pos = torch.sort(all_vals, dim=1, descending=True, stable=True)
    k = min(k, all_vals.shape[1])
    return top[:, :k], torch.gather(all_idx, 1, pos[:, :k])


def make_search_fn(n_padded_docs: int, k: int, score_dtype=torch.float32,
                   unpadded: bool = False, mesh=None):
    """The search program for an index of ``n_padded_docs`` docs:
    ``fn(Q, D, M) -> (values [B, k], indices [B, k])``. With ``mesh``,
    ``D`` and ``M`` are the rank's block of ``n_padded_docs / n_data`` docs,
    ``Q`` the same on every rank, and so is the result."""
    sharded = mesh is not None and mesh.n_data > 1
    n_local = n_padded_docs // mesh.n_data if sharded else n_padded_docs
    k_eff = min(k, n_local)

    def search_fn(Q, D, M):
        with torch.inference_mode():
            vals, idx = _local_search(Q, D, M, k=k_eff, score_dtype=score_dtype,
                                      unpadded=unpadded)
            if not sharded:
                return vals, idx
            return _merge(vals, idx + mesh.data_index * n_local, k, mesh)

    return search_fn


def make_search_fn_int8(n_padded_docs: int, k: int, unpadded: bool = False, mesh=None):
    """The search program for a QuantizedTokenIndex of ``n_padded_docs``
    docs: ``fn(Q, codes, scales, M) -> (values [B, k], indices [B, k])``
    with ``Q`` still float; its rows are quantized inside. ``mesh`` as in
    :func:`make_search_fn`."""
    sharded = mesh is not None and mesh.n_data > 1
    n_local = n_padded_docs // mesh.n_data if sharded else n_padded_docs
    k_eff = min(k, n_local)

    def search_fn(Q, Dq, ds, M):
        with torch.inference_mode():
            Qq, qs = quantize_queries(Q)
            vals, idx = _local_search_int8(Qq, qs, Dq, ds, M, k=k_eff, unpadded=unpadded)
            if not sharded:
                return vals, idx
            return _merge(vals, idx + mesh.data_index * n_local, k, mesh)

    return search_fn


AnyIndex = Union[TokenIndex, QuantizedTokenIndex]


def _program(index: AnyIndex, k: int):
    """A function that runs ``index``'s search program (int8 for a
    QuantizedTokenIndex, else bf16) on a batch of query matrices."""
    make = make_search_fn_int8 if isinstance(index, QuantizedTokenIndex) else make_search_fn
    fn = make(index.num_padded_docs, k, mesh=index.mesh)
    return lambda Q: fn(torch.as_tensor(Q).to(device=index.mask.device,
                                              dtype=index.query_dtype),
                        *index.search_arrays)


def search_exhaustive(index: AnyIndex, Q, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Search the index (bf16 or int8) with a batch of query matrices
    ``Q [B, L_q, dim]`` (masked rows zeroed). Returns ``(scores [B, k] fp32,
    doc_indices [B, k])`` as numpy."""
    vals, idx = _program(index, k)(Q)
    return vals.cpu().numpy(), idx.cpu().numpy()


@dataclass
class Searcher:
    """Hold an index (bf16 or int8) and its search program and map results
    to doc ids."""

    index: AnyIndex
    k: int = 100

    def __post_init__(self):
        self._search = _program(self.index, self.k)

    def search(self, Q, remove_zero_rows: bool = False):
        """Returns (doc_ids list[list[str]], scores [B, k] numpy).

        ``remove_zero_rows`` is accepted and ignored, as in the JAX package:
        all-zero query rows score 0 against every doc and move no ranking."""
        vals, idx = self._search(Q)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        n = self.index.num_docs
        ids = [[self.index.doc_ids[j] for j in row if j < n][: self.k] for row in idx]
        return ids, vals
