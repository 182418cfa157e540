"""Top-k selection over score rows (port of ``ops/topk.py``)."""

from __future__ import annotations

import torch


def top_k_scores(scores: torch.Tensor, k: int):
    """Top-k values and indices along the last axis, largest first."""
    k = min(k, scores.shape[-1])
    return torch.topk(scores, k, dim=-1)


def tiled_top_k(scores: torch.Tensor, k: int, tile: int = 4096):
    """Exact two-stage top-k along the last axis: a per-tile top-k, then a
    top-k over the survivors. Every true top-k element is in its tile's
    top-k, so the result equals :func:`top_k_scores`. The tail tile is padded
    with -inf, which never wins. Returns indices into the original axis."""
    N = scores.shape[-1]
    k = min(k, N)
    if N <= tile:
        return torch.topk(scores, k, dim=-1)
    n_tiles = -(-N // tile)
    pad = n_tiles * tile - N
    if pad:
        fill = scores.new_full(scores.shape[:-1] + (pad,), float("-inf"))
        scores = torch.cat([scores, fill], dim=-1)
    tiled = scores.reshape(scores.shape[:-1] + (n_tiles, tile))
    vals, idx = torch.topk(tiled, min(k, tile), dim=-1)
    base = torch.arange(n_tiles, device=scores.device)[:, None] * tile
    flat_vals = vals.flatten(-2)
    flat_idx = (idx + base).flatten(-2)
    fvals, fpos = torch.topk(flat_vals, k, dim=-1)
    return fvals, torch.gather(flat_idx, -1, fpos)
