"""NumPy ranking-metric helpers (reference `src/utils/retrieval_metrics.py:6-141`)."""

from __future__ import annotations

import numpy as np


def recall_at_k(relevance: np.ndarray, k: int) -> float:
    """relevance: [n_queries, n_ranked] binary. 1 if any hit in top-k."""
    return float((relevance[:, :k].sum(axis=1) > 0).mean())


def precision_at_k(relevance: np.ndarray, k: int) -> float:
    return float((relevance[:, :k].sum(axis=1) / k).mean())


def dcg_at_k(rel_row: np.ndarray, k: int) -> float:
    rel = rel_row[:k]
    if rel.size == 0:
        return 0.0
    discounts = 1.0 / np.log2(np.arange(2, rel.size + 2))
    return float((rel * discounts).sum())


def ndcg_at_k(relevance: np.ndarray, k: int) -> float:
    out = []
    for row in relevance:
        ideal = np.sort(row)[::-1]
        idcg = dcg_at_k(ideal, k)
        out.append(dcg_at_k(row, k) / idcg if idcg > 0 else 0.0)
    return float(np.mean(out))


def average_precision(rel_row: np.ndarray, k: int) -> float:
    rel = rel_row[:k]
    hits = np.cumsum(rel)
    precisions = hits / np.arange(1, rel.size + 1)
    denom = rel.sum()
    return float((precisions * rel).sum() / denom) if denom > 0 else 0.0


def map_at_k(relevance: np.ndarray, k: int) -> float:
    return float(np.mean([average_precision(r, k) for r in relevance]))
