"""Post-hoc analysis tools (port of ``tools/analysis.py``; standard
library only).

Parity with `src/tools/` (SURVEY.md §2.7): compose retrieval+rerank
prediction dumps and sweep recall vs rerank-list size D
(`rerank_scores.py:28-108`), McNemar significance between reranked and raw
lists (`mcnemar.py`), and loss-vs-recall curves
(`pointwise_loss_vs_recall.py` / `listwise_loss_vs_recall.py`). All operate
on the executors' ``*_predictions_rank_0.json`` dumps.
"""

from __future__ import annotations

import json
import math
from collections import defaultdict
from typing import Dict, List, Optional


def load_predictions(path: str) -> List[dict]:
    with open(path) as f:
        dump = json.load(f)
    return dump.get("predictions", dump.get("output", dump))


def _hit(passages: List[dict], pos_ids, k: int) -> int:
    return int(any(p["passage_id"] in set(pos_ids) for p in passages[:k]))


def _answer_hit(passages: List[dict], answers, k: int) -> int:
    return int(
        any(
            any(a.lower() in p["content"].lower() for a in answers)
            for p in passages[:k]
        )
    )


def rerank_vs_list_size(
    retrieval_predictions: List[dict],
    rerank_predictions: List[dict],
    Ds: List[int],
    k: int = 5,
    use_answers: bool = True,
) -> Dict[int, float]:
    """Recall@k after reranking only the top-D retrieved docs, for each D
    (reference `rerank_scores.py:28-108`)."""
    rerank_map = {
        str(e["question_id"]): {p["passage_id"]: p["score"]
                                for p in e["top_ranking_passages"]}
        for e in rerank_predictions
    }
    out = {}
    for D in Ds:
        hits, count = 0, 0
        for entry in retrieval_predictions:
            qid = str(entry["question_id"])
            if qid not in rerank_map:
                continue
            top_d = sorted(
                entry["top_ranking_passages"], key=lambda p: -p["score"]
            )[:D]
            scores = rerank_map[qid]
            reranked = sorted(
                top_d, key=lambda p: -scores.get(p["passage_id"], -1e9)
            )
            if use_answers and "answers" in entry:
                hits += _answer_hit(reranked, entry["answers"], k)
            else:
                hits += _hit(reranked, entry.get("pos_item_ids", []), k)
            count += 1
        out[D] = hits / max(count, 1)
    return out


def mcnemar_test(predictions: List[dict], k: int = 5,
                 field: str = "pos_item_ids") -> dict:
    """McNemar χ² between the reranked and raw lists of one dump
    (reference `mcnemar.py`): b = raw-correct & rerank-wrong, c = the
    opposite; χ² = (|b−c|−1)²/(b+c) with continuity correction."""
    a = b = c = d = 0
    for entry in predictions:
        pos = entry.get(field, [])
        raw = _hit(entry["raw_top_ranking_passages"], pos, k)
        new = _hit(entry["top_ranking_passages"], pos, k)
        if raw and new:
            a += 1
        elif raw and not new:
            b += 1
        elif not raw and new:
            c += 1
        else:
            d += 1
    if b + c == 0:
        return {"a": a, "b": b, "c": c, "d": d, "chi2": 0.0, "p_value": 1.0}
    chi2 = (abs(b - c) - 1) ** 2 / (b + c)
    # 1-dof chi-square survival function via the complementary error function
    p = math.erfc(math.sqrt(chi2 / 2.0))
    return {"a": a, "b": b, "c": c, "d": d, "chi2": chi2, "p_value": p}


def loss_vs_recall(
    prediction_dumps: List[str],
    losses: List[float],
    k: int = 5,
    field: str = "pos_item_ids",
) -> List[dict]:
    """Pair training losses with eval recall across checkpoints (reference
    `pointwise_loss_vs_recall.py` / `listwise_loss_vs_recall.py`)."""
    rows = []
    for path, loss in zip(prediction_dumps, losses):
        preds = load_predictions(path)
        recall = sum(
            _hit(e["top_ranking_passages"], e.get(field, []), k) for e in preds
        ) / max(len(preds), 1)
        rows.append({"dump": path, "loss": loss, f"recall_at_{k}": recall})
    return rows
