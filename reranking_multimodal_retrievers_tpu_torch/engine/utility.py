"""Engine utility ops: supervision triples, ranking surgery, EM annotation.

A copy of the JAX package's ``engine/utility.py``, which imports no JAX:
the port keeps its own so that it imports nothing of that package.

Counterpart of the reference's `third_party/ColBERT/utility/` script family,
re-expressed as pure functions over this engine's in-memory ranking shape —
``qid -> [(pid, rank, ...), ...]`` with 1-indexed ranks, the same shape
`engine.data.Ranking.todict()` produces — instead of one argparse script per
operation:

- `utility/supervision/triples.py:20-72`   -> `sample_triples`
- `utility/supervision/self_training.py:15-53` -> `self_training_triples`
- `utility/evaluate/annotate_EM.py` + helpers  -> `annotate_em`
- `utility/rankings/merge.py:13-35`        -> `merge_rankings`
- `utility/rankings/split_by_offset.py`    -> `split_ranking_by_offset`
- `utility/rankings/split_by_queries.py`   -> `split_ranking_by_queries`
- `utility/rankings/dev_subsample.py:11-21`-> `subsample_queries`
- `utility/rankings/tune.py:10-25`         -> `pick_best_run`
- `utility/preprocess/docs2passages.py:19-53` -> `docs2passages`
- `utility/preprocess/queries_split.py:15-50` -> `split_queries`

Randomness is an explicit ``random.Random`` everywhere (the scripts seed the
global RNG); answer matching replaces the reference's spacy/regex DPR
tokenizer (`utility/utils/dpr.py`) with unicode-normalized word matching —
same containment semantics, no spacy dependency.
"""

from __future__ import annotations

import random
import string
import unicodedata
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

MAX_NUM_TRIPLES = 40_000_000  # `triples.py:17`

# --------------------------------------------------------------- supervision


def sample_negatives(negatives: List, num_sampled: int, biased: Optional[int],
                     rng: random.Random) -> List:
    """`triples.py:20-36`: optionally bias half the sample to come from the
    top-``biased`` negatives when the tail is at least as large."""
    assert biased in (None, 100, 200)
    num_sampled = min(len(negatives), num_sampled)
    if biased and num_sampled < len(negatives):
        assert num_sampled % 2 == 0, num_sampled
        top, rest = negatives[:biased], negatives[biased:]
        if len(top) < len(rest):
            half = num_sampled // 2
            return (rng.sample(top, half)
                    + rng.sample(rest, num_sampled - half))
    return rng.sample(negatives, num_sampled)


def sample_triples_for_query(
    qid,
    ranking: Sequence[Tuple],
    positives: Sequence[Tuple[int, int]],
    depth: int,
    permissive: bool = False,
    biased: Optional[int] = None,
    rng: Optional[random.Random] = None,
) -> List[Tuple]:
    """`triples.py:39-72`. ``ranking`` rows are ``(pid, rank, ..., label)``
    with 1-indexed ranks sorted per qid; ``positives`` is a list of
    ``(maxBest, maxDepth)`` rules (e.g. ``[(5, 50), (1, 1000)]`` = best-5
    within top-50 plus best-1 within top-1000). Permissive mode also keeps
    labeled positives that miss every rule, pairing them with 5 negatives
    drawn from ranks below their own."""
    rng = rng or random.Random(12345)
    pos, negs, triples = [], [], []
    for pid, rank, *rest in ranking:
        label = rest[-1]
        assert rank >= 1, f"ranks should start at 1, got {rank}"
        assert label in (0, 1)
        if rank > depth:
            break
        if label:
            # the reference counts ALL positives taken so far (permissive
            # ones included) against maxBest (`triples.py:55`)
            take = any(rank <= max_depth and len(pos) < max_best
                       for max_best, max_depth in positives)
            if take:
                pos.append((pid, 0))
            elif permissive:
                pos.append((pid, rank))
        else:
            negs.append(pid)
    for pid, neg_start in pos:
        num_sampled = 100 if neg_start == 0 else 5
        for neg in sample_negatives(negs[neg_start:], num_sampled,
                                    biased if neg_start == 0 else None, rng):
            triples.append((qid, pid, neg))
    return triples


def sample_triples(
    qid2ranking: Dict,
    positives: Sequence[Tuple[int, int]],
    depth: int,
    permissive: bool = False,
    biased: Optional[int] = None,
    max_triples: int = MAX_NUM_TRIPLES,
    seed: int = 12345,
) -> List[Tuple]:
    """`triples.py:75-112`: per-qid sampling, global cap, shuffle."""
    rng = random.Random(seed)
    triples = []
    for qid, ranking in qid2ranking.items():
        triples.extend(sample_triples_for_query(
            qid, ranking, positives, depth, permissive, biased, rng))
    if len(triples) > max_triples:
        triples = rng.sample(triples, max_triples)
    rng.shuffle(triples)
    return triples


def self_training_triples_for_query(
    qid,
    ranking: Sequence[Tuple],
    npositives: int,
    depth_positive: int,
    depth_negative: int,
    cutoff_negative: int,
    rng: Optional[random.Random] = None,
) -> List[Tuple]:
    """`self_training.py:28-53`: pseudo-labels from the ranking itself —
    top-``depth_positive`` as positives, ranks in
    ``(cutoff_negative, depth_negative]`` as negatives, 100 sampled
    negatives each paired with ``npositives`` sampled positives."""
    assert npositives <= depth_positive < cutoff_negative < depth_negative
    rng = rng or random.Random(12345)
    pos, negs, triples = [], [], []
    for pid, rank, *_ in ranking:
        assert rank >= 1
        if rank > depth_negative:
            break
        if rank <= depth_positive:
            pos.append(pid)
        elif rank > cutoff_negative:
            negs.append(pid)
    if not pos:
        return []
    for neg in sample_negatives(negs, 100, None, rng):
        chosen = rng.sample(pos, npositives)
        triples.append((qid, chosen[0] if npositives == 1 else chosen, neg))
    return triples


def self_training_triples(qid2ranking: Dict, npositives: int,
                          depth_positive: int, depth_negative: int,
                          cutoff_negative: int, seed: int = 12345,
                          max_triples: int = MAX_NUM_TRIPLES) -> List[Tuple]:
    """`self_training.py:57-84`."""
    rng = random.Random(seed)
    triples = []
    for qid, ranking in qid2ranking.items():
        triples.extend(self_training_triples_for_query(
            qid, ranking, npositives, depth_positive, depth_negative,
            cutoff_negative, rng))
    if len(triples) > max_triples:
        triples = rng.sample(triples, max_triples)
    rng.shuffle(triples)
    return triples


# ---------------------------------------------------------- EM annotation


def dpr_normalize(text: str) -> List[str]:
    """Unicode-normalized lowercase word tokens (role of
    `utility/utils/dpr.py` ``DPR_normalize`` without the spacy tokenizer)."""
    text = unicodedata.normalize("NFD", text).lower()
    text = text.translate(str.maketrans(string.punctuation,
                                        " " * len(string.punctuation)))
    return text.split()


def has_answer(tokenized_answers: Iterable[List[str]], passage: str) -> bool:
    """True iff any answer appears as a contiguous word span of the passage
    (`utility/utils/dpr.py` ``has_answer`` semantics)."""
    words = dpr_normalize(passage)
    for ans in tokenized_answers:
        n = len(ans)
        if n == 0:
            continue
        for i in range(len(words) - n + 1):
            if words[i:i + n] == ans:
                return True
    return False


EM_CUTOFFS = (1, 5, 10, 20, 30, 50, 100, 1000, "all")


def annotate_em(qid2ranking: Dict, collection: Dict, qid2answers: Dict
                ) -> Tuple[Dict, Dict]:
    """`annotate_EM.py:19-57` + `annotate_EM_helpers.py:36-66`: label every
    ``(qid, pid, rank)`` by answer containment in ``collection[pid]``,
    return ``(qid -> [(pid, rank, label), ...], metrics)`` where metrics
    holds ``success@k`` (any hit in top-k) and ``counts@k`` (mean hits in
    top-k) over the judged queries, plus the size accounting."""
    tok_answers = {qid: [dpr_normalize(a) for a in answers]
                   for qid, answers in qid2answers.items()}
    labeled: Dict = {}
    success = {c: 0.0 for c in EM_CUTOFFS}
    counts = {c: 0.0 for c in EM_CUTOFFS}
    for qid in qid2answers:
        if qid not in qid2ranking:
            continue
        prev_rank = 0
        labels = []
        rows = []
        for pid, rank, *_ in qid2ranking[qid]:
            assert rank == prev_rank + 1, (qid, pid, prev_rank, rank)
            prev_rank = rank
            label = int(has_answer(tok_answers[qid], collection[pid]))
            labels.append(label)
            rows.append((pid, rank, label))
        labeled[qid] = rows
        for cutoff in EM_CUTOFFS:
            top = labels if cutoff == "all" else labels[:cutoff]
            success[cutoff] += float(sum(top) > 0)
            counts[cutoff] += float(sum(top))
    num_judged = len(qid2answers)
    num_ranked = len(qid2ranking)
    assert num_ranked <= num_judged
    metrics = {
        "num_judged_queries": num_judged,
        "num_ranked_queries": num_ranked,
        "success": {k: v / num_judged for k, v in success.items()},
        "counts": {k: v / num_judged for k, v in counts.items()},
    }
    return labeled, metrics


def msmarco_eval(qid2ranking: Dict, qid2positives: Dict,
                 recall_depths: Sequence[int] = (50, 200, 1000, 5000, 10000),
                 ) -> Dict:
    """`utility/evaluate/msmarco_passages.py:17-93`: MRR@10 (reciprocal rank
    of the FIRST positive, zero when it falls below 10) and Recall@depth
    (fraction of a query's positives ranked within depth), each averaged
    over judged queries and, separately, over ranked queries."""
    assert set(qid2ranking) <= set(qid2positives)
    num_judged = len(qid2positives)
    num_ranked = len(qid2ranking)
    mrr_sum = 0.0
    recall_sums = {d: 0.0 for d in recall_depths}
    for qid, positives in qid2positives.items():
        pos = set(positives)
        ranking = qid2ranking.get(qid, [])
        for i, (pid, *_rest) in enumerate(ranking):
            if pid in pos:
                if i + 1 <= 10:
                    mrr_sum += 1.0 / (i + 1)
                break
        for i, (pid, *_rest) in enumerate(ranking):
            if pid in pos:
                for depth in recall_depths:
                    if i + 1 <= depth:
                        recall_sums[depth] += 1.0 / len(positives)
    out = {
        "num_judged_queries": num_judged,
        "num_ranked_queries": num_ranked,
        "mrr@10": mrr_sum / num_judged,
        "mrr@10_ranked_only": mrr_sum / max(num_ranked, 1),
    }
    for depth in recall_depths:
        out[f"recall@{depth}"] = recall_sums[depth] / num_judged
        out[f"recall@{depth}_ranked_only"] = (
            recall_sums[depth] / max(num_ranked, 1))
    return out


# ------------------------------------------------------------ ranking ops


def merge_rankings(rankings: Sequence[Dict]) -> Dict:
    """`rankings/merge.py:13-35`: pool per-qid rows ``(pid, rank, score)``
    across files, re-sort by score descending, re-assign 1-indexed ranks."""
    pooled = defaultdict(list)
    for qid2ranking in rankings:
        for qid, rows in qid2ranking.items():
            # rows may carry trailing fields (e.g. 4-tuple (pid, rank,
            # score, label) used elsewhere in this module) — ignore them
            for pid, rank, score, *_ in rows:
                pooled[qid].append((float(score), int(rank), pid))
    out = {}
    for qid, rows in pooled.items():
        rows.sort(reverse=True)
        out[qid] = [(pid, i + 1, score)
                    for i, (score, _, pid) in enumerate(rows)]
    return out


def split_ranking_by_offset(qid2ranking: Dict, nsplits: int,
                            gap: int = 0) -> List[Dict]:
    """`rankings/split_by_offset.py:19-24`: un-merge a ranking produced over
    a gap-offset merged query set. With ``gap`` set, part index is
    ``qid // gap - 1`` (the reference offsets merged splits by
    ``(i+1)*gap``) and the emitted qid is remapped to ``qid % gap`` to
    recover the original per-split ids. With ``gap=0`` (default) falls back
    to a generic round-robin partition by dict position, which is NOT the
    reference operation — use it only when qids carry no offset encoding."""
    parts = [dict() for _ in range(nsplits)]
    if gap:
        for qid, rows in qid2ranking.items():
            parts[int(qid) // gap - 1][int(qid) % gap] = rows
        return parts
    for i, (qid, rows) in enumerate(qid2ranking.items()):
        parts[i % nsplits][qid] = rows
    return parts


def split_ranking_by_queries(qid2ranking: Dict,
                             qid_groups: Sequence[Iterable]) -> List[Dict]:
    """`rankings/split_by_queries.py`: one output per qid group."""
    groups = [set(g) for g in qid_groups]
    parts = [dict() for _ in groups]
    for qid, rows in qid2ranking.items():
        for part, group in zip(parts, groups):
            if qid in group:
                part[qid] = rows
    return parts


def subsample_queries(qids: Sequence, sample: int = 1500,
                      seed: int = 12345) -> List:
    """`rankings/dev_subsample.py:11-21`."""
    return random.Random(seed).sample(list(qids), min(sample, len(qids)))


def pick_best_run(scores: Dict[str, float]) -> str:
    """`rankings/tune.py:10-25`: argmax over per-run metric values (the
    reference then resolves the run's checkpoint path from its args.json —
    here the caller owns that mapping)."""
    assert scores, "no runs to pick from"
    for v in scores.values():
        assert isinstance(v, float), v
    return max(scores, key=scores.get)


# ------------------------------------------------------------ preprocess


def docs2passages(content: str, nwords: int = 180, overlap: int = 0
                  ) -> List[str]:
    """`preprocess/docs2passages.py:19-53` (whitespace-tokenizer branch):
    split a document into ``nwords`` word windows with ``overlap``; the
    reference doubles the word list when the document is longer than one
    window so the final short passage wraps around to full length — kept,
    it is the documented DPR-style behavior."""
    words = content.split()
    words_ = (words + words) if len(words) > nwords else words
    passages = [words_[off:off + nwords]
                for off in range(0, len(words) - overlap, nwords - overlap)]
    assert all(len(p) in (len(words), nwords) for p in passages)
    return [" ".join(p) for p in passages]


def split_queries(qids: Sequence, size_b: int, seed: int = 12345
                  ) -> Tuple[List, List]:
    """`preprocess/queries_split.py:15-50`: random disjoint (a, b) split
    with ``len(b) == size_b``, both in original order."""
    rng = random.Random(seed)
    idx_b = set(rng.sample(range(len(qids)), size_b))
    a = [q for i, q in enumerate(qids) if i not in idx_b]
    b = [q for i, q in enumerate(qids) if i in idx_b]
    return a, b
