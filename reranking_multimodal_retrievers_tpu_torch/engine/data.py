"""Retrieval data abstractions: Queries, Collection, Ranking.

A copy of the JAX package's ``engine/data.py``, which imports no JAX:
the port keeps its own so that it imports nothing of that package.

The role of the ColBERT engine's data layer
(`third_party/ColBERT/colbert/data/queries.py:11-143`, `collection.py:14-97`,
`ranking.py:18-95`): typed containers around the three artifacts a retrieval
run touches — the query set, the passage corpus, and ranked lists — each with
TSV/JSONL round-trips and a permissive ``cast`` so APIs accept a path, a
dict/list, or an existing instance interchangeably. Used by the CLI tools and
the static-retrieval cache the reranker executor consumes
(`src/executors/Reranker_base_executor.py:244-271` loads exactly this shape).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple, Union


def _is_jsonl(path: str) -> bool:
    return path.endswith((".jsonl", ".json"))


class Queries:
    """qid → question text (reference `queries.py:11-143`)."""

    def __init__(self, data: Optional[Dict] = None, path: Optional[str] = None):
        self.path = path
        if path is not None and data is None:
            data = self._load(path)
        self.data: Dict = dict(data or {})

    @staticmethod
    def _load(path: str) -> Dict:
        out = {}
        with open(path) as f:
            if _is_jsonl(path):
                for line in f:
                    if line.strip():
                        row = json.loads(line)
                        out[row["qid"]] = row["question"]
            else:  # TSV: qid \t question
                for line in f:
                    qid, question = line.rstrip("\n").split("\t", 1)
                    out[_maybe_int(qid)] = question
        return out

    def save(self, new_path: str) -> None:
        os.makedirs(os.path.dirname(new_path) or ".", exist_ok=True)
        with open(new_path, "w") as f:
            if _is_jsonl(new_path):
                for qid, q in self.data.items():
                    f.write(json.dumps({"qid": qid, "question": q}) + "\n")
            else:
                for qid, q in self.data.items():
                    f.write(f"{qid}\t{q}\n")

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter(self.data.items())

    def __getitem__(self, qid):
        return self.data[qid]

    def keys(self):
        return self.data.keys()

    def values(self):
        return self.data.values()

    @classmethod
    def cast(cls, obj: Union[str, Dict, "Queries"]) -> "Queries":
        if isinstance(obj, str):
            return cls(path=obj)
        if isinstance(obj, dict):
            return cls(data=obj)
        if isinstance(obj, cls):
            return obj
        raise TypeError(f"cannot cast {type(obj)} to Queries")


class Collection:
    """Ordered passage corpus; pid = position (reference `collection.py:14-97`)."""

    def __init__(self, path: Optional[str] = None,
                 data: Optional[List[str]] = None):
        self.path = path
        self.data: List[str] = list(data) if data is not None else (
            self._load(path) if path else [])

    @staticmethod
    def _load(path: str) -> List[str]:
        out = []
        with open(path) as f:
            if _is_jsonl(path):
                for line in f:
                    if line.strip():
                        row = json.loads(line)
                        out.append(row["passage"] if isinstance(row, dict) else row)
            else:  # TSV: pid \t passage [\t title]
                for i, line in enumerate(f):
                    parts = line.rstrip("\n").split("\t")
                    pid, passage = parts[0], parts[1]
                    if len(parts) > 2:  # title column folded in, engine-style
                        passage = parts[2] + " | " + passage
                    assert pid == "id" or int(pid) == i, (
                        f"collection pids must be contiguous, got {pid} at {i}")
                    if pid != "id":
                        out.append(passage)
        return out

    def save(self, new_path: str) -> None:
        os.makedirs(os.path.dirname(new_path) or ".", exist_ok=True)
        with open(new_path, "w") as f:
            if _is_jsonl(new_path):
                for p in self.data:
                    f.write(json.dumps({"passage": p}) + "\n")
            else:
                for i, p in enumerate(self.data):
                    f.write(f"{i}\t{p}\n")

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter(self.data)

    def __getitem__(self, pid: int) -> str:
        return self.data[pid]

    def enumerate_batches(self, batch_size: int) -> Iterable[Tuple[int, List[str]]]:
        for i in range(0, len(self.data), batch_size):
            yield i, self.data[i : i + batch_size]

    @classmethod
    def cast(cls, obj: Union[str, List, "Collection"]) -> "Collection":
        if isinstance(obj, str):
            return cls(path=obj)
        if isinstance(obj, list):
            return cls(data=obj)
        if isinstance(obj, cls):
            return obj
        raise TypeError(f"cannot cast {type(obj)} to Collection")


def _maybe_int(x: str):
    try:
        return int(x)
    except ValueError:
        return x


class Ranking:
    """Ranked lists: rows of (qid, pid, rank, score) (reference
    `ranking.py:18-95`). ``todict`` groups by qid — the shape
    ``questionId2topPassages`` static-retrieval files use."""

    def __init__(self, path: Optional[str] = None,
                 data: Optional[List[Tuple]] = None):
        self.path = path
        self.data: List[Tuple] = list(data) if data is not None else (
            self._load(path) if path else [])

    @staticmethod
    def _load(path: str) -> List[Tuple]:
        out = []
        with open(path) as f:
            if _is_jsonl(path):
                payload = json.load(f) if path.endswith(".json") else [
                    json.loads(l) for l in f if l.strip()]
                if isinstance(payload, dict):  # questionId2topPassages shape
                    for qid, passages in payload.items():
                        for rank, p in enumerate(passages):
                            out.append((_maybe_int(qid),
                                        p.get("passage_id", p.get("pid")),
                                        rank, p.get("score")))
                    return out
                for row in payload:
                    out.append(tuple(row))
            else:  # TSV: qid \t pid \t rank [\t score]
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    row = [_maybe_int(parts[0]), _maybe_int(parts[1]),
                           int(parts[2])]
                    if len(parts) > 3:
                        row.append(float(parts[3]))
                    out.append(tuple(row))
        return out

    def todict(self) -> Dict:
        grouped = defaultdict(list)
        for row in self.data:
            grouped[row[0]].append(tuple(row[1:]))
        return dict(grouped)

    def tolist(self) -> List[Tuple]:
        return list(self.data)

    def to_static_retrieval(self, id2content: Optional[Dict] = None) -> Dict:
        """``questionId2topPassages`` json shape consumed by
        ``RerankerExecutor.init_retrieve`` (reference
        `Reranker_base_executor.py:244-271`)."""
        out = {}
        for qid, rows in self.todict().items():
            out[str(qid)] = [
                {
                    "passage_id": pid,
                    # rest is (rank,) or (rank, score): only report a score
                    # when a real score column exists — never the rank.
                    "score": (rest[-1] if len(rest) > 1 else None),
                    **({"content": id2content[pid]} if id2content and pid in id2content else {}),
                }
                for pid, *rest in rows
            ]
        return out

    def save(self, new_path: str) -> None:
        os.makedirs(os.path.dirname(new_path) or ".", exist_ok=True)
        with open(new_path, "w") as f:
            if new_path.endswith(".json"):
                json.dump(self.to_static_retrieval(), f)
            elif new_path.endswith(".jsonl"):
                for row in self.data:
                    f.write(json.dumps(list(row)) + "\n")
            else:
                for row in self.data:
                    f.write("\t".join(str(x) for x in row) + "\n")

    def __len__(self):
        return len(self.data)

    @classmethod
    def cast(cls, obj: Union[str, List, "Ranking"]) -> "Ranking":
        if isinstance(obj, str):
            return cls(path=obj)
        if isinstance(obj, list):
            return cls(data=obj)
        if isinstance(obj, cls):
            return obj
        raise TypeError(f"cannot cast {type(obj)} to Ranking")


class Examples:
    """Training examples — the ColBERT engine's triples container
    (`third_party/ColBERT/colbert/data/examples.py:10-81`).

    Each example is ``[qid, pos, neg, ...]`` where entries after the qid are
    either bare pids or ``[pid, score]`` pairs (distillation triples). JSONL
    round-trip; ``nway`` slices each line to 1 query + nway passages at load
    time; ``tolist(shard, nshards)`` is the strided split the reference's
    per-rank reader uses — here it feeds per-host input sharding on the DCN
    axis (SPMD replaces per-rank processes for everything on-chip)."""

    def __init__(self, path: Optional[str] = None, data: Optional[List] = None,
                 nway: Optional[int] = None):
        self.path = path
        self.nway = nway
        self.data = data if data is not None else self._load(path)

    def _load(self, path: str) -> List:
        keep = self.nway + 1 if self.nway else None
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line)[:keep])
        return out

    def tolist(self, shard: Optional[int] = None,
               nshards: Optional[int] = None) -> List:
        if shard is not None or nshards is not None:
            assert shard in range(nshards), (shard, nshards)
            return [self.data[i] for i in range(shard, len(self.data), nshards)]
        return list(self.data)

    def save(self, new_path: str) -> str:
        with open(new_path, "w") as f:
            for ex in self.data:
                f.write(json.dumps(ex) + "\n")
        with open(new_path + ".meta", "w") as f:
            json.dump({"size": len(self.data), "nway": self.nway,
                       "source": self.path}, f)
        return new_path

    def __len__(self):
        return len(self.data)

    @classmethod
    def cast(cls, obj: Union[str, List, "Examples"],
             nway: Optional[int] = None) -> "Examples":
        if isinstance(obj, str):
            return cls(path=obj, nway=nway)
        if isinstance(obj, list):
            return cls(data=obj, nway=nway)
        if isinstance(obj, cls):
            return obj
        raise TypeError(f"cannot cast {type(obj)} to Examples")
