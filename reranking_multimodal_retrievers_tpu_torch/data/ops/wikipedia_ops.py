"""Wikipedia corpus transforms + BM25 pseudo-label mining.

Port of the JAX package's ``data/ops/wikipedia_ops.py`` over
``data/table.py`` tables. Reference
`src/data_ops/wikipedia_data_ops.py:63-603`. The reference mines
pseudo-relevant passages with an external Elasticsearch server
(`IndexPassagesWithElasticSearch` `:228`); this environment has no ES, so the
same capability is provided by a self-contained NumPy BM25 index — same
node names, no external service.
"""

from __future__ import annotations

import logging
import math
import re
from collections import Counter
from typing import Dict, List

import numpy as np

from ...utils.registries import register_transform_functor
from ..transforms import HFDatasetTransform
from .m2kr_ops import _load_hf, make_dummy_m2kr

logger = logging.getLogger(__name__)

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


class BM25Index:
    """In-memory BM25 (k1=1.5, b=0.75) over a CSC term→doc matrix.

    The ES-server replacement for pseudo-label mining at corpus scale
    (`wikipedia_data_ops.py:228-310`): BM25 term weights are precomputed into
    one sparse matrix so a query scores as a sum of term columns — no Python
    loop over documents."""

    def __init__(self, docs: List[str], k1=1.5, b=0.75):
        from scipy import sparse

        self.k1, self.b = k1, b
        self.doc_tokens = [_tokenize(d) for d in docs]
        self.doc_lens = np.array([len(t) for t in self.doc_tokens], np.float32)
        self.avgdl = float(self.doc_lens.mean()) if len(docs) else 0.0
        self.n = len(docs)
        self.vocab: Dict[str, int] = {}
        rows, cols, vals = [], [], []
        df = Counter()
        tfs = []
        for toks in self.doc_tokens:
            tf = Counter(toks)
            tfs.append(tf)
            df.update(tf.keys())
        for i, tf in enumerate(tfs):
            denom_base = self.k1 * (1 - self.b + self.b * self.doc_lens[i] / max(self.avgdl, 1e-9))
            for tok, f in tf.items():
                t = self.vocab.setdefault(tok, len(self.vocab))
                idf = math.log(1 + (self.n - df[tok] + 0.5) / (df[tok] + 0.5))
                rows.append(i)
                cols.append(t)
                vals.append(idf * f * (self.k1 + 1) / (f + denom_base))
        self._matrix = sparse.csc_matrix(
            (vals, (rows, cols)), shape=(self.n, max(len(self.vocab), 1)),
            dtype=np.float32,
        )

    def scores(self, query: str) -> np.ndarray:
        q = Counter(_tokenize(query))
        cols = [(self.vocab[t], c) for t, c in q.items() if t in self.vocab]
        if not cols:
            return np.zeros(self.n, np.float32)
        idx = [i for i, _ in cols]
        w = np.asarray([c for _, c in cols], np.float32)
        return np.asarray(self._matrix[:, idx] @ w).ravel()

    def search(self, query: str, k: int = 10) -> List[int]:
        s = self.scores(query)
        k = min(k, self.n)
        part = np.argpartition(-s, k - 1)[:k] if k < self.n else np.arange(self.n)
        return list(part[np.argsort(-s[part])])


@register_transform_functor
class LoadWikipediaPassageData(HFDatasetTransform):
    """Reference `:63-108`."""

    def setup(self, passage_path=None, **kwargs):
        self.passage_path = passage_path
        return self

    def _call(self, data=None):
        if self.use_dummy_data or not self.passage_path:
            d = make_dummy_m2kr()
            return {f"{s}_passages": d[f"{s}_passages"] for s in ("train", "valid", "test")}
        return _load_hf(self.passage_path)


@register_transform_functor
class LoadFullWikipediaPassageData(LoadWikipediaPassageData):
    """Reference `:110-226` — full (6M) corpus variant; same mechanics."""


@register_transform_functor
class IndexPassagesWithElasticSearch(HFDatasetTransform):
    """Build a lexical index over the passages (reference `:228-310`).
    ES replaced by the in-memory BM25 above; the output carries the index
    object for downstream annotation nodes."""

    def setup(self, index_name: str = "wikipedia", **kwargs):
        self.index_name = index_name
        return self

    def _call(self, data):
        passages = None
        for key in data.keys():
            if key.endswith("_passages"):
                passages = data[key]
                break
        assert passages is not None, "no *_passages split to index"
        index = BM25Index(list(passages["passage_content"]))
        return {
            "index": index,
            "passage_ids": list(passages["passage_id"]),
            "passages": data,
        }


def token_set_ratio(a: str, b: str) -> int:
    """thefuzz ``token_set_ratio`` semantics (the reference's candidate
    rater, `wikipedia_data_ops.py:396-440`): compare the sorted-token
    intersection against each side's remainder strings and take the best
    SequenceMatcher ratio, as an integer percentage."""
    from difflib import SequenceMatcher

    ta = set(a.lower().split())
    tb = set(b.lower().split())
    inter = " ".join(sorted(ta & tb))
    s1 = (inter + " " + " ".join(sorted(ta - tb))).strip()
    s2 = (inter + " " + " ".join(sorted(tb - ta))).strip()
    best = 0
    for x, y in ((inter, s1), (inter, s2), (s1, s2)):
        if x or y:
            best = max(best, int(round(100 * SequenceMatcher(None, x, y).ratio())))
    return best


@register_transform_functor
class PrepareWikipediaPassageAnnotations(HFDatasetTransform):
    """Mine pseudo-positives (reference `:312-540`), faithfully:

    1. per question, per UNIQUE answer: lexical-search the corpus and keep
       passages that actually contain the answer phrase (the ES
       ``multi_match``-phrase role, `:366-377`);
    2. rate every candidate with ``token_set_ratio`` against a query string
       of ``gold_answer ×2 + question + caption + object classes``
       (`:425-440`);
    3. keep the top-10 and drop everything tied with the lowest score
       (`:442-448`);
    4. ``pos_item_ids`` = survivors, ``related_item_ids`` = all candidates,
       ``pos_item_contents`` alongside; questions with no candidates are
       SKIPPED in train mode but kept with dummy ``["1"]`` annotations in
       test mode (`:464-493`)."""

    def setup(self, k: int = 20, mode: str = "train", **kwargs):
        self.k = k
        self.mode = mode
        return self

    def _call(self, inputs):
        data, indexed = inputs if isinstance(inputs, list) else (inputs, None)
        assert indexed is not None, "requires [questions, indexed_passages] inputs"
        index: BM25Index = indexed["index"]
        pids = indexed["passage_ids"]
        contents = [" ".join(toks) for toks in index.doc_tokens]

        def candidates_for(answers):
            """Answer-phrase candidate generation (ES phrase-search role).
            The answer is normalized with the same token regex as the indexed
            contents, otherwise punctuation ("u.s.", "jean-luc") could
            never phrase-match the normalized passage text."""
            cand = {}
            for raw in set(a.lower() for a in answers if a):
                ans = " ".join(_TOKEN_RE.findall(raw))
                if not ans:
                    continue
                for i in index.search(ans, self.k):
                    if ans in contents[i]:
                        cand[i] = contents[i]
            return cand

        def annotate(example):
            answers = example.get("answers", [])
            cand = candidates_for(answers)
            gold = example.get("gold_answer", "") or (answers[0] if answers else "")
            query = f"{gold} {gold} {example.get('question', '')}"
            if example.get("img_caption"):
                cap = example["img_caption"]
                query += f" {cap['caption'] if isinstance(cap, dict) else cap}"
            for obj in example.get("objects", []) or []:
                cls = obj.get("class") if isinstance(obj, dict) else str(obj)
                if cls:
                    query += f" {cls.strip().lower()}"
            rated = sorted(
                ((token_set_ratio(query, text), i) for i, text in cand.items()),
                reverse=True,
            )[:10]
            if rated:
                lowest = rated[-1][0]
                survivors = [i for score, i in rated if score > lowest]
            else:
                survivors = []
            if not cand or not survivors:
                # train: drop the row; test: keep with dummy annotations so
                # every sample is evaluated (`:464-493`)
                example["pos_item_ids"] = ["1"]
                example["pos_item_contents"] = [""]
                example["related_item_ids"] = ["1"]
                example["_annotation_missing"] = True
                return example
            example["pos_item_ids"] = [pids[i] for i in survivors]
            example["pos_item_contents"] = [contents[i] for i in survivors]
            example["related_item_ids"] = [pids[i] for i in cand]
            example["_annotation_missing"] = False
            return example

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            data[split] = data[split].map(annotate)
            # In train mode the reference drops missing-annotation rows from
            # EVERY split (`wikipedia_data_ops.py` annotate loop `continue`),
            # not just 'train' — otherwise dummy pos_item_ids=["1"] rows leak
            # into valid/test under train mode.
            if self.mode == "train":
                n0 = len(data[split])
                data[split] = data[split].filter(lambda ex: not ex["_annotation_missing"])
                dropped = n0 - len(data[split])
                if dropped:
                    logger.warning(
                        "%d train questions had no pseudo-annotations and "
                        "were dropped", dropped)
        for key in indexed["passages"].keys():
            if key.endswith("_passages"):
                data[key] = indexed["passages"][key]
        return data


@register_transform_functor
class ReduceWikipediaPassagesSize(HFDatasetTransform):
    """Shrink the corpus to positives + sampled distractors
    (reference `:542-603`)."""

    def setup(self, num_distractors: int = 1000, **kwargs):
        self.num_distractors = num_distractors
        return self

    def _call(self, data):
        keep_ids = set()
        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            if "pos_item_ids" in data[split].column_names:
                for ids in data[split]["pos_item_ids"]:
                    keep_ids.update(ids)
        rng = np.random.default_rng(0)
        for key in [k for k in data.keys() if k.endswith("_passages")]:
            table = data[key]
            pos_rows = [i for i, pid in enumerate(table["passage_id"]) if pid in keep_ids]
            pos_set = set(pos_rows)
            n_extra = min(self.num_distractors, len(table) - len(pos_rows))
            others = [i for i in range(len(table)) if i not in pos_set]
            extra = (rng.choice(len(others), size=n_extra, replace=False)
                     if n_extra else np.array([], np.int64))
            extra = [others[int(j)] for j in extra]
            data[key] = table.select(sorted(pos_set.union(extra)))
        return data
