"""Multi-hop condenser + hop search — the Baleen subsystem (port of
``engine/condenser.py``).

The role of `third_party/ColBERT/baleen/` (SURVEY §2.8 "data/utilities"):
open-domain multi-hop retrieval where each hop retrieves passages, a
*condenser* extracts the few relevant sentences, and those facts extend the
query for the next hop.

- :class:`SentenceReader` — the ``ElectraReader`` role
  (`baleen/condenser/model.py:7-38`): an encoder + scalar head that scores
  each candidate *sentence* of a (query, passage) sequence. The reference
  finds sentence boundaries by scanning for ``[MASK]`` separator tokens at
  runtime (`model.py:35-37,40-66` — a data-dependent 2D index). Here the
  host knows the separator positions at tokenization time, so the model
  takes a static ``[B, max_sentences]`` position matrix and gathers with
  ``gather`` — fixed shapes, no dynamic nonzero. Its BERT launches kernel K2
  under ``use_pallas_attention`` on CUDA, as every BERT of the port does.
- :class:`Condenser` — `baleen/condenser/condense.py:13-141`: stage 1 scores
  every sentence of every retrieved passage and keeps the top
  ``stage1_topk`` (=9); stage 2 rescores the survivors jointly and keeps
  positives (score > 0), at least 2 and from at most 4 distinct passages
  (the reference's L3x invariants, `condense.py:128-140`).
- :class:`HopSearcher` / :class:`BaleenEngine` — `baleen/hop_searcher.py`,
  `baleen/engine.py`: per-hop dense search with hop-dependent k, threading
  condensed facts back into the next hop's query.

``Condenser`` takes its two readers' weights as state dicts of one
:class:`SentenceReader` (loaded into ``model`` when they change) or as two
modules.

Collection format matches the reference's ``collectionX``
(`condense.py:51-68`): JSONL rows ``{"pid": i, "title": t, "text": [sent,…]}``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike
from ..models.bert import BertConfig, BertModel
from ..models.init import materialize_


def _dedupe(seq):
    """Order-preserving dedupe (the reference's ``f7``)."""
    seen = set()
    out = []
    for x in seq:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out


class SentenceReader(nn.Module):
    """Encoder + per-token scalar head, read out at sentence-separator
    positions (`baleen/condenser/model.py:24-38`). Built on ``device`` (CUDA
    by default) with weights drawn from ``generator``; parameter names are
    ``encoder.*`` (a BERT without pooler) and ``linear.*``."""

    def __init__(self, config: BertConfig, learn_labels: bool = False, *,
                 device: DeviceLike = "cuda", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.learn_labels = learn_labels  # stage-2 checkpoint flavor (2-class CLS head)
        with torch.device("meta"):
            self.encoder = BertModel(config, add_pooling_layer=False, device="meta")
            self.linear = nn.Linear(config.hidden_size, 2 if learn_labels else 1)
        materialize_(self, device, dtype, generator, config.initializer_range)

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                sentence_positions=None):
        """sentence_positions: [B, S] token indices of each sentence's
        separator (−1 pads → scored −inf). Returns [B, S] sentence scores
        (or [B] CLS logits when ``learn_labels``)."""
        hidden = self.encoder(input_ids, attention_mask=attention_mask,
                              token_type_ids=token_type_ids)["last_hidden_state"]
        if self.learn_labels:
            return self.linear(hidden[:, 0])[:, 1]
        scores = self.linear(hidden)[..., 0]  # [B, L]
        picked = scores.gather(1, sentence_positions.clamp_min(0))  # [B, S]
        return torch.where(sentence_positions >= 0, picked, float("-inf"))


@dataclasses.dataclass
class CondenserConfig:
    stage1_topk: int = 9
    stage2_keep: int = 5
    max_docs: int = 4
    min_facts: int = 2
    maxlen: int = 512
    max_sentences: int = 32


class Condenser:
    """Two-stage sentence condenser (`baleen/condenser/condense.py:13-141`).

    ``tokenize(query, passages) -> (input_ids, attention_mask,
    token_type_ids, sentence_positions)`` is injected so any tokenizer with
    the ``[MASK]``-separator convention works; a whitespace test tokenizer
    ships in the tests.
    """

    def __init__(self, collection_path: str, paramsL1, paramsL2,
                 model: SentenceReader, tokenize,
                 config: Optional[CondenserConfig] = None):
        self.model = model
        self.paramsL1 = paramsL1
        self.paramsL2 = paramsL2
        self.tokenize = tokenize
        self.config = config or CondenserConfig()
        self.collectionX: Dict[int, List[str]] = {}
        self.collectionY: Dict[Tuple[int, int], str] = {}
        self._load_collection(collection_path)
        self._loaded = None  # the state dict ``model`` holds, if one was loaded

    def _reader(self, params) -> nn.Module:
        """``params`` itself if it is a module, else ``model`` holding the
        state dict ``params`` (loaded when it is not the one loaded last)."""
        if isinstance(params, nn.Module):
            return params
        if self._loaded is not params:
            self.model.load_state_dict(params)
            self._loaded = params
        return self.model

    def _apply(self, params, ids, am, tt, sp) -> torch.Tensor:
        """The reader's scores for token arrays (numpy or tensors), on the
        reader's device."""
        reader = self._reader(params)
        dev = next(reader.parameters()).device
        with torch.inference_mode():
            return reader(*(torch.as_tensor(a, device=dev).long() for a in (ids, am, tt, sp)))

    def _load_collection(self, path: str):
        """`condense.py:51-68`: collectionX = title + sentences per pid;
        collectionY = (pid, sid) → "title | sentence"."""
        with open(path) as f:
            for line_idx, line in enumerate(f):
                row = json.loads(line)
                assert isinstance(row["text"], list)
                pid = row.get("pid", line_idx)
                self.collectionX[pid] = [row["title"]] + row["text"]
                for sid, sent in enumerate(row["text"]):
                    self.collectionY[(pid, sid)] = f"{row['title']} | {sent}"

    # ------------------------------------------------------------- stages
    def _score(self, params, query: str, passages: List[str]) -> np.ndarray:
        ids, am, tt, sp = self.tokenize([query] * len(passages), passages)
        return self._apply(params, ids, am, tt, sp).float().cpu().numpy()

    def condense(self, query: str, backs: List[Tuple[int, int]],
                 ranking: List[int]):
        stage1 = self._stage1(query, backs, ranking)
        stage2, stage2_L3x = self._stage2(query, stage1)
        return stage1, stage2, stage2_L3x

    def _stage1(self, query: str, backs, ranking: List[int]):
        """Score every sentence of every ranked passage; union with the
        carried-over facts, dedupe, truncate (`condense.py:70-112`)."""
        cfg = self.config
        back_texts = [self.collectionY[k] for k in backs if k in self.collectionY]
        full_query = " # ".join([query] + back_texts)
        passages, pids = [], []
        for pid in ranking:
            # sentence separator convention: the tokenizer marks each
            # sentence start; passage text = title+sentences joined
            passages.append(self.collectionX[pid])
            pids.append(pid)
        scores = self._score(
            self.paramsL1, full_query,
            [" [MASK] ".join(p) for p in passages],
        )  # [n_passages, S]
        flat = []
        for row, pid in enumerate(pids):
            n_sents = len(self.collectionX[pid]) - 1  # exclude title
            for sid in range(min(n_sents, scores.shape[1])):
                flat.append((float(scores[row, sid]), pid, sid))
        flat.sort(reverse=True)
        topk = [(pid, sid) for _, pid, sid in flat[: cfg.stage1_topk]]
        return _dedupe(list(map(tuple, backs)) + topk)[: cfg.stage1_topk]

    def _stage2(self, query: str, preds):
        """Joint rescoring; keep positive scores, ≥ min_facts, ≤ max_docs
        distinct pids (`condense.py:115-140`)."""
        cfg = self.config
        # keep (key, text) together: scores index the FILTERED fact list, so
        # a pred missing from collectionY must drop its key too, not shift
        # every later pairing
        kept = [(k, self.collectionY[k]) for k in preds if k in self.collectionY]
        facts = [t for _, t in kept]
        joint = " [MASK] ".join([""] + facts)
        scores = self._score(self.paramsL2, query, [joint])[0]
        scored = sorted(
            [(float(scores[i]), kept[i][0]) for i in range(len(kept))],
            reverse=True,
        )[: cfg.stage2_keep]
        if not scored:
            return [], []
        # at least min_facts facts survive: everything above
        # min(0, min_facts-th best − ε) — the reference hardcodes 2
        # (`condense.py:129`), kept as the config default
        nth = min(cfg.min_facts, len(scored)) - 1
        floor = min(0.0, scored[nth][0] - 1e-10)
        l3x = [k for s, k in scored if s > floor]
        keep_pids = _dedupe([pid for pid, _ in l3x])[: cfg.max_docs]
        l3x = [(pid, sid) for pid, sid in l3x if pid in keep_pids]
        positives = [k for s, k in scored if s > 0]
        return positives, l3x


@dataclasses.dataclass
class HopConfig:
    """Per-hop search depth (`baleen/hop_searcher.py:14-32`)."""

    ncandidates: int = 64
    per_hop_k: Tuple[int, ...] = (25, 10)


class HopSearcher:
    """Dense search with a hop-dependent k (`baleen/hop_searcher.py`)."""

    def __init__(self, searcher, hop_config: Optional[HopConfig] = None):
        self.searcher = searcher
        self.hop_config = hop_config or HopConfig()

    def search(self, Q, hop: int):
        k = self.hop_config.per_hop_k[
            min(hop, len(self.hop_config.per_hop_k) - 1)
        ]
        doc_ids, scores = self.searcher.search(Q)
        return [ids[:k] for ids in doc_ids], scores[:, :k]


class BaleenEngine:
    """`baleen/engine.py:14-58`: hop → search → condense → extend query.

    ``docid_to_pid`` translates the searcher's (free-form string) doc ids
    into the condenser collection's integer pids; the default strips
    non-digits (covers both bare-integer ids and 'd123'-style test ids) and
    unknown ids are dropped rather than crashing the hop."""

    def __init__(self, hop_searcher: HopSearcher, condenser: Condenser,
                 encode_query, num_hops: int = 2, docid_to_pid=None):
        self.hop_searcher = hop_searcher
        self.condenser = condenser
        self.encode_query = encode_query  # (text, facts) -> Q embeddings
        self.num_hops = num_hops
        self.docid_to_pid = docid_to_pid or self._default_docid_to_pid

    @staticmethod
    def _default_docid_to_pid(doc_id) -> Optional[int]:
        s = str(doc_id)
        digits = "".join(c for c in s if c.isdigit())
        return int(digits) if digits else None

    def search(self, query: str):
        facts: List[Tuple[int, int]] = []
        stage2_facts = []
        pids_seen: List[int] = []
        for hop in range(self.num_hops):
            Q = self.encode_query(query, [self.condenser.collectionY[k]
                                          for k in facts
                                          if k in self.condenser.collectionY])
            doc_ids, _ = self.hop_searcher.search(Q, hop)
            ranking = [
                pid for pid in (self.docid_to_pid(d) for d in doc_ids[0])
                if pid is not None and pid in self.condenser.collectionX
            ]
            pids_seen.extend(ranking)
            _, stage2_facts, facts = self.condenser.condense(
                query, facts, ranking
            )
        return {
            "facts": facts,
            "positive_facts": stage2_facts,
            "pids": _dedupe(pids_seen),
        }
