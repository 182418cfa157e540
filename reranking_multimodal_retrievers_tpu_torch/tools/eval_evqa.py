"""Encyclopedic-VQA answer evaluation (port of ``tools/eval_evqa.py``).

Behavior parity with the reference's vendored Google evaluation utilities
(`src/tools/evaluation_utils.py:17-420` + `src/tools/eval_evqa.py`):

- :func:`preprocess_answer` — EVQA-specific normalization (answer-prefix and
  article removal, the EVQA punctuation set, LLM ``<extra_id_0>`` span-prefix
  stripping, digit/contraction standardization incl. entailment→yes);
- :func:`singleanswer_exact_match` / :func:`multianswer_exact_match` — EM
  with ``&&``-separated references, ``,``/`` and ``/`` & ``-split candidates
  and IoU ≥ 0.5 for multi-answer questions;
- :func:`encyclopedic_vqa_evaluation_function` — EM first, then BEM
  (arXiv:2202.07654 answer equivalence).

The reference loads BEM from TF-hub (network + TF). Here
:class:`BEMScorer` is the same interface on the port's BERT
(``models/bert.py``, fp32) -- input ``[CLS] candidate [SEP] reference [SEP]
question [SEP]`` with segment ids 0/1/2 and a 2-class head on the pooler --
loadable from an HF-named BERT-classifier checkpoint directory
(``bert.*``, ``classifier.*``); on the card its attention runs kernel K2's
fp32 path. With no checkpoint, :func:`token_f1` provides the BEM-free
fallback used when scoring offline.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, platform_device, resolve_device
from ..metrics.vqa_accuracy import CONTRACTIONS, normalize_answer
from ..models.bert import BertConfig, BertModel
from ..models.checkpoint_dir import load_checkpoint_dir, load_into
from ..models.init import materialize_

_PUNCTUATION_CHARACTERS = string.punctuation + "‘’´`_"
QUESTION_TYPES = ["templated", "automatic", "multi_answer", "2_hop"]
_DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
    "entailment": "yes", "true": "yes", "contradiction": "no", "false": "no",
}


def preprocess_answer(
    answer: str,
    punctuation_characters: str = _PUNCTUATION_CHARACTERS,
    replacement_character: str = "",
) -> str:
    """Reference `evaluation_utils.py:178-222`."""

    def remove_articles(s):
        return re.sub(r"\b(the answer is|a|an|the)\b", " ", s)

    def replace_punctuation(s):
        to_replace = set(punctuation_characters)
        return "".join(replacement_character if c in to_replace else c for c in s)

    def white_space_fix(s):
        return " ".join(s.split())

    def remove_llm_span_prefix(a, prefix="<extra_id_0> "):
        if a.startswith(prefix):
            return a.replace(prefix, "")
        return a

    def standardize_digits_and_contractions(s):
        words = []
        for w in s.split():
            w = _DIGIT_MAP.get(w, w)
            w = CONTRACTIONS.get(w, w)
            words.append(w)
        return " ".join(words)

    answer = answer.lower()
    answer = remove_llm_span_prefix(answer)
    answer = replace_punctuation(answer)
    answer = remove_articles(answer)
    answer = standardize_digits_and_contractions(answer)
    return white_space_fix(answer)


def singleanswer_exact_match(reference: str, candidate: str) -> bool:
    """Reference `:224-231`."""
    ref = preprocess_answer(reference)
    cand = preprocess_answer(candidate)
    if not ref:
        raise ValueError("Reference answer is empty after preprocessing.")
    return ref == cand


def _list_iou(target_list, prediction_list) -> float:
    if not target_list:
        raise ValueError("Target list should not be empty.")
    t, p = set(target_list), set(prediction_list)
    return len(t & p) / len(t | p)


def multianswer_exact_match(reference: str, candidate: str,
                            iou_threshold: float = 0.5) -> bool:
    """Reference `:257-268`."""
    refs = [preprocess_answer(a) for a in reference.split("&&")]
    refs = [a for a in refs if a]
    if not refs:
        raise ValueError("Reference list is empty after preprocessing.")
    cands = candidate.replace(" and ", ",").replace(" & ", ",").split(",")
    cands = [preprocess_answer(a) for a in cands]
    cands = [a for a in cands if a]
    return _list_iou(refs, cands) >= iou_threshold


def exact_match_scoring_function(example: dict) -> bool:
    """Reference `:271-275`."""
    if example.get("question_type") == "multi_answer":
        return multianswer_exact_match(example["reference"], example["candidate"])
    return singleanswer_exact_match(example["reference"], example["candidate"])


class BEMClassifier(nn.Module):
    """HF ``BertForSequenceClassification``'s layout with two labels:
    ``bert`` (with its pooler) and ``classifier`` on the pooled output."""

    def __init__(self, config: BertConfig, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with torch.device("meta"):
            self.bert = BertModel(config, device="meta")
            self.classifier = nn.Linear(config.hidden_size, 2)
        materialize_(self, device, torch.float32, generator, config.initializer_range)

    def forward(self, input_ids, attention_mask, token_type_ids):
        out = self.bert(input_ids, attention_mask, token_type_ids=token_type_ids)
        return self.classifier(out["pooler_output"])


class BEMScorer:
    """BEM-interface answer-equivalence scorer on the port's BERT (the
    reference's TF-hub BEM role, `evaluation_utils.py:278-367`).

    ``checkpoint_dir`` is an HF-style BERT-classifier directory
    (``.safetensors`` or ``.bin``; e.g. a converted BEM checkpoint), read by
    ``models/checkpoint_dir.py``. A tokenizer with ``cls/sep`` tokens is
    required. Input encoding matches the reference: ``[CLS] candidate [SEP]
    reference [SEP] question [SEP]`` with segment ids 0/1/2 (BEM's BERT
    uses an extended type vocabulary), padded to ``max_length``. The
    default config is BERT-base with 4 token types in fp32, its attention
    through kernel K2 (``use_pallas_attention``; the plain version on the
    CPU). With a checkpoint the model is built on ``meta`` and its tensors
    are read straight into the device's; without one the weights are drawn
    on the CPU from ``generator`` (seed 0 by default), then moved. ``device``: the card by
    default (the CPU under ``RMRT_PLATFORM=cpu``)."""

    def __init__(self, tokenizer, checkpoint_dir: Optional[str] = None,
                 bert_config: Optional[BertConfig] = None, max_length: int = 512, *,
                 device: Optional[DeviceLike] = None,
                 generator: Optional[torch.Generator] = None):
        self.tokenizer = tokenizer
        cfg = bert_config or BertConfig(type_vocab_size=4, use_pallas_attention=True)
        self.max_length = min(max_length, cfg.max_position_embeddings)
        self.device = platform_device() if device is None else resolve_device(device)
        if checkpoint_dir:  # allocated on the device, filled from the checkpoint
            self.model = BEMClassifier(cfg, device="meta").to_empty(device=self.device)
            load_into(self.model, load_checkpoint_dir(checkpoint_dir))
        else:
            generator = generator or torch.Generator().manual_seed(0)
            self.model = BEMClassifier(cfg, device="cpu", generator=generator).to(self.device)
        self.model.eval()

    def _encode(self, example):
        tok = self.tokenizer
        cls_id, sep_id = tok.cls_token_id, tok.sep_token_id
        parts = [
            tok.encode(example["candidate"], add_special_tokens=False),
            tok.encode(example["reference"], add_special_tokens=False),
            tok.encode(example["question"], add_special_tokens=False),
        ]
        ids, segs = [cls_id], [0]
        for i, p in enumerate(parts):
            ids.extend(p + [sep_id])
            segs.extend([i] * (len(p) + 1))
        ids = ids[: self.max_length]
        segs = segs[: self.max_length]
        pad = self.max_length - len(ids)
        am = [1] * len(ids) + [0] * pad
        ids = ids + [0] * pad
        segs = segs + [0] * pad
        return (np.asarray([ids], np.int64), np.asarray([am], np.int64),
                np.asarray([segs], np.int64))

    def encode(self, example: dict):
        """The model's inputs for ``example`` (the list-question rewrite
        included): ``(input_ids, attention_mask, token_type_ids)``, each
        ``[1, max_length]`` int64 numpy."""
        if not example["reference"]:
            raise ValueError("Reference answer cannot be empty.")
        ex = dict(example)
        if ex.get("question_type") in ("list", "multianswer", "multi_answer"):
            ex["reference"] = ex["reference"].replace("&&", ",")
        return self._encode(ex)

    @torch.inference_mode()
    def __call__(self, example: dict, threshold_score: bool = True):
        ids, am, tt = (torch.from_numpy(a).to(self.device) for a in self.encode(example))
        logits = self.model(ids, am, tt)[0]
        score = float(torch.softmax(logits, dim=-1)[1])
        return float(score >= 0.5) if threshold_score else score


def encyclopedic_vqa_evaluation_function(example: dict, bem_scoring_function):
    """Reference `:370-399`: EM first, BEM only on EM misses."""
    if not example["reference"]:
        raise ValueError("Reference answer cannot be empty.")
    if example["question_type"] not in QUESTION_TYPES:
        raise ValueError(f"Unknown question type. Valid options are {QUESTION_TYPES}")
    if exact_match_scoring_function(example):
        return 1.0
    return bem_scoring_function(example, threshold_score=True)


# ----------------------------------------------------------- BEM-free tier
def token_f1(pred: str, gold: str) -> float:
    p = normalize_answer(pred).split()
    g = normalize_answer(gold).split()
    if not p or not g:
        return float(p == g)
    common = Counter(p) & Counter(g)
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(p)
    recall = overlap / len(g)
    return 2 * precision * recall / (precision + recall)


def answers_equivalent(
    prediction: str,
    gold: str,
    question: str = "",
    f1_threshold: float = 0.6,
    bem_fn: Optional[Callable] = None,
) -> bool:
    if normalize_answer(prediction) == normalize_answer(gold):
        return True
    if bem_fn is not None:
        return bool(
            bem_fn(
                {"candidate": prediction, "reference": gold,
                 "question": question, "question_type": "automatic"},
                threshold_score=True,
            )
        )
    return token_f1(prediction, gold) >= f1_threshold


def evqa_scores(
    predictions: List[str],
    golds: List[str],
    questions: Optional[List[str]] = None,
    bem_fn=None,
) -> dict:
    questions = questions or [""] * len(predictions)
    correct = [
        answers_equivalent(p, g, q, bem_fn=bem_fn)
        for p, g, q in zip(predictions, golds, questions)
    ]
    return {
        "evqa_accuracy": sum(correct) / max(len(correct), 1),
        "evqa_mean_f1": sum(token_f1(p, g) for p, g in zip(predictions, golds))
        / max(len(predictions), 1),
    }
