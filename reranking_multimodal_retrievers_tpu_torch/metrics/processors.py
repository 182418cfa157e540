"""Metrics processors.

Parity with the reference ``MetricsProcessor`` mixin
(`src/metrics/metrics_processors.py:39-890`): ``compute_metrics`` dispatches
on a config list of ``{'name': <method>, ...}`` modules, each method consumes
a ``data_dict`` (typically ``batch_retrieval_result`` + ``Ks``) and updates
``log_dict['metrics']``. Metric semantics are kept identical (answer-string
containment for pseudo-relevance, positive-id hits for ground truth, reranked
*and* raw lists side-by-side for the rerank variants).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List

import numpy as np

from ..utils.config_system import ConfigDict
from .vqa_accuracy import TextCleaner, okvqa_scores


def _pseudo_relevance_counts(passages, answers, gold_answer, K):
    found, found_gold = 0, 0
    for p in passages[:K]:
        content = p["content"].lower()
        if any(a.lower() in content for a in answers):
            found += 1
        if gold_answer and gold_answer.lower() in content:
            found_gold += 1
    return found, found_gold


def _pos_id_hits(passages, pos_ids, K):
    return [1 if p["passage_id"] in pos_ids else 0 for p in passages[:K]]


class MetricsProcessor:
    """Mixin: subclasses define ``self.config.metrics`` (list of modules)."""

    def compute_metrics(self, data_dict) -> ConfigDict:
        log_dict = ConfigDict(metrics={}, artifacts={})
        for module in self.config.metrics:
            fn = getattr(self, module["name"], None)
            if fn is None:
                raise ValueError(f"Unknown metric: {module['name']}")
            log_dict = fn(module, data_dict, log_dict)
        return log_dict

    # ------------------------------------------------------- simple QA
    def compute_accuracy(self, module, data_dict, log_dict):
        preds = data_dict["predictions"]
        golds = data_dict["answers"]
        acc = float(np.mean([p == g for p, g in zip(preds, golds)]))
        log_dict.metrics["accuracy"] = acc
        return log_dict

    def compute_exact_match(self, module, data_dict, log_dict):
        """Beam-ranked exact match over per-doc generations (reference
        `:90-142`): rank each query's per-doc answer proposals by their doc
        loss (ascending — lower loss ⇒ higher confidence), dedupe, and report
        ``exact_match_at_{1..5}`` = whether any of the top-i cleaned proposals
        is in the cleaned gold answer list. Falls back to plain top-1 EM when
        no per-doc generations are available."""
        if "batch_generation_outputs_for_docs" not in data_dict:
            preds = data_dict["predictions"]
            answer_lists = data_dict["answers"]
            em = float(
                np.mean(
                    [
                        any(p.strip().lower() == a.strip().lower() for a in answers)
                        for p, answers in zip(preds, answer_lists)
                    ]
                )
            )
            log_dict.metrics["exact_match"] = em
            return log_dict

        cleaner = TextCleaner()
        n_beams = 5
        em_at = {f"exact_match_at_{b + 1}": [] for b in range(n_beams)}
        for answer_list, proposals, doc_losses in zip(
            data_dict["batch_answers"],
            data_dict["batch_generation_outputs_for_docs"],
            data_dict["batch_loss_with_doc_scores"],
        ):
            answer_list = cleaner.clean_texts(answer_list)
            proposals = cleaner.clean_texts(proposals)
            ranked = []
            for idx in np.argsort(doc_losses):
                if proposals[idx] not in ranked:
                    ranked.append(proposals[idx])
            # the reference's running flag: once a hit is seen at beam i,
            # every deeper beam also counts as a hit
            hit = 0
            for i in range(n_beams):
                if i < len(ranked) and ranked[i] in answer_list:
                    hit = 1
                em_at[f"exact_match_at_{i + 1}"].append(hit)
        for name, vals in em_at.items():
            log_dict.metrics[name] = float(np.mean(np.array(vals)))
        return log_dict

    def compute_exact_match_with_numeric_values(self, module, data_dict, log_dict):
        """Infoseek exact match (reference `:143-197`): a prediction is
        correct if its cleaned text is in the cleaned answer list OR parses
        as a float inside the per-question ``numeric_range`` [lo, hi]."""
        cleaner = TextCleaner()
        correct_flags = []
        for answer_list, prediction, numeric_range in zip(
            data_dict["batch_answers"],
            data_dict["batch_predictions"],
            data_dict["batch_numeric_ranges"],
        ):
            proposal = prediction["answer"] if isinstance(prediction, dict) else prediction
            proposal = cleaner.clean_texts([proposal.lower()])[0]
            answer_list = cleaner.clean_texts([a.lower() for a in answer_list])
            correct = proposal in answer_list
            if not correct and numeric_range is not None:
                try:
                    v = float(proposal)
                    correct = numeric_range[0] <= v <= numeric_range[1]
                except (TypeError, ValueError):
                    pass
            correct_flags.append(1 if correct else 0)
        log_dict.metrics["accuracy"] = float(np.mean(np.array(correct_flags)))
        return log_dict

    def compute_okvqa_scores(self, module, data_dict, log_dict):
        scores = okvqa_scores(data_dict["predictions"], data_dict["answers"])
        log_dict.metrics.update(scores)
        return log_dict

    # --------------------------------------------------- retrieval (DPR)
    def compute_DPR_scores(self, module, data_dict, log_dict):
        """Pseudo-relevance recall/precision (reference `:519-580`)."""
        batch_result = data_dict["batch_retrieval_result"]
        Ks = data_dict["Ks"]
        count = len(batch_result)
        res = {k: np.zeros(len(Ks)) for k in
               ("precision", "recall", "gold_precision", "gold_recall")}
        for re_ in batch_result:
            if "answers" not in re_:
                return log_dict
            for i, K in enumerate(Ks):
                f, fg = _pseudo_relevance_counts(
                    re_["top_ranking_passages"], re_["answers"],
                    re_.get("gold_answer", ""), K,
                )
                res["recall"][i] += f > 0
                res["precision"][i] += f / K
                res["gold_recall"][i] += fg > 0
                res["gold_precision"][i] += fg / K
        for name, arr in res.items():
            for i, K in enumerate(Ks):
                log_dict.metrics[f"{name}_at_{K}"] = float(arr[i] / count)
        return log_dict

    def compute_DPR_scores_with_pos_ids(self, module, data_dict, log_dict):
        """Ground-truth positive-id recall/precision (reference `:582-633`)."""
        batch_result = data_dict["batch_retrieval_result"]
        Ks = data_dict["Ks"]
        field = module.get("field", "pos_item_ids")
        count = len(batch_result)
        res = {k: np.zeros(len(Ks)) for k in ("precision", "recall")}
        for re_ in batch_result:
            hit = _pos_id_hits(re_["top_ranking_passages"], re_[field], max(Ks))
            for i, K in enumerate(Ks):
                res["recall"][i] += sum(hit[:K]) > 0
                res["precision"][i] += sum(hit[:K]) / K
        for name, arr in res.items():
            for i, K in enumerate(Ks):
                log_dict.metrics[f"{field}_{name}_at_{K}"] = float(arr[i] / count)
        return log_dict

    # -------------------------------------------------- rerank variants
    def compute_rerank_DPR_scores(self, module, data_dict, log_dict):
        """Reranked AND raw-list pseudo-relevance metrics side-by-side
        (reference `:712-814`) — ``recall_at_5`` here is the paper's
        PRRecall@5 headline metric."""
        batch_result = data_dict["batch_retrieval_result"]
        Ks = data_dict["Ks"]
        count = len(batch_result)
        names = ("precision", "recall", "gold_precision", "gold_recall")
        res = {k: np.zeros(len(Ks)) for k in names}
        res.update({f"raw_{k}": np.zeros(len(Ks)) for k in names})
        for re_ in batch_result:
            if "answers" not in re_:
                return log_dict
            for i, K in enumerate(Ks):
                for prefix, passages in (
                    ("", re_["top_ranking_passages"]),
                    ("raw_", re_["raw_top_ranking_passages"]),
                ):
                    f, fg = _pseudo_relevance_counts(
                        passages, re_["answers"], re_.get("gold_answer", ""), K
                    )
                    res[f"{prefix}recall"][i] += f > 0
                    res[f"{prefix}precision"][i] += f / K
                    res[f"{prefix}gold_recall"][i] += fg > 0
                    res[f"{prefix}gold_precision"][i] += fg / K
        for name, arr in res.items():
            for i, K in enumerate(Ks):
                log_dict.metrics[f"{name}_at_{K}"] = float(arr[i] / count)
        return log_dict

    def compute_rerank_DPR_scores_with_pos_ids(self, module, data_dict, log_dict):
        """Reference `:816-889`."""
        batch_result = data_dict["batch_retrieval_result"]
        Ks = data_dict["Ks"]
        field = module.get("field", "pos_item_ids")
        count = len(batch_result)
        res = {k: np.zeros(len(Ks)) for k in
               ("precision", "recall", "raw_precision", "raw_recall")}
        for re_ in batch_result:
            hit = _pos_id_hits(re_["top_ranking_passages"], re_[field], max(Ks))
            raw_hit = _pos_id_hits(re_["raw_top_ranking_passages"], re_[field], max(Ks))
            for i, K in enumerate(Ks):
                res["recall"][i] += sum(hit[:K]) > 0
                res["precision"][i] += sum(hit[:K]) / K
                res["raw_recall"][i] += sum(raw_hit[:K]) > 0
                res["raw_precision"][i] += sum(raw_hit[:K]) / K
        for name, arr in res.items():
            for i, K in enumerate(Ks):
                log_dict.metrics[f"{field}_{name}_at_{K}"] = float(arr[i] / count)
        return log_dict

    def compute_retrieval_metrics(self, module, data_dict, log_dict):
        """Answer-containment recall/precision over the *retrieved-for-RAG*
        docs plus the retriever-hit breakdown (reference `:199-405`).

        Inputs (the reference's RAG-executor contract): ``batch_answers``,
        ``batch_retrieved_docs`` (list of doc dicts with ``content``/
        ``title``), ``batch_question_ids``, and — for the hit analysis —
        ``batch_generation_outputs_for_docs`` + ``batch_loss_with_doc_scores``
        (per-doc generations and losses, ascending loss = more confident).
        Honors the ``add_null_document`` and ``use_triplet_in_retrieval_metrics``
        module flags; triplet lookup tables come from
        ``data_dict['triplet_ref_ids']`` (question_id → list of relevant
        triplet/passage titles) instead of the reference's FVQA loader attr.
        Falls back to the DPR pseudo-relevance metrics when the RAG fields
        are absent (our retriever executors feed that shape)."""
        if "batch_retrieved_docs" not in data_dict:
            return self.compute_DPR_scores(module, data_dict, log_dict)

        modules = getattr(getattr(self.config, "model_config", ConfigDict()),
                          "modules", []) or []
        batch_answers = data_dict["batch_answers"]
        batch_docs = data_dict["batch_retrieved_docs"]
        question_ids = data_dict.get(
            "batch_question_ids", [None] * len(batch_answers))
        triplet_ref_ids = data_dict.get("triplet_ref_ids", {})

        log_result = {k: [] for k in
                      ("recall", "precision", "gold_precision", "gold_recall")}
        K = 0
        for qid, answer_list, docs in zip(question_ids, batch_answers, batch_docs):
            filtered = [a for a in answer_list if a != ""]
            gold_answer = max(set(filtered), key=filtered.count) if filtered else ""
            unique_answers = list(set(answer_list))
            doc_texts = [d["content"] for d in docs]
            if "add_null_document" in modules:
                doc_texts = doc_texts[1:]
            K = len(doc_texts)
            found, found_gold = [], []
            if "use_triplet_in_retrieval_metrics" in modules:
                ref_ids = triplet_ref_ids.get(qid, [])
                for d in docs:
                    if d.get("title") in ref_ids:
                        found.append(d["title"])
                        found_gold.append(d["title"])
            else:
                for text in doc_texts:
                    low = text.lower()
                    for answer in unique_answers:
                        if answer.lower() in low:
                            found.append(answer)
                            break
                    if gold_answer and gold_answer.lower() in low:
                        found_gold.append(gold_answer)
            log_result["recall"].append(1 if found else 0)
            log_result["precision"].append(len(found) / max(K, 1))
            log_result["gold_recall"].append(1 if found_gold else 0)
            log_result["gold_precision"].append(len(found_gold) / max(K, 1))

        if "batch_generation_outputs_for_docs" in data_dict:
            cleaner = TextCleaner()
            hits = {k: [] for k in (
                "successful_hit", "successful_no_hit",
                "failed_hit", "failed_no_hit",
                "selected_successful_hit", "selected_successful_no_hit",
                "selected_failed_hit", "selected_failed_no_hit")}
            for answer_list, docs, proposals, doc_losses in zip(
                batch_answers, batch_docs,
                data_dict["batch_generation_outputs_for_docs"],
                data_dict["batch_loss_with_doc_scores"],
            ):
                doc_texts = [d["content"] for d in docs]
                order = np.argsort(doc_losses)
                answer_list = cleaner.clean_texts(answer_list)
                proposals = cleaner.clean_texts(proposals)
                # faithful reference quirk (`:249-258`): the proposal is
                # cleaned/lowercased but the doc text is raw, so containment
                # misses case-mismatched mentions — kept identical so the
                # hit-breakdown numbers compare 1:1
                for idx, doc_text in enumerate(doc_texts):
                    em = proposals[idx] in answer_list
                    contain = proposals[idx] in doc_text
                    hits["successful_hit"].append(int(em and contain))
                    hits["successful_no_hit"].append(int(em and not contain))
                    hits["failed_hit"].append(int(not em and contain))
                    hits["failed_no_hit"].append(int(not em and not contain))
                if not len(order):
                    continue
                picked = proposals[order[0]]
                # a query may have a generation but zero retrieved docs (the
                # question-only prompt fallback) — count it as no_hit instead
                # of crashing on an empty doc list
                picked_doc = doc_texts[order[0]] if order[0] < len(doc_texts) else ""
                em = picked in answer_list
                contain = picked in picked_doc
                hits["selected_successful_hit"].append(int(em and contain))
                hits["selected_successful_no_hit"].append(int(em and not contain))
                hits["selected_failed_hit"].append(int(not em and contain))
                hits["selected_failed_no_hit"].append(int(not em and not contain))
            log_result.update(hits)

        for name, vals in log_result.items():
            log_dict.metrics[name] = float(np.mean(np.array(vals))) if vals else 0.0
        # faithful reference quirk (`:403`): K is whatever the LAST query's
        # doc count was — kept for 1:1 metric-dump comparability
        log_dict.metrics["n_retrieved_docs"] = K
        return log_dict

    # ------------------------------------------------------------- BLEU
    def compute_BLEU_scores(self, module, data_dict, log_dict):
        """Corpus BLEU-4 over retrieved-description pairs (reference `:635-710`)."""
        preds = data_dict["predictions"]
        refs = data_dict["references"]
        log_dict.metrics["bleu"] = corpus_bleu(preds, refs)
        return log_dict


def corpus_bleu(predictions: List[str], references: List[List[str]], max_n=4) -> float:
    """Plain corpus BLEU with uniform n-gram weights and brevity penalty."""
    clipped = np.zeros(max_n)
    totals = np.zeros(max_n)
    pred_len, ref_len = 0, 0
    for pred, refs in zip(predictions, references):
        if isinstance(refs, str):
            refs = [refs]
        p_tok = pred.lower().split()
        r_toks = [r.lower().split() for r in refs]
        pred_len += len(p_tok)
        ref_len += min((abs(len(r) - len(p_tok)), len(r)) for r in r_toks)[1]
        for n in range(1, max_n + 1):
            p_ngrams = Counter(tuple(p_tok[i : i + n]) for i in range(len(p_tok) - n + 1))
            max_ref = Counter()
            for r in r_toks:
                r_ngrams = Counter(tuple(r[i : i + n]) for i in range(len(r) - n + 1))
                for g, c in r_ngrams.items():
                    max_ref[g] = max(max_ref[g], c)
            clipped[n - 1] += sum(min(c, max_ref[g]) for g, c in p_ngrams.items())
            totals[n - 1] += max(sum(p_ngrams.values()), 0)
    precisions = [
        clipped[i] / totals[i] if totals[i] > 0 else 0.0 for i in range(max_n)
    ]
    if min(precisions) == 0:
        return 0.0
    log_avg = sum(math.log(p) for p in precisions) / max_n
    bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len / max(pred_len, 1))
    return float(bp * math.exp(log_avg))
