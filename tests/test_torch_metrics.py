"""The port's metrics (``metrics/{processors,eval_recorder,retrieval_metrics,
vqa_accuracy}.py``) against the JAX package's on the same seeded prediction
dicts: every processor's metrics dict equal (no tolerance: the same Python
and numpy arithmetic), the recorder's files readable by either package, and
the JAX package's own metric cases of ``tests/test_framework_core.py`` run
once more with their imports pointed at the port."""

import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reranking_multimodal_retrievers_tpu.metrics import EvalRecorder as JRecorder  # noqa: E402
from reranking_multimodal_retrievers_tpu.metrics import MetricsProcessor as JProc  # noqa: E402
from reranking_multimodal_retrievers_tpu.metrics import retrieval_metrics as jrm  # noqa: E402
from reranking_multimodal_retrievers_tpu.metrics import vqa_accuracy as jvqa  # noqa: E402
from reranking_multimodal_retrievers_tpu.utils import ConfigDict as JConfig  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.metrics import EvalRecorder  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.metrics import MetricsProcessor  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.metrics import retrieval_metrics as rm  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.metrics import vqa_accuracy as vqa  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.utils import ConfigDict  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
WORDS = ["paris", "rome", "two", "three", "dog", "cat", "red", "blue", "the", "a", "an",
         "capital", "city", "of", "is", "Paris!", "2", "none"]


def _proc(cls, cfg_cls, name, modules=()):
    class _P(cls):
        def __init__(self):
            self.config = cfg_cls({"metrics": [{"name": name}],
                                   "model_config": {"modules": list(modules)}})

    return _P()


def _text(rng, n):
    return " ".join(rng.choice(WORDS) for _ in range(n))


def _passages(rng, n):
    return [{"passage_id": f"p{rng.randrange(30)}", "content": _text(rng, 6),
             "score": rng.random()} for _ in range(n)]


def _retrieval_batch(seed, n=12, k=10):
    rng = random.Random(seed)
    out = []
    for qi in range(n):
        answers = [rng.choice(WORDS) for _ in range(rng.randrange(1, 4))]
        out.append({
            "question_id": f"q{qi}",
            "top_ranking_passages": _passages(rng, k),
            "raw_top_ranking_passages": _passages(rng, k),
            "answers": answers,
            "gold_answer": answers[0],
            "pos_item_ids": [f"p{rng.randrange(30)}" for _ in range(rng.randrange(1, 3))],
        })
    return out


def _data(name, seed):
    rng = random.Random(seed)
    n = 10
    if name.startswith("compute_rerank_DPR") or name.startswith("compute_DPR"):
        return {"batch_retrieval_result": _retrieval_batch(seed), "Ks": [1, 3, 5, 10]}
    if name in ("compute_accuracy", "compute_okvqa_scores"):
        answers = [[rng.choice(WORDS) for _ in range(10)] for _ in range(n)]
        preds = [rng.choice(WORDS) for _ in range(n)]
        if name == "compute_accuracy":
            answers = [rng.choice(WORDS) for _ in range(n)]
        return {"predictions": preds, "answers": answers}
    if name == "compute_exact_match":
        return {
            "batch_answers": [[rng.choice(WORDS) for _ in range(3)] for _ in range(n)],
            "batch_generation_outputs_for_docs": [[rng.choice(WORDS) for _ in range(5)]
                                                  for _ in range(n)],
            "batch_loss_with_doc_scores": [[rng.random() for _ in range(5)] for _ in range(n)],
            "predictions": [rng.choice(WORDS) for _ in range(n)],
            "answers": [[rng.choice(WORDS)] for _ in range(n)],
        }
    if name == "compute_exact_match_simple":
        return {"predictions": [rng.choice(WORDS) for _ in range(n)],
                "answers": [[rng.choice(WORDS), rng.choice(WORDS)] for _ in range(n)]}
    if name == "compute_exact_match_with_numeric_values":
        return {
            "batch_answers": [[rng.choice(WORDS), "12"] for _ in range(n)],
            "batch_predictions": [rng.choice(["12", "13.5", "dog", "7"]) for _ in range(n)],
            "batch_numeric_ranges": [rng.choice([None, [10, 14], [0, 1]]) for _ in range(n)],
        }
    if name == "compute_retrieval_metrics":
        return {
            "batch_answers": [[rng.choice(WORDS) for _ in range(3)] for _ in range(n)],
            "batch_question_ids": [f"q{i}" for i in range(n)],
            "batch_retrieved_docs": [[{"content": _text(rng, 5), "title": f"t{rng.randrange(5)}"}
                                      for _ in range(4)] for _ in range(n)],
            "batch_generation_outputs_for_docs": [[rng.choice(WORDS) for _ in range(4)]
                                                  for _ in range(n)],
            "batch_loss_with_doc_scores": [[rng.random() for _ in range(4)] for _ in range(n)],
            "triplet_ref_ids": {f"q{i}": [f"t{rng.randrange(5)}"] for i in range(n)},
        }
    if name == "compute_BLEU_scores":
        return {"predictions": [_text(rng, 7) for _ in range(n)],
                "references": [[_text(rng, 7), _text(rng, 6)] for _ in range(n)]}
    raise KeyError(name)


PROCESSORS = [
    ("compute_DPR_scores", ()),
    ("compute_DPR_scores_with_pos_ids", ()),
    ("compute_rerank_DPR_scores", ()),
    ("compute_rerank_DPR_scores_with_pos_ids", ()),
    ("compute_accuracy", ()),
    ("compute_okvqa_scores", ()),
    ("compute_exact_match", ()),
    ("compute_exact_match_simple", ()),
    ("compute_exact_match_with_numeric_values", ()),
    ("compute_retrieval_metrics", ()),
    ("compute_retrieval_metrics", ("add_null_document",)),
    ("compute_retrieval_metrics", ("use_triplet_in_retrieval_metrics",)),
    ("compute_BLEU_scores", ()),
]


@pytest.mark.parametrize("name,modules", PROCESSORS,
                         ids=[f"{n}{'-' + m[0] if m else ''}" for n, m in PROCESSORS])
@pytest.mark.parametrize("seed", [0, 1])
def test_processor_equals_jax(name, modules, seed):
    method = "compute_exact_match" if name == "compute_exact_match_simple" else name
    data = _data(name, seed)
    got = _proc(MetricsProcessor, ConfigDict, method, modules).compute_metrics(data)
    want = _proc(JProc, JConfig, method, modules).compute_metrics(data)
    assert got.metrics and dict(got.metrics) == dict(want.metrics)
    assert dict(got.artifacts) == dict(want.artifacts)


def test_vqa_helpers_equal_jax():
    rng = random.Random(3)
    texts = ["The two dogs!", "a Cat's  toy.", "none", "1,000 red-blue", "Paris? yes",
             "it's 3:45", *(_text(rng, 4) for _ in range(20))]
    for t in texts:
        assert vqa.normalize_answer(t) == jvqa.normalize_answer(t)
        assert vqa.process_punctuation(t) == jvqa.process_punctuation(t)
        assert vqa.process_digit_article(t) == jvqa.process_digit_article(t)
    assert vqa.TextCleaner().clean_texts(texts) == jvqa.TextCleaner().clean_texts(texts)
    for t in texts:
        humans = [rng.choice(texts) for _ in range(10)]
        assert vqa.vqa_accuracy(t, humans) == jvqa.vqa_accuracy(t, humans)


def test_ranking_helpers_equal_jax():
    rel = (np.random.default_rng(0).random((16, 20)) < 0.2).astype(np.float64)
    for k in (1, 5, 20):
        for fn in ("recall_at_k", "precision_at_k", "ndcg_at_k", "map_at_k"):
            assert getattr(rm, fn)(rel, k) == getattr(jrm, fn)(rel, k)


@pytest.mark.parametrize("file_format", ["json", "pkl"])
def test_recorder_files_cross_read(tmp_path, file_format):
    rows = _retrieval_batch(5, n=4)
    rec = EvalRecorder(name="test-evaluation", base_dir=str(tmp_path))
    for r in rows:
        rec.log_sample_dict(r)
    rec.log_stats_dict({"recall_at_5": 0.5})
    rec.save_to_disk(file_format=file_format)
    back = JRecorder.load_from_disk("test-evaluation", str(tmp_path), file_format=file_format)
    assert back.get_rows() == rec.get_rows() and back.meta == rec.meta
    assert back.stats_logs == rec.stats_logs


FRAMEWORK_CASES = [
    "test_compute_DPR_scores",
    "test_compute_rerank_DPR_scores_with_pos_ids",
    "test_vqa_accuracy_normalization",
    "test_retrieval_metric_helpers",
    "test_eval_recorder_roundtrip",
    "test_eval_recorder_multipass_and_column_merge",
    "test_compute_exact_match_beam_variant",
    "test_compute_exact_match_simple_fallback",
    "test_compute_exact_match_with_numeric_values",
    "test_compute_retrieval_metrics_rag_contract",
    "test_compute_retrieval_metrics_null_document_flag",
    "test_compute_retrieval_metrics_triplet_flag",
]


def _framework_cases():
    """``tests/test_framework_core.py`` compiled with its imports pointed at
    the port."""
    path = os.path.join(HERE, "test_framework_core.py")
    with open(path) as f:
        src = f.read().replace("reranking_multimodal_retrievers_tpu.",
                               "reranking_multimodal_retrievers_tpu_torch.")
    ns = {"__name__": "port_test_framework_core"}
    exec(compile(src, path, "exec"), ns)
    return ns


@pytest.mark.parametrize("case", FRAMEWORK_CASES)
def test_jax_metric_case_on_port(case, tmp_path):
    ns = _framework_cases()
    fn = ns[case]
    assert ns["MetricsProcessor"].__module__.startswith("reranking_multimodal_retrievers_tpu_torch.")
    kwargs = {"tmp_path": tmp_path} if "tmp_path" in fn.__code__.co_varnames else {}
    fn(**kwargs)


def test_observability_on_the_cpu(tmp_path):
    """``utils/observability.py``: the metric history, a ``torch.profiler``
    trace written where asked, the wandb gate closed without the config's
    flag, and no card statistics without a card."""
    from reranking_multimodal_retrievers_tpu_torch.utils import observability as obs

    hist = obs.MetricsHistoryLogger()
    hist.log_metrics({"loss": 1.5}, step=1)
    hist.log_metrics({"loss": 0.5}, step=2)
    assert hist.series("loss") == [(1, 1.5), (2, 0.5)] and hist.latest("loss") == 0.5
    with obs.profile_trace(str(tmp_path), label="probe"):
        torch.ones(8).sum()
    assert (tmp_path / "probe.json").stat().st_size > 0
    cfg = ConfigDict({"meta": {"logger_enable": ["metrics_history"]}})
    run = obs.maybe_wandb(cfg)
    run.log({"x": 1})  # the no-op recorder
    assert obs.manage_wandb_runs(cfg) is None
    if not torch.cuda.is_available():
        assert obs.device_memory_stats() == {}
