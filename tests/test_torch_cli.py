"""End to end through the port's CLI (``cli/main.py``) on dummy data, under
``RMRT_PLATFORM=cpu``: the port's counterparts of ``tests/test_cli_e2e.py``'s
FLMR train -> test -> eval, reranker train -> test, FLMR train -> test
-> rerank over the FLMR dump, the fusion reranker (with and without
``text_only``), the BLIP-2 decoder reranker, RAG train -> test, and the
interaction reranker over a trained FLMR checkpoint. Each run writes the JAX CLI's artifacts
(``metrics.jsonl``, ``config.json``, ``test_predictions_rank_0.json``), and
the JAX package's metrics processor, run over the port's predictions,
gives the dump's metrics (the same keys and values). Without a card and
without ``RMRT_PLATFORM`` the CLI raises."""

import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

from reranking_multimodal_retrievers_tpu.metrics import MetricsProcessor as JProc  # noqa: E402
from reranking_multimodal_retrievers_tpu.utils import ConfigDict as JConfig  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.cli.main import main  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("RMRT_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)


def _opts(tmp_path):
    return [f"meta.EXPERIMENT_FOLDER='{tmp_path}/experiments'",
            f"data_pipeline.cache_dir='{tmp_path}/cache'"]


def _run(config, mode, tmp_path, *opts):
    return main(["--config", os.path.join(ROOT, "configs", config), "--mode", mode,
                 "--use_dummy_data", "--opts", *_opts(tmp_path), *opts])


def _metrics(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _dump(exp_dir, prefix="test"):
    with open(os.path.join(exp_dir, f"{prefix}_predictions_rank_0.json")) as f:
        return json.load(f)


def _assert_jax_metrics(config, dump):
    """The JAX package's processor over the port's predictions gives the
    dump's metrics."""
    with open(os.path.join(ROOT, "configs", config)) as f:
        cfg = json.load(f)

    class _P(JProc):
        def __init__(self):
            self.config = JConfig({"metrics": cfg["metrics"]})

    Ks = cfg["model_config"].get("Ks", [5, 10, 20, 50, 100])
    want = _P().compute_metrics({"batch_retrieval_result": dump["predictions"], "Ks": Ks})
    assert dump["metrics"] == dict(want.metrics)


def test_flmr_train_then_test_then_eval(cpu, tmp_path):
    assert _run("okvqa_flmr.json", "train", tmp_path, "train.trainer_paras.max_epochs=1") == 0
    exp_dir = str(tmp_path / "experiments" / "okvqa_flmr" / "version_0")
    for name in ("metrics.jsonl", "config.json", "run.log"):
        assert os.path.exists(os.path.join(exp_dir, name)), name
    with open(os.path.join(exp_dir, "ckpts", "index.json")) as f:
        index = json.load(f)
    assert index["checkpoints"] and index["last"]
    assert "pos_item_ids_recall_at_5" in index["checkpoints"][0]["metrics"]

    assert _run("okvqa_flmr.json", "test", tmp_path, f"meta.experiment_dir='{exp_dir}'",
                "test.trainer_paras.limit_test_batches=1") == 0
    dump = _dump(exp_dir)
    assert "recall_at_5" in dump["metrics"]
    assert dump["predictions"][0]["top_ranking_passages"]
    _assert_jax_metrics("okvqa_flmr.json", dump)
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert any("test/recall_at_5" in line for line in lines)

    # eval mode recomputes the metrics from the prediction dump
    assert _run("okvqa_flmr.json", "eval", tmp_path, f"meta.experiment_dir='{exp_dir}'") == 0
    assert _dump(exp_dir, "eval")["metrics"] == dump["metrics"]


def test_reranker_train_then_test(cpu, tmp_path):
    assert _run("okvqa_rerank_full_context.json", "train", tmp_path,
                "train.trainer_paras.max_epochs=1",
                "train.trainer_paras.limit_train_batches=2") == 0
    exp_dir = str(tmp_path / "experiments" / "okvqa_rerank_full_context" / "version_0")
    assert _run("okvqa_rerank_full_context.json", "test", tmp_path,
                f"meta.experiment_dir='{exp_dir}'",
                "test.trainer_paras.limit_test_batches=1") == 0
    dump = _dump(exp_dir)
    assert "raw_recall_at_5" in dump["metrics"]
    assert "pos_item_ids_raw_recall_at_5" in dump["metrics"]
    _assert_jax_metrics("okvqa_rerank_full_context.json", dump)


def test_retrieve_then_rerank(cpu, tmp_path):
    """FLMR train -> test -> the cross-encoder reranks the FLMR dump (the
    JAX package's EVQA end-to-end case)."""
    assert _run("evqa_flmr.json", "train", tmp_path, "train.trainer_paras.max_epochs=1") == 0
    flmr_dir = str(tmp_path / "experiments" / "evqa_flmr" / "version_0")
    assert _run("evqa_flmr.json", "test", tmp_path, f"meta.experiment_dir='{flmr_dir}'",
                "test.trainer_paras.limit_test_batches=2") == 0
    retrieve_dump = os.path.join(flmr_dir, "test_predictions_rank_0.json")

    rr_dir = str(tmp_path / "experiments" / "evqa_rerank_full_context" / "version_0")
    assert _run("evqa_rerank_full_context.json", "test", tmp_path,
                f"meta.experiment_dir='{rr_dir}'",
                f"model_config.retrieve_result_path='{retrieve_dump}'",
                "test.trainer_paras.limit_test_batches=2") == 0
    dump = _dump(rr_dir)
    assert "recall_at_5" in dump["metrics"] and "raw_recall_at_5" in dump["metrics"]
    assert not any(p.get("static_retrieval_missing") for p in dump["predictions"])
    retrieved = {p["question_id"]: [d["passage_id"] for d in p["top_ranking_passages"]]
                 for p in _dump(flmr_dir)["predictions"]}
    for p in dump["predictions"]:  # the raw list is the FLMR dump's ranking
        raw = [d["passage_id"] for d in p["raw_top_ranking_passages"]]
        assert raw[:len(retrieved[p["question_id"]])] == retrieved[p["question_id"]][:len(raw)]
    _assert_jax_metrics("evqa_rerank_full_context.json", dump)


@pytest.mark.parametrize("text_only", [False, True])
def test_fusion_reranker_train_then_test(cpu, tmp_path, text_only):
    """The spliced reranker under PreFLMR attention fusion (the frozen
    retriever's token scores bias the cross-encoder), with and without
    ``text_only`` (then no pixels anywhere)."""
    with open(os.path.join(ROOT, "configs", "okvqa_rerank_fusion.json")) as f:
        cfg = json.load(f)
    if text_only:
        cfg["model_config"]["modules"].append("text_only")
    path = str(tmp_path / "fusion.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    run = ["--config", path, "--use_dummy_data", "--opts", *_opts(tmp_path)]
    assert main(["--mode", "train", *run, "train.trainer_paras.max_epochs=1",
                 "train.trainer_paras.limit_train_batches=2"]) == 0
    exp_dir = str(tmp_path / "experiments" / "okvqa_rerank_fusion" / "version_0")
    assert main(["--mode", "test", *run, f"meta.experiment_dir='{exp_dir}'",
                 "test.trainer_paras.limit_test_batches=1"]) == 0
    dump = _dump(exp_dir)
    assert "recall_at_5" in dump["metrics"] and dump["predictions"][0]["top_ranking_passages"]
    _assert_jax_metrics("okvqa_rerank_fusion.json", dump)


def test_blip2_decoder_reranker_train_then_test(cpu, tmp_path):
    """monoBLIP-2 (Flan-T5 with LoRA) through the decoder branch."""
    config = "okvqa_rerank_decoder_blip2.json"
    assert _run(config, "train", tmp_path, "train.trainer_paras.max_epochs=1",
                "train.trainer_paras.limit_train_batches=2") == 0
    exp_dir = str(tmp_path / "experiments" / "okvqa_rerank_decoder_blip2" / "version_0")
    losses = [r["loss"] for r in _metrics(exp_dir) if "loss" in r]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert _run(config, "test", tmp_path, f"meta.experiment_dir='{exp_dir}'",
                "test.trainer_paras.limit_test_batches=1") == 0
    dump = _dump(exp_dir)
    assert "recall_at_5" in dump["metrics"]
    assert all(0.0 <= p["score"] <= 1.0 for p in dump["predictions"][0]["top_ranking_passages"])
    _assert_jax_metrics(config, dump)


def test_rag_train_then_test(cpu, tmp_path):
    """RAG with the BLIP-2 generator: the RAG-sequence loss, then per-doc
    greedy generation scored by exact match."""
    config = "okvqa_rag_blip2.json"
    assert _run(config, "train", tmp_path, "train.trainer_paras.max_epochs=1",
                "valid.trainer_paras.limit_val_batches=0") == 0
    exp_dir = str(tmp_path / "experiments" / "okvqa_rag_blip2" / "version_0")
    losses = [r["loss"] for r in _metrics(exp_dir) if "loss" in r]
    assert losses and all(math.isfinite(x) for x in losses)
    assert _run(config, "test", tmp_path, f"meta.experiment_dir='{exp_dir}'",
                "test.trainer_paras.limit_test_batches=1") == 0
    dump = _dump(exp_dir)
    assert "exact_match_at_1" in dump["metrics"] and "exact_match_at_5" in dump["metrics"]
    entry = dump["predictions"][0]
    assert len(entry["per_doc_predictions"]) == len(entry["loss_with_doc_scores"]) == 5
    assert entry["prediction"] in entry["per_doc_predictions"]


def test_interaction_reranker_over_a_trained_retriever(cpu, tmp_path):
    """FLMR train, then the interaction reranker with that checkpoint as its
    frozen retriever (``retriever_model_path``); a retriever config the
    checkpoint does not fit raises before anything runs."""
    assert _run("okvqa_flmr.json", "train", tmp_path, "train.trainer_paras.max_epochs=1",
                "train.trainer_paras.limit_train_batches=1",
                "valid.trainer_paras.limit_val_batches=0") == 0
    flmr_dir = tmp_path / "experiments" / "okvqa_flmr" / "version_0"
    with open(flmr_dir / "ckpts" / "index.json") as f:
        ckpt = str(flmr_dir / "ckpts" / json.load(f)["last"])
    # the reranker config's flmr has okvqa_flmr.json's parameters
    config, path = "okvqa_rerank_interaction.json", f"model_config.retriever_model_path='{ckpt}'"
    rr_dir = str(tmp_path / "experiments" / "okvqa_rerank_interaction" / "version_0")
    assert _run(config, "test", tmp_path, path, f"meta.experiment_dir='{rr_dir}'",
                "test.trainer_paras.limit_test_batches=1") == 0
    _assert_jax_metrics(config, _dump(rr_dir))
    with pytest.raises(ValueError, match="retriever_model_path"):
        _run(config, "test", tmp_path, path, "model_config.flmr.text_config.num_hidden_layers=1",
             "test.trainer_paras.limit_test_batches=1")


def test_prepare_data_mode(cpu, tmp_path):
    assert _run("okvqa_flmr.json", "prepare_data", tmp_path) == 0


def test_cli_refuses_without_a_card(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("RMRT_PLATFORM", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run("okvqa_flmr.json", "train", tmp_path)
    assert not (tmp_path / "experiments").exists()  # before any experiment is made
    monkeypatch.setenv("RMRT_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="RMRT_PLATFORM"):
        _run("okvqa_flmr.json", "train", tmp_path)


def test_cli_refuses_several_devices(cpu, tmp_path, monkeypatch):
    # more devices than cards (none without RMRT_PLATFORM=cpu on a machine
    # without one): the mesh's overask error
    monkeypatch.delenv("RMRT_PLATFORM")
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are present")
    with pytest.raises(ValueError, match="devices"):
        main(["--config", os.path.join(ROOT, "configs", "okvqa_flmr.json"), "--mode", "train",
              "--use_dummy_data", "--n_devices", "2", "--opts", *_opts(tmp_path)])
