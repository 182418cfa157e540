"""The OK-VQA full-context rerankers as published (listwise, pointwise softmax,
monoBERT, the three retrieval-sampled training variants) and the synthetic
full-context rerankers at their larger width and under QAT against the JAX
package, by ``tests/test_torch_configs.py``'s cases and tolerances (its
docstring says what they hold and cut)."""

import pytest

pytest.importorskip("torch")

from test_torch_configs import big_dump, check_test, check_train  # noqa: E402, F401

CONFIGS = [
    "okvqa_rerank_full_context_listwise.json",
    "okvqa_rerank_pointwise_softmax.json",
    "okvqa_rerank_monobert.json",
    "okvqa_rerank_train_on_listwise_retrieval.json",
    "okvqa_rerank_train_on_raw_retrieval.json",
    "okvqa_rerank_train_on_sampled_retrieval.json",
    "synth_rerank_full_context_big.json",
    "synth_rerank_full_context_qat.json",
]


@pytest.mark.parametrize("config", CONFIGS)
def test_config_train_matches_jax(tmp_path, monkeypatch, config):
    check_train(tmp_path, monkeypatch, config)


@pytest.mark.parametrize("config", CONFIGS)
def test_config_test_matches_jax(tmp_path, monkeypatch, config, request):
    check_test(tmp_path, monkeypatch, config, request)
