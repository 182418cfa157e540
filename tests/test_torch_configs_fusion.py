"""The PreFLMR attention-fusion rerankers as published (over M2KR and the
larger synthetic set) and the larger interaction reranker against the JAX
package, by ``tests/test_torch_configs.py``'s cases and tolerances (its
docstring says what they hold and cut)."""

import pytest

pytest.importorskip("torch")

from test_torch_configs import big_dump, check_test, check_train  # noqa: E402, F401

CONFIGS = [
    "evqa_rerank_fusion.json",
    "synth_rerank_fusion_big.json",
    "synth_rerank_interaction_big.json",
]


@pytest.mark.parametrize("config", CONFIGS)
def test_config_train_matches_jax(tmp_path, monkeypatch, config):
    check_train(tmp_path, monkeypatch, config)


@pytest.mark.parametrize("config", CONFIGS)
def test_config_test_matches_jax(tmp_path, monkeypatch, config, request):
    check_test(tmp_path, monkeypatch, config, request)
