"""The BLIP-2 decoder rerankers as published: over M2KR, the OK-VQA textgen
models (seq2seq without the yes/no head) and the larger synthetic Flan-T5
and OPT ones against the JAX package, by ``tests/test_torch_configs.py``'s
cases and tolerances (its docstring says what they hold and cut)."""

import pytest

pytest.importorskip("torch")

from test_torch_configs import big_dump, check_test, check_train  # noqa: E402, F401

CONFIGS = [
    "evqa_rerank_decoder_blip2.json",
    "okvqa_rerank_decoder_blip2_textgen.json",
    "okvqa_rerank_decoder_blip2_opt_textgen.json",
    "synth_rerank_decoder_blip2_t5_big.json",
    "synth_rerank_decoder_blip2_opt_big.json",
]


@pytest.mark.parametrize("config", CONFIGS)
def test_config_train_matches_jax(tmp_path, monkeypatch, config):
    check_train(tmp_path, monkeypatch, config)


@pytest.mark.parametrize("config", CONFIGS)
def test_config_test_matches_jax(tmp_path, monkeypatch, config, request):
    check_test(tmp_path, monkeypatch, config, request)
