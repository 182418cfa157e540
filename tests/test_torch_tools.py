"""The port's ``tools/`` against the JAX package's: the BEM scorer of
``tools/eval_evqa.py`` from one HF-named checkpoint directory on both
sides, ``tools/convert_checkpoint.py`` (an HF FLMR directory converted by
both packages: the same ``.npz``, and the port's checkpoint scoring a query
as the JAX model does), and a job script of ``tools/submit_jobs.py`` run
end to end on the CPU. The JAX package's own ``tests/test_tools_aux.py``
cases run on the port through ``tests/test_torch_data.py::CASES``.

Tolerances: BEM scores 1e-5 (fp32 on both sides, tiny BERT); the ``.npz``
values equal (the same fp32 numbers, moved); a query's late-interaction
score 1e-5 (fp32 on both sides).
"""

import json
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from reranking_multimodal_retrievers_tpu.models import bert as jbert  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import flmr as jflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu.tools import convert_checkpoint as jconv  # noqa: E402
from reranking_multimodal_retrievers_tpu.tools import eval_evqa as jevqa  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.executors.flmr_executor import (  # noqa: E402
    FLMRExecutor)
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import flmr as tflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.checkpoint_dir import (  # noqa: E402
    write_safetensors)
from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (  # noqa: E402
    tiny_bert_tokenizer)
from reranking_multimodal_retrievers_tpu_torch.tools import convert_checkpoint  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.tools import eval_evqa  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.tools.submit_jobs import render_job  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["what", "animal", "is", "this", "cat", "dog", "bird", "paris", "rome", "city",
         "capital", "of", "france", "and", "which", "colors", "red", "blue"]


def _random_hf_dir(path, module, rng, extra=()):
    """Write ``module``'s state dict, drawn from numpy's ``rng`` (weights of
    std 0.3, LayerNorm scales near 1), as one HF-named ``.safetensors``
    file, with ``extra`` keys the model does not read."""
    sd = {}
    for k, v in module.state_dict().items():
        if k.endswith("weight") and any(n in k for n in ("LayerNorm", "layer_norm", "layrnorm")):
            arr = 1.0 + 0.1 * rng.normal(size=tuple(v.shape))
        else:
            arr = 0.3 * rng.normal(size=tuple(v.shape))
        sd[k] = torch.from_numpy(arr.astype(np.float32))
    for k in extra:
        sd[k] = sd[k.replace("query_", "context_")].clone()
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"), sd)
    return sd


TRIPLES = [
    ("what animal is this", "cat", "dog", "automatic"),
    ("what animal is this", "cat", "cat", "templated"),
    ("which colors", "red && blue", "blue and red", "multi_answer"),
    ("which colors", "red && blue", "red", "multi_answer"),
    ("which colors", "red && blue", "blue, red", "list"),
    ("capital of france", "paris", "rome", "automatic"),
    ("capital of france", "paris", "the paris", "2_hop"),
    ("what city", "rome", "paris city", "automatic"),
    ("what is this", "bird", "a cat and a dog", "templated"),
    ("what is this", "dog", "bird", "automatic"),
    ("which animal", "cat && dog && bird", "bird, cat", "multianswer"),
    ("what city is this", "paris", "rome rome rome", "automatic"),
    ("capital", "rome", "paris", "2_hop"),
    ("what animal", "dog", "dog dog", "templated"),
    ("which colors and animal", "red && dog", "red, cat", "list"),
    ("this", "blue", "red", "automatic"),
]


def test_bem_scores_equal_jax_from_one_checkpoint_dir(tmp_path):
    tok = tiny_bert_tokenizer(str(tmp_path / "tok"), WORDS)
    cfg = tbert.BertConfig.tiny(type_vocab_size=4)
    rng = np.random.default_rng(0)
    path = str(tmp_path / "bem")
    sd = _random_hf_dir(path, eval_evqa.BEMClassifier(cfg, device="meta"), rng)
    examples = [{"question": q, "reference": r, "candidate": c, "question_type": qt}
                for q, r, c, qt in TRIPLES]
    # centre the head's bias on these examples' logit gap, so that both
    # thresholded decisions occur
    probe = eval_evqa.BEMScorer(tok, checkpoint_dir=path, bert_config=cfg, device="cpu")
    with torch.no_grad():
        gaps = [np.diff(probe.model(*map(torch.from_numpy, probe.encode(ex)))[0].numpy())[0]
                for ex in examples]
    sd["classifier.bias"][1] -= float(np.median(gaps))
    write_safetensors(os.path.join(path, "model.safetensors"), sd)
    port = eval_evqa.BEMScorer(tok, checkpoint_dir=path, bert_config=cfg, device="cpu")
    jax_bem = jevqa.BEMScorer(tok, checkpoint_dir=path,
                              bert_config=jbert.BertConfig.tiny(type_vocab_size=4))
    got, want = [], []
    for ex in examples:
        qt = ex["question_type"]
        got.append(port(ex, threshold_score=False))
        want.append(jax_bem(ex, threshold_score=False))
        assert port(ex) == jax_bem(ex)
        if qt in jevqa.QUESTION_TYPES:
            assert (eval_evqa.encyclopedic_vqa_evaluation_function(ex, port)
                    == jevqa.encyclopedic_vqa_evaluation_function(ex, jax_bem))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert 0.1 < np.mean(np.asarray(got) >= 0.5) < 0.9  # both decisions occur
    # the list rewrite: "&&" read as ","
    ids = port.encode({"question": "which colors", "reference": "red && blue",
                       "candidate": "red", "question_type": "list"})[0]
    assert tok.convert_tokens_to_ids(",") in ids[0].tolist()
    assert tok.convert_tokens_to_ids("&") not in ids[0].tolist()
    with pytest.raises(ValueError):
        port({"question": "q", "reference": "", "candidate": "c"})


def test_bem_default_is_bert_base_with_k2(tmp_path):
    tok = tiny_bert_tokenizer(str(tmp_path / "tok"), WORDS)
    bem = eval_evqa.BEMScorer(tok, device="cpu", max_length=32)
    cfg = bem.model.bert.config
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.type_vocab_size) == (768, 12, 4)
    assert cfg.use_pallas_attention and bem.model.classifier.out_features == 2
    assert next(bem.model.parameters()).dtype == torch.float32
    score = bem({"question": "what animal", "reference": "cat", "candidate": "dog"},
                threshold_score=False)
    assert 0.0 <= score <= 1.0


FLMR_CFG = {
    "text_config": {"vocab_size": 1024, "hidden_size": 32, "num_hidden_layers": 2,
                    "num_attention_heads": 4, "intermediate_size": 64,
                    "max_position_embeddings": 128},
    "vision_config": {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                      "num_attention_heads": 4, "image_size": 32, "patch_size": 16},
    "dim": 16, "mapping_network_prefix_length": 4, "use_transformer_mapping_network": True,
    "transformer_mapping_num_hidden_layers": 1,
}


def _scores(q, qm, d, dm):
    """Late-interaction scores [B_q, B_d] in float64 from numpy matrices."""
    q = np.asarray(q, np.float64) * np.asarray(qm, np.float64)[..., None]
    s = np.einsum("qid,njd->qnij", q, np.asarray(d, np.float64))
    s = np.where(np.asarray(dm, bool)[None, :, None, :], s, -1e9)
    return s.max(-1).sum(-1)


def test_convert_and_export_npz_equal_jax(tmp_path):
    config = tmp_path / "flmr.json"
    config.write_text(json.dumps({"model_config": {"flmr": FLMR_CFG}}))
    tcfg = tflmr.FLMRConfig(text_config=tbert.BertConfig(**FLMR_CFG["text_config"]),
                            vision_config=tflmr.CLIPVisionConfig(**FLMR_CFG["vision_config"]),
                            **{k: v for k, v in FLMR_CFG.items() if "_config" not in k})
    rng = np.random.default_rng(1)
    # an HF directory also holds tied aliases the tied model does not read
    sd = _random_hf_dir(str(tmp_path / "hf"), tflmr.FLMRModelForRetrieval(tcfg, device="meta"),
                        rng, extra=["query_text_encoder_linear.weight"])

    jconv.convert_torch_to_jax(str(tmp_path / "hf"), str(tmp_path / "jax"), str(config))
    jconv.export_npz(str(tmp_path / "jax" / "params"), str(tmp_path / "jax.npz"))
    assert convert_checkpoint.main(["--torch_dir", str(tmp_path / "hf"), "--out_dir",
                                    str(tmp_path / "port"), "--config", str(config)]) == 0
    assert convert_checkpoint.main(["--export_npz", str(tmp_path / "port" / "params"),
                                    "--out_dir", str(tmp_path / "port.npz")]) == 0
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files)
    assert any(k.startswith("transformer_mapping_network/layer_0/crossattention/")
               for k in got.files)
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == json.loads(
        (tmp_path / "jax" / "config.json").read_text())

    # the port's checkpoint, loaded by the executor, scores as the JAX model
    ex = object.__new__(FLMRExecutor)
    ex.device = torch.device("cpu")
    ex.global_step = 0
    ex.model = tflmr.FLMRModelForRetrieval(tcfg, device="cpu")
    ex.load_checkpoint(str(tmp_path / "port" / "params"))
    for k, v in ex.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    import orbax.checkpoint as ocp

    params = ocp.PyTreeCheckpointer().restore(str(tmp_path / "jax" / "params"))
    jm = jflmr.FLMRModelForRetrieval(jflmr.FLMRConfig(
        text_config=jbert.BertConfig(**FLMR_CFG["text_config"]),
        vision_config=jflmr.CLIPVisionConfig(**FLMR_CFG["vision_config"]),
        **{k: v for k, v in FLMR_CFG.items() if "_config" not in k}))
    ids = rng.integers(1, 1024, size=(2, 12))
    am = np.ones_like(ids)
    am[1, 9:] = 0
    pix = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    jq = jm.apply({"params": params}, ids, am, pixel_values=pix,
                  method=jflmr.FLMRModelForRetrieval.query)
    jd = jm.apply({"params": params}, ids, am, method=jflmr.FLMRModelForRetrieval.doc)
    with torch.no_grad():
        tq = ex.model.query(torch.as_tensor(ids), torch.as_tensor(am),
                            pixel_values=torch.as_tensor(pix))
        td = ex.model.doc(torch.as_tensor(ids), torch.as_tensor(am))
    want = _scores(jax.device_get(jq.late_interaction_output), jq.query_mask,
                   jax.device_get(jd.late_interaction_output), jd.context_mask)
    got = _scores(tq.late_interaction_output.numpy(), tq.query_mask.numpy(),
                  td.late_interaction_output.numpy(), td.context_mask.numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rendered_job_runs_the_port_cli(tmp_path):
    """A ``--dummy`` train job of ``configs/okvqa_flmr.json`` (the smoke
    caps: 2 batches, 1 epoch) runs the port's CLI to its end under bash on
    the CPU and leaves its metrics."""
    exp = tmp_path / "experiments"
    path = render_job(os.path.join(ROOT, "configs", "okvqa_flmr.json"), "train", "smoke",
                      workdir=str(tmp_path), dummy=True, out_dir=str(tmp_path / "jobs"),
                      opts=[f"meta.EXPERIMENT_FOLDER={exp}",
                            f"data_pipeline.cache_dir={tmp_path / 'cache'}"])
    text = open(path).read()
    assert "python -m reranking_multimodal_retrievers_tpu_torch.cli.main" in text
    assert "limit_train_batches=2" in text and "--use_dummy_data" in text
    env = {**os.environ, "RMRT_PLATFORM": "cpu", "PYTHONPATH": ROOT}
    out = subprocess.run(["bash", path], capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = [p for p in exp.rglob("metrics.jsonl")]
    assert metrics and metrics[0].read_text().strip()
