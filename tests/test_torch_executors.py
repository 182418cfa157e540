"""The port's executors (``executors/{base,experiment,flmr_executor,
reranker_executor}.py``) against the JAX package's on the same tiny
configs and dummy data, in fp32 on the CPU (JAX at matmul precision
"highest"). JAX's initial weights are carried into the port's models by
``models/weights.py``; the reranker cases cover every family (the encoder
families with and without attention fusion, the interaction rerankers of
both types over the frozen retriever, and the decoder rerankers: native,
BLIP-2 Flan-T5 and BLIP-2 OPT, each as Model A and Model B).

The FLMR executor is evaluated over the bf16 index and over an int8 one
(``use_int8_index``). Tolerances: a training step's ``loss`` and ``ib_loss``, and reranker
logits, within 1e-5 (fp32 round-off through a few layers, as
``test_torch_flmr_train.py``); after one AdamW step every trained parameter
within 2 lr (plus the decay) of JAX's, frozen ones bitwise unchanged (Adam's
first step is about ``lr * sign(g)``, which flips where a gradient is
round-off; ``test_torch_training.py`` says why). Retrieval: every score
within 1e-4 of the largest (both sides round the fp32 queries to the bf16
index's type, and a query element whose two fp32 values straddle a bf16
rounding boundary lands one bf16 spacing, 2^-8 of itself, apart: a few 1e-4
on a score of 16), the top-k ids equal but where two docs' scores lie that
close (a near tie may swap), and the metrics dict equal.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from reranking_multimodal_retrievers_tpu.executors import reranker_executor as jrex  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.executors import reranker_executor as trex  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J, T = "reranking_multimodal_retrievers_tpu", "reranking_multimodal_retrievers_tpu_torch"
NEAR_TIE = 1e-4  # of the largest score


def _executor(pkg, config, workdir, mode, *opts):
    cfgmod = __import__(f"{pkg}.utils.config_system", fromlist=["x"])
    __import__(f"{pkg}.data.ops")
    registry = __import__(f"{pkg}.executors", fromlist=["x"])
    cfg = cfgmod.load_config(os.path.join(ROOT, "configs", config))
    cfgmod.apply_opts(cfg, [f"data_pipeline.cache_dir='{workdir}/cache'",
                            f"meta.experiment_dir='{workdir}/exp'", *opts])
    cfg.set_path("mode", mode)
    cls = getattr(registry, cfg.executor.ExecutorClass)
    kw = {"device": "cpu"} if pkg == T else {}
    return cls(cfg, use_dummy_data=True, **kw)


def _carry_weights(jex, tex):
    """Load the JAX executor's initial weights into the port executor's
    models: the FLMR model, or the reranker (any family) and its frozen
    retriever."""
    params = jax.device_get(jex.params)
    if hasattr(tex, "model"):
        tex.model.load_state_dict(weights.flmr_state_dict(params))
        return
    if jex.retriever is not None:
        tex.retriever.load_state_dict(
            weights.flmr_state_dict(jax.device_get(jex._retriever_params)))
    family = tex.reranker_family
    if family == "interaction":
        tex.reranker.load_state_dict(weights.interaction_rerank_state_dict(params))
        return
    if family == "decoder":
        blip2 = hasattr(tex.reranker_config, "blip2")
        carry = weights.blip2_rerank_state_dict if blip2 else weights.decoder_rerank_state_dict
        tex.reranker.load_state_dict(carry(params))
        return
    missing, unexpected = tex.reranker.load_state_dict(weights.rerank_state_dict(params),
                                                       strict=False)
    # a text-only JAX reranker never ran its vision tower, so flax made no
    # parameters for it; the port builds them, unused
    assert not unexpected
    assert not missing or "text_only" in tex.modules
    assert all(k.startswith(("context_vision_", "transformer_mapping_")) for k in missing)


def _pair(tmp_path, monkeypatch, config, mode, *opts):
    """(JAX executor, port executor) on the same config, the port's models
    holding JAX's initial weights."""
    monkeypatch.chdir(tmp_path)
    jex = _executor(J, config, tmp_path / "jax", mode, *opts)
    tex = _executor(T, config, tmp_path / "port", mode, *opts)
    _carry_weights(jex, tex)
    return jex, tex


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _assert_rankings_match(want, got):
    assert len(want) == len(got)
    tol = NEAR_TIE * max(abs(p["score"]) for w in want for p in w["top_ranking_passages"])
    for w, g in zip(want, got):
        assert w["question_id"] == g["question_id"]
        ws = {p["passage_id"]: p["score"] for p in w["top_ranking_passages"]}
        wl = [p["passage_id"] for p in w["top_ranking_passages"]]
        gl = [p["passage_id"] for p in g["top_ranking_passages"]]
        assert len(wl) == len(gl)
        for rank, (a, b) in enumerate(zip(wl, gl)):
            if a != b:  # a swap is allowed between near-tied docs only
                assert b in ws and abs(ws[a] - ws[b]) <= tol, (w["question_id"], rank)
        gs = np.array([p["score"] for p in g["top_ranking_passages"]])
        np.testing.assert_allclose(gs, [p["score"] for p in w["top_ranking_passages"]],
                                   rtol=0, atol=tol)


# mode "train" builds the train and valid loaders; the synthetic task's
# valid split is its test split
FLMR_OPTS = ("train.batch_size=4", "train.optimizer_config.scheduler_params.num_warmup_steps=0",
             "valid.trainer_paras.limit_val_batches=1", "valid.batch_size=4")


def test_flmr_executor_evaluate_then_train_step_match_jax(tmp_path, monkeypatch):
    jex, tex = _pair(tmp_path, monkeypatch, "synth_flmr_vision.json", "train", *FLMR_OPTS)
    assert tex.id2doc == jex.id2doc and tex.flmr_config.punctuation_token_ids == \
        jex.flmr_config.punctuation_token_ids

    want, got = jex.evaluate("valid"), tex.evaluate("valid")
    _assert_rankings_match(want["batch_retrieval_result"], got["batch_retrieval_result"])
    assert dict(got.metrics) == dict(want.metrics)
    # the same over an int8 index (per-doc scales, int8 queries on both sides)
    for ex in (jex, tex):
        ex.config.set_path("model_config.modules", ["use_int8_index"])
    want, got = jex.evaluate("valid"), tex.evaluate("valid")
    _assert_rankings_match(want["batch_retrieval_result"], got["batch_retrieval_result"])
    assert dict(got.metrics) == dict(want.metrics)
    for ex in (jex, tex):
        ex.config.set_path("model_config.modules", [])

    jb = next(iter(jex.train_dataloader()))
    tb = next(iter(tex.train_dataloader()))
    _assert_batches_equal(jb, tb)
    jex.prepare_training(10)
    tex.prepare_training(10)
    before = {k: v.clone() for k, v in tex.model.state_dict().items()}
    jm, tm = jex.training_step(jb), tex.training_step(tb)
    for k in ("loss", "ib_loss", "total_loss"):
        assert tm[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-5), k
    lr = 5e-4  # the config's, at step 0 without warmup
    after = weights.flmr_state_dict(jax.device_get(jex._train_state.params))
    for name, p in tex.model.named_parameters():
        if "vision_encoder" in name:  # frozen
            assert torch.equal(p.detach(), before[name]), name
            continue
        diff = (p.detach() - after[name]).abs().max()
        assert diff <= 2 * lr * (1 + 0.1 * before[name].abs().max()), name


RERANK_OPTS = ("model_config.docs_to_rerank=12", "valid.trainer_paras.limit_val_batches=1",
               "valid.batch_size=4", "train.batch_size=4")
RETRIEVED = ["train_with_retrieved_docs", "neg_sample_retrieved"]


INTERACTION = ["interaction_reranker", *RETRIEVED]
FUSION = "preflmr_attention_fusion"
DECODER = ["decoder_reranker", *RETRIEVED]


@pytest.mark.parametrize("config,modules,extra", [
    ("synth_rerank_full_context.json", ["full_context_reranker", "text_only", *RETRIEVED], ()),
    ("synth_rerank_full_context_vision.json", ["full_context_reranker", *RETRIEVED], ()),
    ("synth_rerank_full_context.json", ["text_only", *RETRIEVED], ()),
    ("synth_rerank_full_context_vision.json", ["train_with_retrieved_docs"], ()),
    ("synth_rerank_interaction.json", ["text_only", *INTERACTION], ()),
    ("synth_rerank_interaction.json", ["text_only", *INTERACTION],
     ("model_config.interaction_type='CrossEncoder'",)),
    ("synth_rerank_interaction_vision.json", INTERACTION, ()),
    ("synth_rerank_interaction.json", ["text_only", *INTERACTION, FUSION], ()),
    ("synth_rerank_fusion.json", ["text_only", *RETRIEVED, FUSION], ()),
    ("synth_rerank_fusion_vision.json", [*RETRIEVED, FUSION], ()),
    ("okvqa_rerank_decoder.json", DECODER, ()),
    ("okvqa_rerank_decoder.json", DECODER, ("model_config.decoder_head=True",)),
    ("synth_rerank_decoder_blip2_t5.json", DECODER, ()),
    ("synth_rerank_decoder_blip2_t5.json", DECODER, ("model_config.decoder_head=True",)),
    ("okvqa_rerank_decoder_blip2_opt.json", DECODER, ()),
    ("okvqa_rerank_decoder_blip2_opt.json", DECODER, ("model_config.decoder_head=False",)),
], ids=["full_context_text", "full_context_vision", "spliced_text", "spliced_vision_labels",
        "interaction_mores", "interaction_cross_encoder", "interaction_mores_vision",
        "interaction_mores_fusion", "fusion_spliced_text", "fusion_spliced_vision",
        "decoder_native", "decoder_native_head", "decoder_blip2_t5", "decoder_blip2_t5_head",
        "decoder_blip2_opt_head", "decoder_blip2_opt"])
def test_reranker_executor_matches_jax(tmp_path, monkeypatch, config, modules, extra):
    """'full_validation' makes validation the full rerank of the test path."""
    opts = RERANK_OPTS + (f"model_config.modules={modules + ['full_validation']!r}", *extra)
    jex, tex = _pair(tmp_path, monkeypatch, config, "train", *opts)
    assert tex.reranker_family == jex.reranker_family
    assert type(tex.reranker).__name__ == type(jex.reranker).__name__
    if config.startswith("okvqa_"):
        # the dummy OK-VQA images are resized, and the port's bicubic lies
        # within two 8-bit levels of PIL's (test_torch_data.py): both
        # executors read the JAX pipeline's batches
        tex.data_loaders = jex.data_loaders
    assert tex.questionId2topPassages == jex.questionId2topPassages

    want, got = jex.evaluate("valid"), tex.evaluate("valid")
    assert len(got["batch_retrieval_result"]) == len(want["batch_retrieval_result"]) > 0
    for w, g in zip(want["batch_retrieval_result"], got["batch_retrieval_result"]):
        ws = {p["passage_id"]: p["score"] for p in w["top_ranking_passages"]}
        gs = {p["passage_id"]: p["score"] for p in g["top_ranking_passages"]}
        assert ws.keys() == gs.keys()
        np.testing.assert_allclose([gs[k] for k in ws], list(ws.values()), rtol=1e-5, atol=1e-5)
        assert g["raw_top_ranking_passages"] == w["raw_top_ranking_passages"]
    assert dict(got.metrics) == dict(want.metrics)

    # one training step from the same weights on the same sampled docs
    jb = next(iter(jex.train_dataloader()))
    tb = jb if tex.data_loaders is jex.data_loaders else next(iter(tex.train_dataloader()))
    _assert_batches_equal(jb, tb)
    jex.prepare_training(10)
    tex.prepare_training(10)
    assert tex.training_step(tb)["loss"] == pytest.approx(jex.training_step(jb)["loss"],
                                                         rel=1e-5, abs=1e-5)
    if tex.retriever is not None:  # frozen: in no optimizer, never updated
        trained = {id(p) for g in tex._train_state.optimizer.param_groups for p in g["params"]}
        assert not any(id(p) in trained for p in tex.retriever.parameters())
        want_r = weights.flmr_state_dict(jax.device_get(jex._retriever_params))
        for k, v in tex.retriever.state_dict().items():
            assert torch.equal(v, want_r[k]), k


def test_frozen_retriever_checkpoint_must_match(tmp_path, monkeypatch):
    """retriever_model_path: an FLMRExecutor checkpoint is loaded into the
    frozen retriever; one of another FLMR config raises."""
    monkeypatch.chdir(tmp_path)
    flmr = _executor(T, "synth_flmr.json", tmp_path / "f", "train", *FLMR_OPTS)
    flmr.global_step = 3
    flmr.save_checkpoint()
    ckpt = flmr.ckpt_manager.resolve()
    opts = (*RERANK_OPTS, f"model_config.retriever_model_path='{ckpt}'")
    # the interaction config's flmr is synth_flmr.json's
    ex = _executor(T, "synth_rerank_interaction.json", tmp_path / "a", "train", *opts)
    for k, v in flmr.model.state_dict().items():
        assert torch.equal(ex.retriever.state_dict()[k], v), k
    for layers, dim in ((1, 64), (2, 32)):
        with pytest.raises(ValueError, match="retriever_model_path"):
            _executor(T, "synth_rerank_interaction.json", tmp_path / f"b{dim}", "train", *opts,
                      f"model_config.flmr.text_config.num_hidden_layers={layers}",
                      f"model_config.flmr.dim={dim}", f"model_config.late_interaction_dim={dim}")


def test_warm_start_from_retriever_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    flmr = _executor(J, "synth_flmr_vision.json", tmp_path / "f", "train", *FLMR_OPTS)
    rer = _executor(J, "synth_rerank_full_context_vision.json", tmp_path / "r", "train",
                    *RERANK_OPTS, "model_config.flmr=" + repr(flmr.config.model_config.flmr))
    fparams, rparams = jax.device_get(flmr.params), jax.device_get(rer.params)
    jmerged, jrestored = jrex.warm_start_from_retriever(rparams, fparams)
    tmerged, trestored = trex.warm_start_from_retriever(weights.rerank_state_dict(rparams),
                                                        weights.flmr_state_dict(fparams))
    assert set(trestored) == set(jrestored) and trestored
    want = weights.rerank_state_dict(jax.device_get(jmerged))
    assert want.keys() == tmerged.keys()
    for k in want:
        assert torch.equal(tmerged[k], want[k]), k
    bad = dict(weights.flmr_state_dict(fparams))
    key = next(k for k in bad if k.startswith("context_text_encoder."))
    bad[key] = bad[key][..., :1]
    with pytest.raises(ValueError):
        trex.warm_start_from_retriever(weights.rerank_state_dict(rparams), bad)


def test_checkpoint_save_resolve_load_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ex = _executor(T, "synth_flmr_vision.json", tmp_path / "a", "train", *FLMR_OPTS)
    ex.prepare_training(10)
    ex.training_step(next(iter(ex.train_dataloader())))
    ex.global_step = 1
    ex.save_checkpoint()
    path = ex.ckpt_manager.resolve()
    assert path and path.endswith("step_1")

    other = _executor(T, "synth_flmr_vision.json", tmp_path / "a", "test", *FLMR_OPTS,
                      "meta.seed=7")
    assert not all(torch.equal(a, b) for a, b in zip(other.model.state_dict().values(),
                                                     ex.model.state_dict().values()))
    other.load_checkpoint(other.ckpt_manager.resolve())
    assert other.global_step == 1
    for k, v in ex.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    other.prepare_training(10)  # the optimizer's state comes back for a resume
    assert other._train_state.step == 1
    want = ex._train_state.optimizer.state_dict()["state"]
    got = other._train_state.optimizer.state_dict()["state"]
    assert want.keys() == got.keys()
    for i in want:
        for k in want[i]:
            assert torch.equal(got[i][k], want[i][k]), (i, k)
    assert (other._train_state.scheduler.state_dict()
            == ex._train_state.scheduler.state_dict())

    # save_hf_model writes what model_config.checkpoint_dir reads back
    ex.save_hf_model(str(tmp_path / "hf"))
    again = _executor(T, "synth_flmr_vision.json", tmp_path / "b", "test", *FLMR_OPTS,
                      "meta.seed=7", f"model_config.checkpoint_dir='{tmp_path / 'hf'}'")
    for k, v in ex.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


def test_mesh_raises(tmp_path, monkeypatch):
    from reranking_multimodal_retrievers_tpu_torch.executors import FLMRExecutor
    from reranking_multimodal_retrievers_tpu_torch.utils import ConfigDict

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FLMRExecutor(ConfigDict(), mesh=object(), device="cpu")
