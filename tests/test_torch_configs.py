"""Every committed config that no other port test names, as published,
through both packages' executors on dummy data (``--use_dummy_data``, or the
config's synthetic generator at its dummy size), in fp32 on the CPU (JAX at
matmul precision "highest"), the port's models holding JAX's initial
weights (``models/weights.py``). Each config keeps its own
``model_config.modules``, ``loss_fn`` and widths, so the published
combinations run as written: negative sampling with a frozen reranker
vision tower (listwise), ``2H_BCE`` over a 3-layer cross-encoder (pointwise
softmax), ``seq2seq`` on the BLIP-2 models without the yes/no head
(textgen), ``quantize_int8`` in the FLMR text tower and the cross-encoder
while training (QAT), PreFLMR attention fusion over M2KR, and the
retrieval-sampled training variants.

Two cases a config: ``train`` (one training step) and ``test`` (the test
split's evaluation, the full rerank for the rerankers; one test batch).
This file runs the synthetic FLMR configs, ``tests/test_torch_preflmr_cli.py``
the OK-VQA PreFLMR ones (their model block is EVQA's, whose programs that
file's process has compiled), ``tests/test_torch_configs_{rerank,fusion,
decoder}.py`` the rerankers', one worker's share each. Every config runs
offline in both packages (none had to be listed with an error the JAX
package raises). The JAX executors' eager model init runs jitted
(``jitted_flax_init``) for time. Tolerances are
``tests/test_torch_executors.py``'s: the losses and the rerank logits
within 1e-5 (1e-3 under QAT, ``_tol``), the rankings up to near-ties (1e-4
of the largest score), every metrics dict equal; after the step FLMR's
trained parameters within 2 lr (their group's) of JAX's, and the frozen
ones (the vision tower, a reranker's frozen retriever) bitwise.

Cuts: ``okvqa_flmr_{L,G}.json`` take ``tests/test_torch_preflmr_cli.py``'s
depth cut (the text and vision towers at 2 layers, the ViT at 56 px), the
``synth_flmr_*`` ones a train batch of 4 (the dummy set's 24 pairs fill no
batch of 32), and FLMR steps run without warm-up, so that the first one
moves the weights. The ``synth_*_big`` rerankers' test reads
``experiments/synth_static_retrieval_big.json`` (not committed): it is made
here from ``synth_flmr_big.json``'s own test run through the port's CLI, as
``tests/test_torch_cli.py`` makes EVQA's dump; their train case synthesizes
its static retrieval, as dummy runs do without the file.
"""

import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from test_torch_executors import (  # noqa: E402
    J,
    T,
    _assert_batches_equal,
    _assert_rankings_match,
    _carry_weights,
    _executor,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLMR = ["okvqa_flmr_L.json", "okvqa_flmr_G.json", "synth_flmr_big.json",
        "synth_flmr_vision_textonly.json", "synth_flmr_vtail.json"]
# okvqa_flmr_{L,G}.json hold evqa_flmr_{L,G}.json's model block: they run in
# tests/test_torch_preflmr_cli.py's process, which has compiled its programs
SYNTH_FLMR = FLMR[2:]
DEPTH_CUT = ("model_config.flmr.text_config.num_hidden_layers=2",
             "model_config.flmr.vision_config.num_hidden_layers=2",
             "model_config.flmr.vision_config.image_size=56",
             "data_pipeline.transforms.output:PrepareDataloaders.setup_kwargs."
             "image_processor_config={'vit_image_processor': {'image_size': 56}}")
NO_WARMUP = ("train.optimizer_config.scheduler_params.num_warmup_steps=0",)
BIG_DUMP = "experiments/synth_static_retrieval_big.json"


def _tol(config):
    """The losses' and rerank logits' tolerance: 1e-5, but 1e-3 under
    ``quantize_int8``, where fp32 round-off may move an activation across a
    rounding boundary and flip its int8 code by one
    (``synth_rerank_full_context_qat.json``'s logits land up to 6.5e-4
    apart with W8A8, within 1e-6 without it)."""
    tol = 1e-3 if config == "synth_rerank_full_context_qat.json" else 1e-5
    return {"rel": tol, "abs": tol}


def _opts(config, mode):
    opts = ("test.trainer_paras.limit_test_batches=1",) if mode == "test" else ()
    if config.startswith("okvqa_flmr_"):
        return opts + DEPTH_CUT + NO_WARMUP
    if config.startswith("synth_flmr_"):  # the dummy set's 24 pairs fill no batch of 32
        return opts + NO_WARMUP + ("train.batch_size=4",)
    return opts


@contextlib.contextmanager
def jitted_flax_init():
    """Within the block, ``flax.linen.Module.init`` runs as one jitted
    program (its array arguments traced, the rest fixed) where the JAX
    executors call it eagerly, one XLA compile an operation: the same
    initial weights up to fp32 round-off (which both sides then hold) in
    about half the CPU time, and the program cached on disk for the next
    executor of the same model."""
    import flax.linen as nn

    eager = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        leaves, tree = jax.tree_util.tree_flatten((args, kwargs))
        traced = [i for i, x in enumerate(leaves) if isinstance(x, (np.ndarray, jax.Array))]

        def run(rngs, arrays):
            full = list(leaves)
            for i, x in zip(traced, arrays):
                full[i] = x
            a, kw = jax.tree_util.tree_unflatten(tree, full)
            return eager(self, rngs, *a, **kw)

        return jax.jit(run)(rngs, [leaves[i] for i in traced])

    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = eager


def _pair(tmp_path, monkeypatch, config, mode, *opts):
    """(JAX executor, port executor) of ``config`` as published on dummy
    data, the port's model(s) holding JAX's initial weights; the OK-VQA and
    EVQA dummy images are resized, so both read JAX's batches."""
    monkeypatch.chdir(tmp_path)
    with jitted_flax_init():
        jex = _executor(J, config, tmp_path / "jax", mode, *_opts(config, mode), *opts)
    tex = _executor(T, config, tmp_path / "port", mode, *_opts(config, mode), *opts)
    _carry_weights(jex, tex)
    if config.startswith(("okvqa_", "evqa_")):
        tex.data_loaders = jex.data_loaders
    return jex, tex


@pytest.fixture(scope="module")
def big_dump(tmp_path_factory):
    """``synth_flmr_big.json``'s test dump from the port's CLI, where the
    ``synth_*_big`` rerankers look for it (``BIG_DUMP`` under the returned
    directory)."""
    from reranking_multimodal_retrievers_tpu_torch.cli.main import main

    root = tmp_path_factory.mktemp("big_dump")
    mp = pytest.MonkeyPatch()
    mp.setenv("RMRT_PLATFORM", "cpu")
    mp.chdir(root)
    try:
        exp = root / "flmr"
        assert main(["--config", os.path.join(ROOT, "configs", "synth_flmr_big.json"),
                     "--mode", "test", "--use_dummy_data", "--opts",
                     f"meta.experiment_dir='{exp}'",
                     f"data_pipeline.cache_dir='{root}/cache'"]) == 0
        os.makedirs(root / "experiments")
        os.replace(exp / "test_predictions_rank_0.json", root / BIG_DUMP)
    finally:
        mp.undo()
    return root


def check_train(tmp_path, monkeypatch, config):
    """One training step from the same weights on the same batch."""
    jex, tex = _pair(tmp_path, monkeypatch, config, "train")
    flmr = config in FLMR
    if not flmr:
        assert tex.reranker_family == jex.reranker_family
        assert type(tex.reranker).__name__ == type(jex.reranker).__name__
        assert tex.questionId2topPassages == jex.questionId2topPassages
    jb = next(iter(jex.train_dataloader()))
    tb = jb if tex.data_loaders is jex.data_loaders else next(iter(tex.train_dataloader()))
    _assert_batches_equal(jb, tb)
    jex.prepare_training(10)
    tex.prepare_training(10)
    model = tex.model if flmr else tex.reranker
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jm, tm = jex.training_step(jb), tex.training_step(tb)
    assert tm["loss"] == pytest.approx(jm["loss"], **_tol(config))
    if flmr:
        for k in ("ib_loss", "total_loss"):
            assert tm[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-5), k
        oc = tex.config.train.optimizer_config
        patterns = tex.config.model_config.get("mapping_group_patterns") or []
        after = weights.flmr_state_dict(jax.device_get(jex._train_state.params))
        for name, p in model.named_parameters():
            if "vision_encoder" in name:  # frozen
                assert torch.equal(p.detach(), before[name]), name
                continue
            mapping = oc.get("mapping_network_lr") and any(pat in name for pat in patterns)
            lr = oc.mapping_network_lr if mapping else oc.optimizer_params.lr
            diff = (p.detach() - after[name]).abs().max()
            assert diff <= 2 * lr * (1 + 0.1 * before[name].abs().max()), name
        return
    for name in tex.frozen_patterns():  # frozen towers bitwise
        for k, v in model.state_dict().items():
            if name in k:
                assert torch.equal(v, before[k]), k
    if tex.retriever is not None:  # frozen: in no optimizer, never updated
        want_r = weights.flmr_state_dict(jax.device_get(jex._retriever_params))
        for k, v in tex.retriever.state_dict().items():
            assert torch.equal(v, want_r[k]), k


def check_test(tmp_path, monkeypatch, config, request):
    """The test split's evaluation from the same weights: FLMR's retrieval
    over its index, the rerankers' full rerank of their static retrieval
    (a ``synth_*_big`` reranker's from ``big_dump``)."""
    opts = ()
    if config.startswith("synth_rerank_") and "_big" in config:
        dump = request.getfixturevalue("big_dump") / BIG_DUMP
        opts = (f"model_config.retrieve_result_path='{dump}'",)
    jex, tex = _pair(tmp_path, monkeypatch, config, "test", *opts)
    want, got = jex.evaluate("test"), tex.evaluate("test")
    assert len(got["batch_retrieval_result"]) == len(want["batch_retrieval_result"]) > 0
    if config in FLMR:
        _assert_rankings_match(want["batch_retrieval_result"], got["batch_retrieval_result"])
    else:
        assert tex.questionId2topPassages == jex.questionId2topPassages
        if opts:  # the reranked lists are synth_flmr_big's
            assert not any(p.get("static_retrieval_missing")
                           for p in got["batch_retrieval_result"])
        for w, g in zip(want["batch_retrieval_result"], got["batch_retrieval_result"]):
            ws = {p["passage_id"]: p["score"] for p in w["top_ranking_passages"]}
            gs = {p["passage_id"]: p["score"] for p in g["top_ranking_passages"]}
            assert ws.keys() == gs.keys()
            tol = _tol(config)
            np.testing.assert_allclose([gs[k] for k in ws], list(ws.values()),
                                       rtol=tol["rel"], atol=tol["abs"])
            assert g["raw_top_ranking_passages"] == w["raw_top_ranking_passages"]
    assert dict(got.metrics) == dict(want.metrics)


@pytest.mark.parametrize("config", SYNTH_FLMR)
def test_config_train_matches_jax(tmp_path, monkeypatch, config):
    check_train(tmp_path, monkeypatch, config)


@pytest.mark.parametrize("config", SYNTH_FLMR)
def test_config_test_matches_jax(tmp_path, monkeypatch, config, request):
    check_test(tmp_path, monkeypatch, config, request)
