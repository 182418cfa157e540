"""The paper's flagship retrievers as the repo publishes them,
``configs/evqa_flmr_G.json`` (PreFLMR-G) and ``configs/evqa_flmr_L.json``
(PreFLMR-L), through both packages' ``FLMRExecutor`` on the same cut of the
committed M2KR snapshot (``tests/fixtures/m2kr_snapshot``), in fp32 on the
CPU (JAX at matmul precision "highest"). The cut: the first 16 train and 8
test questions with their images, and 32 passages of each split holding
their positives, written in ``datasets``' ``save_to_disk`` layout, which
both packages' ``LoadM2KR`` read through the ``///`` convention (the
parquet snapshot itself is read by both in ``tests/test_torch_parquet.py``).

Everything but depth is the file's: BERT-base (768 wide, 12 heads), the
ViT at its published width and heads (1664 / 16 of 104 for G, 1024 / 16 of
64 for L) at patch 14, dim 128, a 32-token prefix, the 1-layer mapping
network cross-attending to the first 32 text rows, the vision encoders
frozen, the mapping group (``vision_projection``, ``transformer_mapping``)
at ``mapping_network_lr``, the clip at 1.0, 1 negative, Ks 1, 5, 10. The
depth cut: the vision towers at 2 layers and 56 px (as
``tests/test_torch_scales.py``), the text tower at 2 layers but in the
full-depth case (its 12 layers: the 768-wide, 12-head FLMR training
parity, marked ``slow``: about 60 s alone); besides, no warm-up (so that the first step moves the weights)
and the valid split read from the cut's test questions. JAX's initial
weights (``Module.init`` jitted, as ``tests/test_torch_configs.py`` does)
are carried into the port's model by ``models/weights.py``; the
tokenizers read one vocabulary written from the snapshot's words. The
metrics are also held against ``chip_smoke.py``'s plain recomputation,
which phase 16 holds the card's dump to.

Held, under ``tests/test_torch_executors.py``'s tolerances: the rankings
and metrics of the 8 test questions over the 64-passage index, one
training step's ``loss`` and ``ib_loss``, every trained parameter after it
(within 2 lr of its own group's lr), every frozen one bitwise. The images
are resized, where the port's bicubic lies within two 8-bit levels of
PIL's (``tests/test_torch_data.py``), so both executors read the JAX
pipeline's batches.
"""

import os
import re

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import datasets  # noqa: E402
import jax  # noqa: E402

from reranking_multimodal_retrievers_tpu_torch.data.ops.m2kr_ops import _load_hf  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (  # noqa: E402
    write_test_vocab,
)
from test_torch_configs import check_test, check_train, jitted_flax_init  # noqa: E402
from test_torch_executors import (  # noqa: E402
    J,
    T,
    _assert_rankings_match,
    _carry_weights,
    _executor,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
SNAPSHOT = os.path.join(FIXTURES, "m2kr_snapshot")
IMAGES = os.path.join(FIXTURES, "m2kr_images")
LOAD = "data_pipeline.transforms.input:LoadM2KR.setup_kwargs"
PREPARE = "data_pipeline.transforms.output:PrepareDataloaders.setup_kwargs"
PASSAGES = 32  # of each split, the questions' positives among them
DEPTH = ("model_config.flmr.vision_config.num_hidden_layers=2",
         "model_config.flmr.vision_config.image_size=56")


@pytest.fixture(scope="module")
def snapshot_cut(tmp_path_factory):
    """The snapshot's first 16 train and 8 test questions, and PASSAGES
    passages of each split (the questions' positives first, then the
    split's first others), in ``datasets``' ``save_to_disk`` layout (``EVQA_data``,
    ``EVQA_passages``), and a vocabulary of the snapshot's words."""
    root = tmp_path_factory.mktemp("m2kr_cut")
    data = _load_hf(f"{SNAPSHOT}///EVQA_data")
    passages = _load_hf(f"{SNAPSHOT}///EVQA_passages")
    rows, kept = {}, {}
    for split, n in (("train", 16), ("test", 8)):
        table = data[split]
        rows[split] = [table[i] for i in range(n)]
        pos = [pid for r in rows[split] for pid in r["pos_item_ids"]]
        table = passages[f"{split}_passages"]
        ids = table["passage_id"]
        order = [ids.index(pid) for pid in dict.fromkeys(pos)]
        order += [i for i in range(len(ids)) if i not in set(order)][:PASSAGES - len(order)]
        kept[f"{split}_passages"] = [table[i] for i in sorted(order)]
    datasets.DatasetDict({k: datasets.Dataset.from_list(v) for k, v in rows.items()}
                         ).save_to_disk(str(root / "EVQA_data"))
    datasets.DatasetDict({k: datasets.Dataset.from_list(v) for k, v in kept.items()}
                         ).save_to_disk(str(root / "EVQA_passages"))
    text = [t for tables in (data, passages) for table in tables.values()
            for col in ("question", "instruction", "passage_content")
            if col in table.column_names for t in table[col] if t]
    write_test_vocab(str(root / "vocab" / "vocab.txt"),
                     sorted({w for t in text for w in re.findall(r"[a-z0-9]+", t.lower())}))
    return root


def _snapshot_opts(root):
    """--opts that point the config's M2KR node at the cut under ``root``
    and the rows' images, its tokenizers at the cut's vocabulary, its image
    processor at 56 px and its valid split at the test questions."""
    return (f"{LOAD}.data_path='{root}/EVQA_data///EVQA_data'",
            f"{LOAD}.passage_path='{root}/EVQA_passages///EVQA_passages'",
            f"{LOAD}.image_root_folder='{IMAGES}'",
            f"{PREPARE}.datasets_config.valid=[{{'dataset_type': 'EVQADatasetForDPR', "
            "'split': 'test', 'use_column': 'evqa_data'}]",
            f"{PREPARE}.tokenizer_config.tokenizer.TokenizerModelVersion='{root}/vocab'",
            f"{PREPARE}.tokenizer_config.decoder_tokenizer.TokenizerModelVersion='{root}/vocab'",
            f"{PREPARE}.image_processor_config={{'vit_image_processor': {{'image_size': 56}}}}",
            "train.optimizer_config.scheduler_params.num_warmup_steps=0",
            "valid.trainer_paras.limit_val_batches=2")


@pytest.mark.parametrize("config,text_layers", [
    pytest.param("evqa_flmr_G.json", 2, id="G"),
    pytest.param("evqa_flmr_L.json", 2, id="L"),
    # about 60 s alone on one worker from a cold compile cache
    pytest.param("evqa_flmr_L.json", 12, id="L_text_full_depth", marks=pytest.mark.slow),
])
def test_published_preflmr_evaluate_then_train_step_match_jax(
        snapshot_cut, tmp_path, monkeypatch, config, text_layers):
    opts = (*_snapshot_opts(snapshot_cut), *DEPTH,
            f"model_config.flmr.text_config.num_hidden_layers={text_layers}")
    monkeypatch.chdir(tmp_path)
    with jitted_flax_init():
        jex = _executor(J, config, tmp_path / "jax", "train", *opts, dummy=False)
    tex = _executor(T, config, tmp_path / "port", "train", *opts, dummy=False)
    _carry_weights(jex, tex)
    assert tex.id2doc == jex.id2doc and len(tex.id2doc) == 2 * PASSAGES
    fc = tex.flmr_config
    assert (fc.text_config.hidden_size, fc.text_config.num_attention_heads) == (768, 12)
    assert fc.vision_config.patch_size == 14 and fc.vision_config.num_attention_heads == 16
    assert fc.transformer_mapping_cross_attention_length == 32
    assert fc.punctuation_token_ids == jex.flmr_config.punctuation_token_ids
    tex.data_loaders = jex.data_loaders  # the snapshot's images are resized

    want, got = jex.evaluate("valid"), tex.evaluate("valid")
    assert len(got["batch_retrieval_result"]) == 8
    _assert_rankings_match(want["batch_retrieval_result"], got["batch_retrieval_result"])
    assert dict(got.metrics) == dict(want.metrics)
    # chip_smoke.py phase 16's recomputation of the dump's metrics
    assert chip_smoke._plain_dpr_metrics(got["batch_retrieval_result"],
                                         tex.config.model_config.Ks) == dict(want.metrics)

    batch = next(iter(jex.train_dataloader()))
    assert batch["pixel_values"].shape == (4, 3, 56, 56)
    jex.prepare_training(10)
    tex.prepare_training(10)
    before = {k: v.clone() for k, v in tex.model.state_dict().items()}
    jm, tm = jex.training_step(batch), tex.training_step(batch)
    for k in ("loss", "ib_loss", "total_loss"):
        assert tm[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-5), k
    oc = tex.config.train.optimizer_config
    patterns = tex.config.model_config.mapping_group_patterns
    after = weights.flmr_state_dict(jax.device_get(jex._train_state.params))
    moved = {"frozen": 0, "mapping": 0, "main": 0}
    frozen = 0
    for name, p in tex.model.named_parameters():
        if "vision_encoder" in name:  # frozen, yet in the clip's norm
            assert p.requires_grad and torch.equal(p.detach(), before[name]), name
            frozen += 1
            continue
        group = "mapping" if any(pat in name for pat in patterns) else "main"
        lr = oc.mapping_network_lr if group == "mapping" else oc.optimizer_params.lr
        diff = (p.detach() - after[name]).abs().max()
        assert diff <= 2 * lr * (1 + 0.1 * before[name].abs().max()), name
        moved[group] += not torch.equal(p.detach(), before[name])
    assert frozen and moved["mapping"] and moved["main"] and not moved["frozen"], moved


@pytest.mark.parametrize("config", ["okvqa_flmr_G.json", "okvqa_flmr_L.json"])
def test_okvqa_preflmr_train_matches_jax(tmp_path, monkeypatch, config):
    """``configs/okvqa_flmr_{G,L}.json`` (the same model block) on OK-VQA
    dummy data, by ``tests/test_torch_configs.py``'s cases and cut."""
    check_train(tmp_path, monkeypatch, config)


@pytest.mark.parametrize("config", ["okvqa_flmr_G.json", "okvqa_flmr_L.json"])
def test_okvqa_preflmr_test_matches_jax(tmp_path, monkeypatch, config, request):
    check_test(tmp_path, monkeypatch, config, request)
