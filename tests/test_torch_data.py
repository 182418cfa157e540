"""The port's data layer against the JAX package's: ``data/table.py``
against HF ``datasets`` (rows, the ``shuffle`` permutation, ``map``,
concatenation), ``data/image_io.py`` against PIL (PNG files of every
scanline filter, the CLIP preprocessing), ``GenerateSyntheticM2KR`` through
both packages (rows, passages, vocab bytes, key-image pixels), the disk
cache round trip, and the first three batches of ``PrepareDataloaders``
(ids and masks bitwise, pixel values within 1e-6). Then the JAX package's own
cases of ``tests/test_{synthetic_ops,data_ops,module_parser_extras,
framework_core,wit_infoseek_depth,vqa_data_ops_real,eval_pipeline_lifecycle,
preprocess,host_ops,tools_aux}.py`` run once more with
their imports pointed at the port and ``datasets`` standing for the port's
tables (one parametrised test), the model nodes on the CPU
(``RMRT_PLATFORM=cpu``)."""

import os
import pickle
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
datasets = pytest.importorskip("datasets")
PIL_Image = pytest.importorskip("PIL.Image")

from reranking_multimodal_retrievers_tpu.data.loaders import CLIPImageProcessorNP  # noqa: E402
from reranking_multimodal_retrievers_tpu.data.ops.synthetic_ops import (  # noqa: E402
    GenerateSyntheticM2KR as JGenerate)
from reranking_multimodal_retrievers_tpu_torch.data import arrow_io, image_io  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.data.ops.synthetic_ops import (  # noqa: E402
    GenerateSyntheticM2KR)
from reranking_multimodal_retrievers_tpu_torch.data.table import (  # noqa: E402
    Table, concatenate_tables)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
COLUMNS = {"qid": [f"q{i}" for i in range(23)], "n": list(range(23)),
           "tags": [[f"t{i % 3}", f"u{i % 5}"] for i in range(23)]}


# ------------------------------------------------------------------- Table
def _rows(ds):
    return [dict(r) for r in ds]


def test_table_rows_and_columns_equal_datasets():
    t, d = Table.from_dict(COLUMNS), datasets.Dataset.from_dict(COLUMNS)
    assert len(t) == len(d) and t.column_names == d.column_names
    assert _rows(t) == _rows(d)
    assert t[5] == d[5] and t[-1] == d[-1]
    assert t["qid"] == list(d["qid"])
    row = t[2]
    row["tags"].append("x")  # a row is a copy
    assert t[2]["tags"] == d[2]["tags"]


@pytest.mark.parametrize("seed", [0, 42, 123])
@pytest.mark.parametrize("n", [1, 23, 500])
def test_table_shuffle_is_the_datasets_permutation(seed, n):
    cols = {"i": list(range(n))}
    assert Table.from_dict(cols).shuffle(seed=seed)["i"] == list(
        datasets.Dataset.from_dict(cols).shuffle(seed=seed)["i"])


def test_table_select_map_filter_concat_equal_datasets():
    t, d = Table.from_dict(COLUMNS), datasets.Dataset.from_dict(COLUMNS)
    idx = [7, 3, 3, 19, 0]
    assert _rows(t.select(idx)) == _rows(d.select(idx))

    def fn(ex):
        ex["qid"] = ex["qid"].upper()
        ex["double"] = 2 * ex["n"]
        return ex

    assert _rows(t.map(fn)) == _rows(d.map(fn, load_from_cache_file=False))
    assert _rows(t.filter(lambda r: r["n"] % 3 == 0)) == _rows(
        d.filter(lambda r: r["n"] % 3 == 0))
    assert _rows(t.select_columns(["n", "qid"])) == _rows(d.select_columns(["n", "qid"]))
    assert _rows(t.rename_columns({"n": "m"})) == _rows(d.rename_columns({"n": "m"}))
    assert _rows(concatenate_tables([t, t.select(range(4))])) == _rows(
        datasets.concatenate_datasets([d, d.select(range(4))]))
    with pytest.raises(ValueError):
        concatenate_tables([t, t.select_columns(["n"])])


def test_table_batched_map_and_columns_equal_datasets():
    t, d = Table.from_dict(COLUMNS), datasets.Dataset.from_dict(COLUMNS)

    def split_rows(batch):  # another number of rows than it was given
        out = {k: [] for k in batch}
        for i, q in enumerate(batch["qid"]):
            for part in (q, q + "b"):
                out["qid"].append(part)
                out["n"].append(batch["n"][i])
                out["tags"].append(batch["tags"][i])
        return out

    for bs in (4, 1000):
        assert _rows(t.map(split_rows, batched=True, batch_size=bs)) == _rows(
            d.map(split_rows, batched=True, batch_size=bs, load_from_cache_file=False))

    def indexed(batch, idx):
        return {"j": [2 * i for i in idx], "n": [x + 1 for x in batch["n"]]}

    kw = dict(batched=True, with_indices=True, batch_size=5, remove_columns=["tags"])
    assert _rows(t.map(indexed, **kw)) == _rows(d.map(indexed, **kw, load_from_cache_file=False))

    def row_indexed(row, i):
        return {"k": i, "qid": row["qid"] + "!"}

    assert _rows(t.map(row_indexed, with_indices=True, remove_columns="n")) == _rows(
        d.map(row_indexed, with_indices=True, remove_columns="n", load_from_cache_file=False))
    assert _rows(t.add_column("z", list(range(23)))) == _rows(d.add_column("z", list(range(23))))
    assert _rows(t.remove_columns("tags")) == _rows(d.remove_columns("tags"))
    assert _rows(t.remove_columns(["tags", "n"])) == _rows(d.remove_columns(["tags", "n"]))
    col = {"c": ["x", "y", "x", "z", "y"]}
    assert Table.from_dict(col).unique("c") == datasets.Dataset.from_dict(col).unique("c")


@pytest.mark.parametrize("kwargs", [dict(test_size=0.2, seed=3), dict(test_size=5, seed=1),
                                    dict(test_size=0.3, train_size=0.5, seed=7),
                                    dict(train_size=0.9, seed=0), dict(test_size=4, shuffle=False),
                                    dict(seed=42), dict(test_size=0.3)])
def test_train_test_split_equals_datasets(kwargs):
    """The rows of each split, including ``generic.py``'s second split of a
    split and a seed of None (drawn from numpy's global state)."""
    cols = {"i": list(range(23))}
    np.random.seed(5)
    got = Table.from_dict(cols).train_test_split(**kwargs)
    np.random.seed(5)
    want = datasets.Dataset.from_dict(cols).train_test_split(**kwargs)
    assert set(got) == {"train", "test"}
    for k in got:
        assert got[k]["i"] == list(want[k]["i"]), k
    again = got["test"].train_test_split(0.25, seed=9)
    want_again = want["test"].train_test_split(0.25, seed=9)
    assert again["train"]["i"] == list(want_again["train"]["i"])


def test_read_csv_equals_datasets_from_csv(tmp_path):
    """pandas' types through ``Dataset.from_csv``: int64, int with a missing
    field (float64), double, bool (WIT's ``is_main_image``), bool with a
    missing field, strings with quotes and embedded tabs, empty fields and
    NA strings as null, an all-missing column."""
    import csv

    rows = [["id", "n", "x", "flag", "s", "empty", "mixed", "is_main_image", "nothing"],
            ["1", "10", "1.5", "True", "hello", "", "a", "True", ""],
            ["2", "", "2", "False", "quoted\ttab", "", "1", "False", "NA"],
            ["3", "30", "nan", "True", "", " ", "2.5", "", ""],
            ["4", "-7", "1e3", "TRUE", "N/A", "x", "inf", "false", ""]]
    path = tmp_path / "f.tsv"
    with open(path, "w", newline="") as f:
        csv.writer(f, delimiter="\t").writerows(rows)
    from reranking_multimodal_retrievers_tpu_torch.data.table import read_csv

    got = read_csv(str(path), delimiter="\t")
    want = datasets.Dataset.from_csv(str(path), delimiter="\t")
    assert got.column_names == want.column_names
    assert list(got) == _rows(want)


def test_table_pickles():
    t = Table.from_dict(COLUMNS).shuffle(seed=1)
    assert pickle.loads(pickle.dumps(t)) == t


# ---------------------------------------------------------------- image_io
def _filtered_png(path, img, ftype):
    """An RGB PNG whose every scanline uses filter ``ftype``."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        cur = raw[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 0:
            f = cur
        elif ftype == 1:
            f = cur - left
        elif ftype == 2:
            f = cur - prev
        elif ftype == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            f = cur - pred
        out += bytes([ftype]) + (f % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    with open(path, "wb") as fh:
        fh.write(image_io.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_every_filter(tmp_path, ftype):
    img = np.random.default_rng(ftype).integers(0, 256, (13, 17, 3), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    _filtered_png(path, img, ftype)
    got = image_io.read_image(path)
    assert np.array_equal(got, img)
    assert np.array_equal(got, np.asarray(PIL_Image.open(path).convert("RGB")))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_reader_reads_pil_files(tmp_path, mode):
    """PIL's own PNGs (its filter choices, every 8-bit colour type): the
    port reads the same pixels as PIL's ``convert("RGB")``."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:40, 0:50]
    img = np.stack([xx * 5, yy * 6, (xx + yy) * 2], -1).astype(np.uint8)
    img[::7] = rng.integers(0, 256, img[::7].shape, dtype=np.uint8)
    pil = PIL_Image.fromarray(img).convert(mode)
    path = str(tmp_path / f"{mode}.png")
    pil.save(path)
    assert image_io._is_own_png(open(path, "rb").read())
    assert np.array_equal(image_io.read_image(path),
                          np.asarray(PIL_Image.open(path).convert("RGB")))


def test_write_png_roundtrip_and_jpeg_goes_to_pil(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (9, 31, 3), dtype=np.uint8)
    path = str(tmp_path / "w.png")
    image_io.write_png(path, img)
    assert np.array_equal(image_io.read_image(path), img)
    assert np.array_equal(np.asarray(PIL_Image.open(path)), img)
    jpg = str(tmp_path / "w.jpg")
    PIL_Image.fromarray(img).save(jpg)
    assert not image_io._is_own_png(open(jpg, "rb").read())
    assert np.array_equal(image_io.read_image(jpg),
                          np.asarray(PIL_Image.open(jpg).convert("RGB")))


@pytest.mark.parametrize("shape,size", [((224, 224, 3), 224), ((32, 32, 3), 32)])
def test_clip_processor_without_resize_is_bitwise_pil(shape, size):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    got = image_io.CLIPImageProcessor(size)([img, img[::-1]])
    want = CLIPImageProcessorNP(size)([PIL_Image.fromarray(img), PIL_Image.fromarray(img[::-1])])
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape,size", [((64, 64, 3), 224), ((48, 80, 3), 32),
                                        ((300, 200, 3), 224)])
def test_clip_processor_resize_within_two_levels_of_pil(shape, size):
    """A real resize: within two 8-bit levels of PIL's bicubic, at under 2%
    of the pixels (fp32 passes against PIL's fixed point)."""
    img = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    got = image_io.CLIPImageProcessor(size)([img])
    want = CLIPImageProcessorNP(size)([PIL_Image.fromarray(img)])
    levels = np.abs(got - want) * image_io.CLIPImageProcessor.STD[:, None, None] * 255
    assert levels.max() <= 2.0 + 1e-3
    assert (levels > 0.5).mean() < 0.02


# ------------------------------------------------------- synthetic M2KR
SYNTH = dict(num_pairs=40, num_test=10, group_size=5, head_len=12, tail_len=10,
             num_distractor_keys=50, num_filler_words=30, seed=3)


def _generate(cls, workdir, monkeypatch, **kw):
    """The generator run from ``workdir`` with relative side-artifact paths,
    so that both packages' rows name the same paths."""
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    f = cls(use_dummy_data=False)
    f.setup(**{**SYNTH, "vocab_path": "vocab/vocab.txt", **kw})
    return f._call()


@pytest.mark.parametrize("visual_key", [None, "head", "tail"])
def test_synthetic_generator_equals_jax(tmp_path, monkeypatch, visual_key):
    kw = {}
    if visual_key:
        kw = dict(visual_key=visual_key, visual_digits=3, visual_colors=8,
                  emit_group_negatives=True, image_size=24, images_dir="img")
    got = _generate(GenerateSyntheticM2KR, tmp_path / "port", monkeypatch, **kw)
    want = _generate(JGenerate, tmp_path / "jax", monkeypatch, **kw)
    assert set(got) == set(want)
    for split in want:
        assert isinstance(got[split], Table)
        assert _rows(got[split]) == _rows(want[split]), split
    assert ((tmp_path / "port" / "vocab" / "vocab.txt").read_bytes()
            == (tmp_path / "jax" / "vocab" / "vocab.txt").read_bytes())
    if visual_key:
        names = sorted(os.listdir(tmp_path / "jax" / "img"))
        assert names and names == sorted(os.listdir(tmp_path / "port" / "img"))
        for n in names:
            port = image_io.read_image(str(tmp_path / "port" / "img" / n))
            jax = np.asarray(PIL_Image.open(tmp_path / "jax" / "img" / n).convert("RGB"))
            assert np.array_equal(port, jax), n


def _config(pkg, name, tmp_path, *opts):
    cfgmod = __import__(f"{pkg}.utils.config_system", fromlist=["x"])
    cfg = cfgmod.load_config(os.path.join(ROOT, "configs", name))
    cfgmod.apply_opts(cfg, [f"data_pipeline.cache_dir='{tmp_path}/cache'", *opts])
    cfg.set_path("mode", "train")
    return cfg


def _pipeline(pkg, cfg, dummy=True):
    __import__(f"{pkg}.data.ops")
    pipe = __import__(f"{pkg}.data.pipeline", fromlist=["x"])
    return pipe.DataPipeline(cfg.data_pipeline, use_dummy_data=dummy, global_config=cfg)


def test_cache_round_trip(tmp_path, monkeypatch):
    pkg = "reranking_multimodal_retrievers_tpu_torch"
    monkeypatch.chdir(tmp_path)
    cfg = _config(pkg, "synth_flmr_vision.json", tmp_path)
    first = _pipeline(pkg, cfg).get_data(["input:GenerateSynthetic"], explode=True)
    calls = []
    monkeypatch.setattr(GenerateSyntheticM2KR, "_call", lambda self, data=None: calls.append(1))
    second = _pipeline(pkg, cfg).get_data(["input:GenerateSynthetic"], explode=True)
    assert calls == []  # served from the disk cache
    assert set(first) == set(second)
    assert all(first[k] == second[k] for k in first)
    cached = os.listdir(tmp_path / "cache" / "dummy")
    assert any(f.endswith(".tables.pkl") for f in cached)


@pytest.mark.parametrize("config", ["synth_flmr_vision.json", "synth_rerank_full_context.json"])
def test_first_batches_equal_jax(tmp_path, monkeypatch, config):
    monkeypatch.chdir(tmp_path)
    batches = {}
    for pkg in ("reranking_multimodal_retrievers_tpu", "reranking_multimodal_retrievers_tpu_torch"):
        cfg = _config(pkg, config, tmp_path / pkg, "train.batch_size=4")
        out = _pipeline(pkg, cfg).get_data(["output:PrepareDataloaders"], explode=True)
        loader = next(iter(out["data_loaders"]["train"].values()))
        batches[pkg] = [b for _, b in zip(range(3), loader)]
    want, got = batches.values()
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        assert a.keys() == b.keys()
        for k in a:
            if k == "pixel_values":
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6)
            elif isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


# ------------------------------------------- the JAX package's own cases
CASES = {
    "test_synthetic_ops.py": [
        ("test_text_mode_answer_marks_exactly_the_positive", {}),
        ("test_visual_mode_phrase_placement", {"mode": "head"}),
        ("test_visual_mode_phrase_placement", {"mode": "tail"}),
        ("test_visual_mode_images_deterministic", {}),
        ("test_visual_mode_group_structure", {}),
        ("test_group_negatives_emitted_and_sampled", {}),
        ("test_dummy_run_never_clobbers_real_side_artifacts", {}),
    ],
    "test_data_ops.py": [
        ("test_make_dummy_m2kr_shape", {}),
        ("test_m2kr_pipeline_to_dataloaders", {}),
        ("test_loader_pad_last_and_determinism", {}),
        ("test_bm25_index", {}),
        ("test_wikipedia_pseudo_annotation_mining", {}),
        ("test_wikipedia_answer_phrase_normalized_matching", {}),
        ("test_m2kr_empty_instruction_no_stray_colon", {}),
    ],
    # every case but test_blip2_greedy_captions_tiny, which builds its
    # model with flax (tests/test_torch_data_ops_real.py holds the port's
    # captioner against it)
    "test_wit_infoseek_depth.py": [
        ("test_prepare_wit_groups_passages_per_image", {}),
        ("test_split_wit_passages_reduces_eval_corpus", {}),
        ("test_truncate_wit_passages_chunks_and_reids", {}),
        ("test_remove_wit_passages_without_images", {}),
        ("test_distillation_live_teacher_scores", {}),
        ("test_feature_store_roundtrip", {}),
        ("test_load_wit_passages_renders_content", {}),
        ("test_wit_annotations_reduce_and_image_registry", {}),
        ("test_vit_v2_cache_and_v3_corpus", {}),
        ("test_vae_features", {}),
        ("test_caption_v2_publishes_and_v3_resumes", {}),
        ("test_feature_store_type_changing_overwrite", {}),
        ("test_prepare_wit_real_schema_without_img_columns", {}),
    ],
    "test_vqa_data_ops_real.py": [
        ("test_select_roi_objects_policy", {}),
        ("test_crop_roi_registry", {}),
        ("test_vinvl_oscar_ocr_loaders", {}),
        ("test_vg_prepare_for_retrieval_dedups_descriptions", {}),
        ("test_select_roi_objects_ignores_classless", {}),
        ("test_google_search_annotations_train_drop_vs_test_sentinel", {}),
    ],
    "test_module_parser_extras.py": [
        ("test_empty_text_and_passage_vision_parsers", {}),
        ("test_decoder_and_output_tokenization", {}),
        ("test_llava_tokenization_masks", {}),
        ("test_qwen_tokenization", {}),
        ("test_vision_from_embeddings_postprocessors", {}),
        ("test_colbert_aliases_match_flmr", {}),
        ("test_decoder_side_vision_reaches_postprocessors", {}),
        ("test_clip_processor_float_images", {}),
    ],
    "test_framework_core.py": [
        ("test_config_dict_paths_and_opts", {}),
        ("test_merge_patch_jsonnet_semantics", {}),
        ("test_merge_patch_drops_nulls_in_new_subdicts", {}),
        ("test_apply_opts_json_literals", {}),
        ("test_load_config_json_and_py", {}),
        ("test_pipeline_dag_and_cache", {}),
        ("test_pipeline_dummy_mode_uses_separate_cache", {}),
    ],
    # on_eval_end's pipeline, the recorder nodes, LoadHFDataset (its
    # save_to_disk directories written by data/arrow_io.py) and the tokenize
    # node
    "test_eval_pipeline_lifecycle.py": [
        ("test_on_eval_end_runs_configured_pipeline", {}),
        ("test_validation_recorder_naming_and_fallback_rows", {}),
        ("test_get_evaluation_recorder_load_and_passthrough", {}),
        ("test_merge_transform_row_appends_and_saves", {}),
        ("test_generic_hf_transforms_registered_and_split", {}),
        ("test_load_hf_dataset_from_disk", {}),
        ("test_tokenize_transform_prefixes_columns", {}),
        ("test_tokenize_transform_passes_through_unselected_splits", {}),
        ("test_load_hf_dataset_fields_projection", {}),
    ],
    # ops/preprocess.py against the port's host CLIP preprocessing, and
    # ops/host_ops.py (the port's own build of csrc/host_ops.cpp)
    "test_preprocess.py": [
        *(("test_device_matches_host_preprocessor", {"hw": hw})
          for hw in ((224, 224), (256, 320), (320, 256), (96, 200))),
        ("test_uint8_and_unit_float_agree", {}),
        ("test_output_is_normalized_nchw", {}),
    ],
    "test_host_ops.py": [
        ("test_native_library_builds", {}),
        ("test_segmented_maxsim_host", {}),
        ("test_segmented_maxsim_host_empty_candidate_set", {}),
        ("test_segmented_lookup_host", {}),
        ("test_top_k_host", {}),
        ("test_bit_packing_roundtrip", {}),
    ],
    # the tools/ cases; test_evqa_em_and_bem_interface builds the port's
    # BEM classifier from its seeded generator (the JAX case's flax init is
    # not reproduced; tests/test_torch_tools.py holds the two BEMScorers
    # against each other from one checkpoint directory)
    "test_tools_aux.py": [
        ("test_mcnemar", {}),
        ("test_rerank_vs_list_size", {}),
        ("test_evqa_eval", {}),
        ("test_loss_vs_recall", {}),
        ("test_render_job", {}),
        ("test_evqa_em_and_bem_interface", {}),
        ("test_upload_model_to_hub", {}),
        ("test_reduce_retrieval_file", {}),
        ("test_prepare_cc_images", {}),
    ],
}
_NAMESPACES = {}


class _SavableTable(Table):
    """A port table with ``datasets``' ``save_to_disk``, written by
    ``data/arrow_io.py``."""

    def save_to_disk(self, path):
        arrow_io.save_to_disk(self, path)


class _TablesAsDatasets:
    """The names of HF ``datasets`` that the case files call, over the
    port's tables (a ``DatasetDict`` is a dict of tables); ``save_to_disk``
    is ``data/arrow_io.py``'s writer."""

    class Dataset:
        from_dict = staticmethod(_SavableTable.from_dict)

    class DatasetDict(dict):
        def save_to_disk(self, path):
            arrow_io.save_to_disk(self, path)

    concatenate_datasets = staticmethod(concatenate_tables)


def _port_cases(filename):
    """A JAX-package test file compiled with every import of the JAX
    package pointed at the port (under the file's own name), and its
    ``import datasets`` bound to :class:`_TablesAsDatasets`."""
    if filename not in _NAMESPACES:
        path = os.path.join(HERE, filename)
        with open(path) as f:
            src = f.read().replace("reranking_multimodal_retrievers_tpu.",
                                   "reranking_multimodal_retrievers_tpu_torch.")
        src = src.replace("import datasets as hfds\n", "hfds = _PORT_DATASETS\n").replace(
            "import datasets\n", "datasets = _PORT_DATASETS\n")
        ns = {"__name__": f"port_{filename[:-3]}", "_PORT_DATASETS": _TablesAsDatasets}
        exec(compile(src, path, "exec"), ns)
        _NAMESPACES[filename] = ns
    return _NAMESPACES[filename]


BERT_WORDS = ["what", "is", "this", "where", "the", "dog", "a", "passage", "another", "here",
              "yes", "no", "capital", ":", "?"]


@pytest.mark.parametrize("filename,case,kwargs",
                         [(f, c, kw) for f, cases in CASES.items() for c, kw in cases],
                         ids=[f"{f[:-3]}::{c}{'-' + '-'.join(map(str, kw.values())) if kw else ''}"
                              for f, cases in CASES.items() for c, kw in cases])
def test_jax_case_on_port(filename, case, kwargs, tmp_path, monkeypatch):
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import tiny_bert_tokenizer

    monkeypatch.setenv("RMRT_PLATFORM", "cpu")  # the model nodes' device
    fn = _port_cases(filename)[case]
    params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    if "bert_tok" in params:
        fixtures["bert_tok"] = tiny_bert_tokenizer(str(tmp_path / "tok"), BERT_WORDS)
    fn(**kwargs, **{k: v for k, v in fixtures.items() if k in params})


def test_cases_import_the_port():
    for filename in CASES:
        ns = _port_cases(filename)
        mods = {getattr(v, "__module__", "") or "" for v in ns.values() if callable(v)}
        ours = {m for m in mods if m.startswith("reranking_multimodal_retrievers_tpu")}
        assert ours and all(m.startswith("reranking_multimodal_retrievers_tpu_torch.")
                            for m in ours), (filename, ours)
