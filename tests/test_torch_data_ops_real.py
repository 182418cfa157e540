"""The port's real-data nodes (``data/ops/{wikipedia,okvqa,vg,wit,infoseek,
distillation,feature}_ops.py``, ``data/feature_store.py``) against the JAX
package's: the same input tables through the JAX node (on HF ``datasets``)
and the port's (on ``data/table.py`` tables). Text, id and int columns must
be equal; fp32 features agree within rtol 1e-5 / atol 1e-5 with the weights
carried across (``models/weights.py``); greedy captions of a tiny BLIP-2
are equal token for token; teacher scores agree within rtol 1e-5 from one
HF-named checkpoint directory both packages load. Then the slice as a
whole: ``cli.main --mode prepare_data`` (``RMRT_PLATFORM=cpu``) over an M2KR
directory written by ``datasets``, through the captioner, ViT features and
the live teacher, equals the JAX CLI's, and ``--mode test`` runs over it."""

import base64
import csv
import dataclasses
import io
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
datasets = pytest.importorskip("datasets")
PIL_Image = pytest.importorskip("PIL.Image")
jax = pytest.importorskip("jax")

import torch  # noqa: E402

from reranking_multimodal_retrievers_tpu.utils import ConfigDict as JConfig  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.data.image_io import write_png  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.data.table import Table  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.checkpoint_dir import (  # noqa: E402
    write_safetensors)
from reranking_multimodal_retrievers_tpu_torch.utils import ConfigDict as PConfig  # noqa: E402

J, P = "reranking_multimodal_retrievers_tpu", "reranking_multimodal_retrievers_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("RMRT_PLATFORM", "cpu")


def _node(pkg, module, name, dummy=False, **kwargs):
    mod = __import__(f"{pkg}.data.ops.{module}", fromlist=["x"])
    f = getattr(mod, name)(use_dummy_data=dummy,
                           global_config=(JConfig if pkg == J else PConfig)({}))
    f.setup(**kwargs)
    return f


def _make(pkg):
    """``from_dict`` of the package's table type."""
    return datasets.Dataset.from_dict if pkg == J else Table.from_dict


def _same(want, got, path="", tol=None):
    """``got`` (the port's output) equals ``want`` (the JAX package's):
    tables row for row, dicts key for key; floats within ``tol`` if given;
    a numpy array where ``datasets`` gives nested lists."""
    if isinstance(got, np.ndarray) and isinstance(want, list):
        got = got.tolist()
    if isinstance(want, datasets.Dataset):
        assert isinstance(got, Table), path
        assert got.column_names == want.column_names, path
        _same([dict(r) for r in want], list(got), path, tol)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _same(want[k], got[k], f"{path}.{k}", tol)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            _same(a, b, f"{path}[{i}]", tol)
    elif isinstance(want, float) and tol is not None:
        np.testing.assert_allclose(got, want, err_msg=path, **tol)
    elif hasattr(want, "doc_tokens"):  # a BM25Index
        assert got.doc_tokens == want.doc_tokens and got.vocab == want.vocab, path
        np.testing.assert_array_equal(got._matrix.toarray(), want._matrix.toarray())
    else:
        assert got == want, (path, got, want)


def _both(module, name, make_input, dummy=False, tol=None, **kwargs):
    """Run the node of both packages on ``make_input(pkg)``; the port's
    output must equal the JAX package's. Returns the port's."""
    want = _node(J, module, name, dummy, **kwargs)(make_input(J))
    got = _node(P, module, name, dummy, **kwargs)(make_input(P))
    _same(want, got, name, tol)
    return got


# ---------------------------------------------------------------- Wikipedia
PASSAGES = {"passage_id": ["p0", "p1", "p2", "p3", "p4"],
            "passage_content": ["the eiffel tower stands in paris france",
                                "paris is the capital of france", "rome is the capital of italy",
                                "unrelated text about cooking pasta",
                                "the u.s. capital is washington"]}
QUESTIONS = {"question_id": ["q0", "q1", "q2"],
             "question": ["what city is the eiffel tower in", "what is xyzzy",
                          "which country's capital is washington"],
             "answers": [["paris"], ["xyzzy"], ["U.S."]], "gold_answer": ["paris", "xyzzy", "U.S."],
             "img_caption": ["a photo of the eiffel tower", "", ""],
             "objects": [[{"class": "tower"}], [], []]}


def _indexed(pkg):
    passages = {"train_passages": _make(pkg)(PASSAGES), "test_passages": _make(pkg)(PASSAGES)}
    return _node(pkg, "wikipedia_ops", "IndexPassagesWithElasticSearch")(passages)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_wikipedia_nodes_equal_jax(mode):
    from reranking_multimodal_retrievers_tpu.data.ops import wikipedia_ops as jw
    from reranking_multimodal_retrievers_tpu_torch.data.ops import wikipedia_ops as pw

    _same(_indexed(J), _indexed(P))
    for q in ("capital of france", "pasta", "zzz"):
        np.testing.assert_array_equal(pw.BM25Index(PASSAGES["passage_content"]).scores(q),
                                      jw.BM25Index(PASSAGES["passage_content"]).scores(q))
    for a, b in (("a b c", "c b a d"), ("paris france", "the capital of france"), ("", "x")):
        assert pw.token_set_ratio(a, b) == jw.token_set_ratio(a, b)

    def annotated(pkg):
        qs = {"train": _make(pkg)(QUESTIONS), "test": _make(pkg)(QUESTIONS)}
        return [qs, _indexed(pkg)]

    out = _both("wikipedia_ops", "PrepareWikipediaPassageAnnotations", annotated, k=4,
                mode=mode)
    assert (len(out["test"]) == 3) == (mode == "test")  # train mode drops misses
    _both("wikipedia_ops", "ReduceWikipediaPassagesSize",
          lambda pkg: {"train": _make(pkg)(QUESTIONS | {"pos_item_ids": [["p1"], ["p4"], []]}),
                       "train_passages": _make(pkg)(PASSAGES)}, num_distractors=2)
    _both("wikipedia_ops", "LoadWikipediaPassageData", lambda pkg: None, dummy=True)


def test_passage_loaders_read_a_save_to_disk_directory(tmp_path):
    datasets.DatasetDict({"train_passages": datasets.Dataset.from_dict(PASSAGES)}).save_to_disk(
        str(tmp_path / "wiki"))
    datasets.DatasetDict({"train": datasets.Dataset.from_dict(QUESTIONS)}).save_to_disk(
        str(tmp_path / "infoseek"))
    for name in ("LoadWikipediaPassageData", "LoadFullWikipediaPassageData"):
        _both("wikipedia_ops", name, lambda pkg: None, passage_path=str(tmp_path / "wiki"))
    _both("infoseek_ops", "LoadInfoSeekData", lambda pkg: None,
          data_path=f"{tmp_path / 'infoseek'}///subset")
    _both("infoseek_ops", "LoadInfoSeekData", lambda pkg: None, dummy=True)
    _both("vg_ops", "LoadVisualGenomeData", lambda pkg: None, data_path=str(tmp_path / "infoseek"))
    _both("wit_ops", "LoadWITData", lambda pkg: None, data_path=str(tmp_path / "infoseek"))
    _both("infoseek_ops", "PrepareWikipediaPassageAnnotationsForInfoSeek",
          lambda pkg: [{"train": _make(pkg)(QUESTIONS | {"entity_text": ["eiffel", "", "rome"]})},
                       _indexed(pkg)])


# ------------------------------------------------------------------- OK-VQA
def _okvqa_files(tmp_path):
    qs = {"questions": [{"question_id": 7, "question": "what is this?", "image_id": 42},
                        {"question_id": 8, "question": "who made it?", "image_id": 43}]}
    anns = {"annotations": [
        {"question_id": 8, "image_id": 43, "answers": [{"answer": "b"}, {"answer": "a"},
                                                       {"answer": "b"}]},
        {"question_id": 7, "image_id": 42, "answers": [{"answer": "cat"}] * 3}]}
    for name, obj in (("q.json", qs), ("a.json", anns)):
        with open(tmp_path / name, "w") as f:
            json.dump(obj, f)
    with open(tmp_path / "gs.tsv", "w") as f:
        f.write("gs1\tthe cat sat on a mat\ngs2\tb is for bee\ngs3\tnothing here\n")
    return {"train": {"question_file": str(tmp_path / "q.json"),
                      "annotation_file": str(tmp_path / "a.json")}}


def test_okvqa_loaders_and_annotations_equal_jax(tmp_path):
    paths = _okvqa_files(tmp_path)
    _both("okvqa_ops", "LoadOKVQAData", lambda pkg: None, vqa_data_path=paths,
          image_data_path={"train": "/coco/val2014"})
    _both("okvqa_ops", "LoadOKVQAData", lambda pkg: None, dummy=True)
    _both("okvqa_ops", "LoadGoogleSearchPassageData", lambda pkg: None,
          passage_data_path=str(tmp_path / "gs.tsv"))

    def inputs(pkg):
        data = _node(pkg, "okvqa_ops", "LoadOKVQAData", vqa_data_path=paths)(None)
        passages = _node(pkg, "okvqa_ops", "LoadGoogleSearchPassageData",
                         passage_data_path=str(tmp_path / "gs.tsv"))(None)
        return [data, passages]

    for all_samples in (False, True):
        _both("okvqa_ops", "LoadGoogleSearchAnnotations", inputs, use_all_samples=all_samples)


def test_roi_registry_and_crops_equal_jax(tmp_path):
    from reranking_multimodal_retrievers_tpu.data.ops import okvqa_ops as jo
    from reranking_multimodal_retrievers_tpu_torch.data.ops import okvqa_ops as po

    img = np.random.default_rng(0).integers(0, 256, (40, 60, 3), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    # floats throughout: an Arrow column of rects is float64 (the port's
    # tables keep Python values as given; arrow_io reads them as floats)
    objects = [{"class": "cat", "rect": [1.4, 2.6, 30.5, 20.2]},
               {"class": "dog", "rect": [0.0, 0.0, 70.0, 50.0]},
               {"class": "dog", "rect": [5.0, 5.0, 9.0, 9.0]},
               {"class": "tree", "rect": [10.25, 3.75, 33.5, 39.5]}]

    def data(pkg):
        t = _make(pkg)({"question": ["where is the cat?", "a tree?"], "img_path": [path, path],
                        "objects": [objects, objects[1:]]})
        return {"train": t, "images": _make(pkg)({"id": ["x"], "img_path": ["/x.jpg"],
                                                  "obj_class": ["x"], "crop": [[0.0, 0.0, 1.0, 1.0]]})}

    for n in (1, 2, 4):
        out = _both("okvqa_ops", "CropRegionOfInterestImages", data, max_objects=n)
    registry = {r["id"]: r for r in out["images"]}
    rois = [r for row in out["train"] for r in row["ROIs"]]
    want = jo.crop_roi_images(rois, registry)
    got = po.crop_roi_images(rois, registry)
    assert len(got) == len(want) == len(rois)
    for w, g in zip(want, got):
        assert np.array_equal(g, np.asarray(w))


def test_vinvl_oscar_ocr_equal_jax(tmp_path):
    pred = {"objects": [{"class": "cat", "rect": [0, 0, 10, 10], "conf": 0.9,
                         "feature": [0.1] * 16},
                        {"class": "sign", "rect": [50, 50, 100, 100]}]}
    with open(tmp_path / "vinvl.tsv", "w") as f:
        f.write(f"img1\t{json.dumps(pred)}\nimg2\t{json.dumps({'objects': []})}\n")
    with open(tmp_path / "cap.json", "w") as f:
        json.dump({"img1": [{"caption": "a cat"}]}, f)
    os.makedirs(tmp_path / "ocr")
    with open(tmp_path / "ocr" / "img1_ocr.json", "w") as f:
        json.dump({"filtered_text_annotations": [
            {"description": "ME\nOW", "vertices": [[1, 1], [4, 1], [4, 4], [1, 4]]},
            {"description": "STOP", "vertices": [[60, 60], [90, 60], [90, 80], [60, 80]]}]}, f)
    vin = _both("okvqa_ops", "LoadVinVLFeatures", lambda pkg: None,
                VinVL_features={"train": str(tmp_path / "vinvl.tsv"), "test": "/missing"})
    _both("okvqa_ops", "LoadOscarCaptionFeatures", lambda pkg: None,
          caption_features={"train": str(tmp_path / "cap.json")})
    for combine in (False, True):
        _both("okvqa_ops", "LoadGoogleOCRFeatures",
              lambda pkg: json.loads(json.dumps(vin)), tol=TOL,
              ocr_features={"train": str(tmp_path / "ocr"), "combine_with_vinvl": combine})


# ---------------------------------------------------------------- Visual Genome
def test_visual_genome_equal_jax(tmp_path):
    meta = [{"image_id": i, "url": f"https://x/VG_100K{'_2' if i % 2 else ''}/{i}.jpg"}
            for i in range(7)]
    regions = [{"id": i, "regions": [{"phrase": f"phrase {i % 3}"}, {"phrase": "shared"}]}
               for i in range(0, 7, 2)]
    for name, obj in (("meta.json", meta), ("regions.json", regions)):
        with open(tmp_path / name, "w") as f:
            json.dump(obj, f)
    paths = {"image_data_path": "/vg", "image_meta_file": str(tmp_path / "meta.json"),
             "region_description_file": str(tmp_path / "regions.json")}
    loaded = _both("vg_ops", "LoadVisualGenomeData", lambda pkg: None, data_paths=paths)
    assert len(loaded["train"]) == 7

    def vg(pkg):
        return _node(pkg, "vg_ops", "LoadVisualGenomeData", data_paths=paths)(None)

    for ratio in (0.8, 0.5):
        _both("vg_ops", "PrepareVisualGenomeForRetrieval", vg, train_valid_ratio=ratio, seed=3)
    # the simplified schema (dummy rows)
    _both("vg_ops", "PrepareVisualGenomeForRetrieval",
          lambda pkg: {"train": _make(pkg)({"question": ["a", "b"]}),
                       "test": _make(pkg)({"question": ["c"], "pos_item_ids": [["x"]]})})
    _both("vg_ops", "LoadVisualGenomeData", lambda pkg: None, dummy=True)


# ---------------------------------------------------------------------- WIT
WIT_HEADER = ["language", "page_url", "image_url", "page_title", "section_title",
              "hierarchical_section_title", "caption_reference_description",
              "caption_attribution_description", "caption_alt_text_description", "mime_type",
              "original_height", "original_width", "is_main_image", "context_page_description"]


def _wit_tsv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(WIT_HEADER)
        for r in rows:
            w.writerow(r)


def _wit_rows(start, n):
    return [["en" if i % 4 else "fr", f"https://en.wikipedia.org/wiki/P{i}",
             f"https://upload/{i % 5}.jpg", f"Page {i}", "" if i % 3 else f"Section {i}", "",
             f"ref desc {i}" if i % 2 else "", "", "alt", "image/jpeg", str(100 + i),
             str(200 + i), "True" if i % 2 else "False",
             " ".join(f"word{j}" for j in range(3 + 7 * (i % 4)))]
            for i in range(start, start + n)]


def test_wit_pipeline_equals_jax(tmp_path):
    _wit_tsv(tmp_path / "train_0.tsv", _wit_rows(0, 9))
    _wit_tsv(tmp_path / "train_1.tsv", _wit_rows(9, 6))
    _wit_tsv(tmp_path / "valid.tsv", _wit_rows(20, 5))
    data_paths = {"train": [str(tmp_path / "train_0.tsv"), str(tmp_path / "train_1.tsv")],
                  "valid": str(tmp_path / "valid.tsv"), "image_data_path": "/ignored"}
    for main in (False, True):
        _both("wit_ops", "LoadWITData", lambda pkg: None, data_paths=data_paths,
              only_main_image=main)

    def loaded(pkg):
        return _node(pkg, "wit_ops", "LoadWITData", data_paths=data_paths)(None)

    passages = _both("wit_ops", "LoadWITPassages", loaded)
    _both("wit_ops", "TruncateWITPassages",
          lambda pkg: _node(pkg, "wit_ops", "LoadWITPassages")(loaded(pkg)),
          truncation_length=12)
    assert len(passages["passages"]) == 14

    # the join and group-by: passages carry the rows' original_data_id
    def joined(pkg):
        data = loaded(pkg)
        full = _node(pkg, "wit_ops", "LoadWITPassages")(data)["passages"]
        data["passages"] = full.add_column(
            "original_data_id_x", [f"x{i}" for i in range(len(full))]).rename_columns(
            {"original_data_id": "original_data_id", "original_data_id_x": "extra"})
        return data

    with open(tmp_path / "iglue.jsonl", "w") as f:
        for r in _wit_rows(20, 5)[1::2]:
            if r[0] == "en":
                f.write(json.dumps({"page_url": r[1], "image_url": r[2],
                                    "caption_reference_description": r[6] or None}) + "\n")
    for iglue in (None, str(tmp_path / "iglue.jsonl")):
        prepared = _both("wit_ops", "PrepareWITDataForRetrieval", joined, iglue_test_file=iglue)
    _both("wit_ops", "SplitWITPassagesForLargeScaleTraining",
          lambda pkg: _node(pkg, "wit_ops", "PrepareWITDataForRetrieval")(joined(pkg)))
    assert all(len(r["pos_item_ids"]) >= 1 for r in prepared["train"])

    # annotations, corpus and image-registry reduction
    def annotated_inputs(pkg):
        full = _node(pkg, "wit_ops", "LoadWITPassages")(loaded(pkg))["passages"]
        qs = loaded(pkg)["train"]
        qs = qs.add_column("answers", [["word1"] if i % 2 else [] for i in range(len(qs))])
        indexed = _node(pkg, "wit_ops", "IndexWITPassagesWithElasticSearch")(
            {"train_passages": full})
        return [{"train": qs, "train_passages": full}, indexed]

    _both("wit_ops", "IndexWITPassagesWithElasticSearch",
          lambda pkg: {"train_passages": annotated_inputs(pkg)[0]["train_passages"]})
    _both("wit_ops", "PrepareWITPassageAnnotations", annotated_inputs, k=3)

    def annotated(pkg):
        return _node(pkg, "wit_ops", "PrepareWITPassageAnnotations", k=3)(annotated_inputs(pkg))

    _both("wit_ops", "ReduceWITPassagesSize", annotated)
    _both("wit_ops", "RemoveWITPassagesWithoutImages", annotated)
    for validate in (False, True):
        _both("wit_ops", "PrepareImagesForWITData", annotated, image_data_path=str(tmp_path),
              validate=validate)

    def registered(pkg):
        return _node(pkg, "wit_ops", "PrepareImagesForWITData", validate=False,
                     image_data_path="/img")(annotated(pkg))

    _both("wit_ops", "ReduceWITImagesSize",
          lambda pkg: {**registered(pkg), "passages": _make(pkg)(
              {"passage_id": ["a"], "image_id": [registered(pkg)["train"][0]["image_id"]]})})
    _both("wit_ops", "ConcatenateImageCorpus",
          lambda pkg: [{"images": {"x": {"img_id": "x"}},
                        "image_dataset_with_embeddings": _make(pkg)({"image_id": ["x"],
                                                                     "f": [[1.0]]})},
                       {"images": {"y": {"img_id": "y"}},
                        "image_dataset_with_embeddings": _make(pkg)({"image_id": ["y"],
                                                                     "f": [[2.0]]})}])


def test_wit_image_validation_and_pixel_conversion(tmp_path):
    """The registry's validation on real files (PNG, baseline JPEG,
    progressive JPEG, a truncated file, a missing one) and the base64
    ``image_pixels`` conversion write the same files as the JAX nodes."""
    img = np.random.default_rng(1).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    PIL_Image.fromarray(img).save(tmp_path / "b.jpg")
    PIL_Image.fromarray(img).save(tmp_path / "c.jpg", progressive=True)
    (tmp_path / "d.jpg").write_bytes(b"\xff\xd8\xff\xe0\x00")
    rows = {"image_id": ["a", "b", "c", "d", "e"],
            "img_path": [str(tmp_path / n) for n in ("a.png", "b.jpg", "c.jpg", "d.jpg",
                                                     "e.jpg")]}
    out = _both("wit_ops", "PrepareImagesForWITData",
                lambda pkg: {"train": _make(pkg)(rows)}, validate=True)
    assert sorted(out["images"]) == ["a", "b", "c"]
    _both("wit_ops", "PrepareImagesForWITDataFromPassages",
          lambda pkg: {"passages": _make(pkg)(rows)}, validate=True)

    os.makedirs(tmp_path / "pixels")
    with open(tmp_path / "pixels" / "shard.tsv", "w") as f:
        for i, size in enumerate(((20, 30), (4, 40), (33, 17))):
            buf = io.BytesIO()
            PIL_Image.fromarray(np.full((*size, 3), 40 * i, np.uint8)).save(buf, "PNG")
            f.write(f"https://img/{i}.png\t{base64.b64encode(buf.getvalue()).decode()}\tm\n")
        f.write("https://img/bad.png\tnot-base64-image\tm\nshort\n")
    got = {}
    for pkg in (J, P):
        got[pkg] = _node(pkg, "wit_ops", "ConvertWITImagePixels", pixels_dir=str(
            tmp_path / "pixels"), images_dir=str(tmp_path / pkg))(None)
    _same(got[J], got[P])
    assert len(got[P]) == 2
    for name in os.listdir(tmp_path / J):
        assert (tmp_path / J / name).read_bytes() == (tmp_path / P / name).read_bytes()


# --------------------------------------------------------------- feature store
def test_feature_store_is_shared_between_packages(tmp_path):
    from reranking_multimodal_retrievers_tpu.data.feature_store import FeatureStore as JStore
    from reranking_multimodal_retrievers_tpu_torch.data.feature_store import FeatureStore

    a, b = JStore(str(tmp_path), "s"), FeatureStore(str(tmp_path), "s")
    a.put("img/1?", np.arange(5, dtype=np.float32))
    b.put("cap_2", "a caption")
    a.put("both", {"x": [1, 2]})
    for reader in (a, b):
        np.testing.assert_array_equal(reader.get("img/1?"), np.arange(5, dtype=np.float32))
        assert reader.get("cap_2") == "a caption" and reader.get("both") == {"x": [1, 2]}
        assert list(reader.keys()) == list(a.keys()) and len(reader) == 3


# ------------------------------------------------------------------ features
def _jax_vit_params(cfg):
    import jax.numpy as jnp
    from reranking_multimodal_retrievers_tpu.models.vit import CLIPVisionModel

    dummy = jnp.zeros((1, 3, cfg.image_size, cfg.image_size), jnp.float32)
    return jax.device_get(CLIPVisionModel(cfg).init(jax.random.PRNGKey(0), dummy)["params"])


def _images(tmp_path, size=32, n=5):
    """PNGs and one baseline JPEG at ``size`` (no resize: both packages'
    preprocessing is then the same bitwise), plus a missing path."""
    rng = np.random.default_rng(7)
    paths = []
    for i in range(n):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        p = str(tmp_path / f"img{i}.{'jpg' if i == 1 else 'png'}")
        if i == 1:
            PIL_Image.fromarray(img).save(p, quality=90)
        else:
            write_png(p, img)
        paths.append(p)
    return paths + ["", str(tmp_path / "missing.png")]


@pytest.mark.parametrize("version", ["", "v2", "v3"])
def test_vit_features_equal_jax(tmp_path, version):
    from reranking_multimodal_retrievers_tpu.models.vit import CLIPVisionConfig

    paths = _images(tmp_path)
    ids = [f"i{i % 4}" for i in range(len(paths))]  # repeated images, as M2KR's
    rows = {"image_id": ids, "img_path": paths}
    vision = {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4, "image_size": 32, "patch_size": 16}
    params = _jax_vit_params(CLIPVisionConfig(**vision))
    name = f"ExtractImageFeaturesWithViT{version}"
    kw = dict(vision_config=vision, batch_size=3)
    if version:
        kw["cache_folder"] = None
    out = {}
    for pkg in (J, P):
        if version:
            kw["cache_folder"] = str(tmp_path / pkg)
        f = _node(pkg, "feature_ops", name, **kw)
        if pkg == P:
            f._build_encoder()
            f._model.load_state_dict(weights.clip_vision_state_dict(params))
        out[pkg] = f({"train": _make(pkg)(rows), "train_passages": _make(pkg)({"p": [1]})})
    _same(out[J], out[P], name, TOL)
    if version:  # the stores hold the same features
        from reranking_multimodal_retrievers_tpu_torch.data.feature_store import FeatureStore

        index = "vit_features" if version == "v2" else "encoded_image_features"
        for key in set(ids):
            np.testing.assert_allclose(FeatureStore(str(tmp_path / P), index).get(key),
                                       FeatureStore(str(tmp_path / J), index).get(key), **TOL)


def test_vit_processor_and_vae_features_equal_jax(tmp_path):
    from reranking_multimodal_retrievers_tpu.data.ops.feature_ops import _VAEEncoder

    paths = _images(tmp_path, size=32)
    # every path a file: the JAX node fails on a row it gives no pixel_values
    _both("feature_ops", "ProcessImageWithViTProcessor",
          lambda pkg: {"train": _make(pkg)({"img_path": paths[:5]})}, image_size=32)
    params = jax.device_get(_VAEEncoder(8, 32).init_params(jax.random.PRNGKey(0))["params"])
    out = {}
    for pkg in (J, P):
        f = _node(pkg, "feature_ops", "ExtractImageFeaturesWithVAE", latent_dim=8,
                  image_size=32, batch_size=3)
        if pkg == P:
            f._build_encoder().load_state_dict(weights.vae_encoder_state_dict(params))
        out[pkg] = f({"train": _make(pkg)({"img_path": paths})})
    _same(out[J], out[P], "vae", TOL)
    # an odd size: flax's SAME padding (1, 1) at 15, (0, 1) at 8 and 4
    from reranking_multimodal_retrievers_tpu_torch.data.ops.feature_ops import _same_pad

    assert [_same_pad(n) for n in (32, 15, 8)] == [(0, 1), (1, 1), (0, 1)]


# ----------------------------------------------------------- captioner (BLIP-2)
def _tiny_blip2(tmp_path):
    """A tiny BLIP-2 config dict, its JAX params, an HF-named checkpoint
    directory of them, and a WordPiece tokenizer directory."""
    import jax.numpy as jnp
    from reranking_multimodal_retrievers_tpu.models import blip2 as jb
    from reranking_multimodal_retrievers_tpu.models import t5 as jt
    from reranking_multimodal_retrievers_tpu.models.tokenization import tiny_bert_tokenizer

    # a vocabulary larger than the tokenizer's, so that a prompt's ids embed
    cfg = jb.Blip2Config.tiny(text_config=jt.T5Config.tiny(vocab_size=256))
    model = jb.Blip2ForConditionalGeneration(cfg)
    params = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.ones((1, 2), jnp.int32), jnp.ones((1, 2), jnp.int32),
        jnp.zeros((1, 1), jnp.int32), pixel_values=jnp.zeros((1, 3, 32, 32)))["params"])
    ckpt = tmp_path / "blip2_ckpt"
    ckpt.mkdir()
    write_safetensors(str(ckpt / "model.safetensors"), weights.blip2_state_dict(params))
    # saved as HF saves it, so that AutoTokenizer reads it too
    tiny_bert_tokenizer(str(tmp_path / "tok_src"), ["a", "b", "c", "photo", "of"]
                        ).save_pretrained(str(tmp_path / "tok"))
    conf = {k: dataclasses.asdict(getattr(cfg, k))
            for k in ("vision_config", "qformer_config", "text_config")}
    conf["num_query_tokens"] = cfg.num_query_tokens
    return conf, model, params, str(ckpt), str(tmp_path / "tok")


@pytest.mark.parametrize("prompt", ["", "a photo of"])
def test_blip2_greedy_captions_equal_jax(tmp_path, prompt):
    from reranking_multimodal_retrievers_tpu.data.ops.infoseek_ops import (
        blip2_greedy_captions as jcaptions)
    from reranking_multimodal_retrievers_tpu_torch.data.ops.infoseek_ops import (
        blip2_greedy_captions, build_captioner, load_caption_tokenizer)

    conf, model, params, ckpt, tok_dir = _tiny_blip2(tmp_path)
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(5)]
    from transformers import BertTokenizerFast

    want = jcaptions(model, params, BertTokenizerFast.from_pretrained(tok_dir),
                     [PIL_Image.fromarray(i) for i in imgs], prompt=prompt, max_new_tokens=6,
                     image_size=32)
    got = blip2_greedy_captions(build_captioner(conf, ckpt), load_caption_tokenizer(tok_dir),
                                imgs, prompt=prompt, max_new_tokens=6, image_size=32)
    assert got == want
    with pytest.raises(NotImplementedError, match="SentencePiece"):
        load_caption_tokenizer(str(tmp_path))


def _tiny_unigram_dir(path):
    """A T5-style Unigram tokenizer directory (ids under the tiny T5's 256):
    letters, ``▁``-words and their parts, a charsmap of full-width forms."""
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (
        write_precompiled_charsmap, write_unigram_tokenizer)

    rng = np.random.default_rng(5)
    words = ["a", "photo", "of", "the", "cat", "on", "mat", "sun", "ph", "oto", "at", "th"]
    pieces = list(dict.fromkeys(["▁", *"abcdefghijklmnopqrstuvwxyz.,",
                                 *("▁" + w for w in words), *words]))
    scores = (-rng.integers(4, 60, len(pieces)) / 4.0).tolist()
    charsmap = write_precompiled_charsmap({chr(0xFF01 + i): chr(0x21 + i) for i in range(94)})
    return write_unigram_tokenizer(path, pieces, scores, charsmap, extra_ids=8)


@pytest.mark.parametrize("prompt", ["a photo of", "ａ <extra_id_0> photo of the cat on the "
                                    "mat under the sun, a photo"])
def test_blip2_greedy_captions_unigram_equal_jax(tmp_path, prompt):
    """The captioner with Flan-T5's kind of tokenizer: the port's captions
    with a prompt through ``UnigramTokenizer`` equal the JAX package's through
    ``AutoTokenizer`` on the same directory and weights, as strings; the
    second prompt is longer than the encoder's 16 prompt tokens."""
    from transformers import AutoTokenizer

    from reranking_multimodal_retrievers_tpu.data.ops.infoseek_ops import (
        blip2_greedy_captions as jcaptions)
    from reranking_multimodal_retrievers_tpu_torch.data.ops.infoseek_ops import (
        blip2_greedy_captions, build_captioner, load_caption_tokenizer)
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import UnigramTokenizer

    conf, model, params, ckpt, _ = _tiny_blip2(tmp_path)
    tok_dir = _tiny_unigram_dir(str(tmp_path / "unigram"))
    tok = load_caption_tokenizer(tok_dir)
    assert isinstance(tok, UnigramTokenizer)
    hf = AutoTokenizer.from_pretrained(tok_dir)
    enc = [t([prompt], padding="max_length", truncation=True, max_length=16,
             return_tensors="np") for t in (hf, tok)]
    np.testing.assert_array_equal(enc[0]["input_ids"], enc[1]["input_ids"])
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(5)]
    want = jcaptions(model, params, hf, [PIL_Image.fromarray(i) for i in imgs], prompt=prompt,
                     max_new_tokens=6, image_size=32)
    got = blip2_greedy_captions(build_captioner(conf, ckpt), tok, imgs, prompt=prompt,
                                max_new_tokens=6, image_size=32)
    assert got == want
    assert any(got), "every caption decoded empty: the check would be vacuous"


@pytest.mark.parametrize("version", ["", "v2", "v3"])
def test_caption_nodes_equal_jax(tmp_path, version):
    conf, _, _, ckpt, tok_dir = _tiny_blip2(tmp_path)
    paths = _images(tmp_path)
    rows = {"question_id": [f"q{i}" for i in range(len(paths))], "img_path": paths}
    kw = dict(captioner_checkpoint=ckpt, tokenizer_name=tok_dir, blip2_config=conf,
              max_caption_length=5, batch_size=3)
    out = {}
    for pkg in (J, P):
        if version:
            kw["caption_store_dir"] = str(tmp_path / pkg)
        f = _node(pkg, "infoseek_ops", f"CaptionImageWithBLIP2{version}", **kw)
        if version == "v3":  # every row's caption in the store: none decoded
            for qid in rows["question_id"]:
                f.store.put(qid, f"stored {qid}")
        out[pkg] = f({"train": _make(pkg)(rows), "train_passages": _make(pkg)({"p": [1]})})
    _same(out[J], out[P])
    if version == "v3":
        assert out[P]["train"]["caption"] == [f"stored {q}" for q in rows["question_id"]]
        # a store holding some rows: those are restored and the rest decoded
        # as v1 decodes them (the JAX node raises on this input: datasets'
        # map sees a column only some rows return)
        v1 = _node(J, "infoseek_ops", "CaptionImageWithBLIP2", **{
            k: v for k, v in kw.items() if k != "caption_store_dir"})({"train": _make(J)(rows)})
        kw["caption_store_dir"] = str(tmp_path / "partial")
        f = _node(P, "infoseek_ops", "CaptionImageWithBLIP2v3", **kw)
        f.store.put("q3", "stored q3")
        want = list(v1["train"]["caption"])
        want[3] = "stored q3"
        assert f({"train": Table.from_dict(rows)})["train"]["caption"] == want


# ----------------------------------------------------------------- teacher
TEACHER = {"text_config": {"vocab_size": 30522, "hidden_size": 32, "num_hidden_layers": 1,
                           "num_attention_heads": 4, "intermediate_size": 64},
           "vision_config": {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 1,
                             "num_attention_heads": 4, "image_size": 32, "patch_size": 16},
           "dim": 16, "use_vision_encoder": False}


def _teacher_checkpoint(path, flmr_config=TEACHER, seed=11):
    """An HF-named FLMR checkpoint directory (the port's model drawn from a
    seed, its state dict written as safetensors)."""
    from reranking_multimodal_retrievers_tpu_torch.data.ops.distillation_ops import (
        PrepareDistillationScores)

    f = PrepareDistillationScores(use_dummy_data=False)
    f.setup(flmr_config=flmr_config, seed=seed)
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"), f.build_teacher().state_dict())
    return path


def test_live_teacher_scores_equal_jax(tmp_path):
    ckpt = _teacher_checkpoint(str(tmp_path / "teacher"))

    def data(pkg):
        m2kr = __import__(f"{pkg}.data.ops.m2kr_ops", fromlist=["x"]).make_dummy_m2kr(
            num_rows=11, num_passages=9)
        return {k: m2kr[k] for k in ("train", "test", "train_passages")}

    out = {}
    for pkg in (J, P):
        out[pkg] = _node(pkg, "distillation_ops", "PrepareDistillationScores",
                         flmr_config=TEACHER, model_checkpoint_dir=ckpt, num_negatives=3,
                         query_maxlen=16, doc_maxlen=24, seed=5)(data(pkg))
    want, got = out[J], out[P]
    assert list(got) == list(want)
    for split in want:
        assert got[split].column_names == want[split].column_names
        for w, g in zip(want[split], got[split]):
            np.testing.assert_allclose(g.pop("scores", []), w.pop("scores", []), rtol=1e-5,
                                       atol=0)
            assert g == dict(w), split
    assert len(got["train"][0]["neg_item_ids"]) == 3

    with open(tmp_path / "scores.json", "w") as f:
        json.dump({"q1": [{"passage_id": "p3", "score": 2.5}, {"passage_id": "p1"}]}, f)
    _both("distillation_ops", "PrepareDistillationScores", data,
          teacher_scores_path=str(tmp_path / "scores.json"), docs_per_query=1)


def test_model_nodes_refuse_without_a_card(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("RMRT_PLATFORM")
    from reranking_multimodal_retrievers_tpu_torch.data.ops import (distillation_ops,
                                                                    feature_ops, infoseek_ops)

    calls = [lambda: feature_ops.ExtractImageFeaturesWithViT().setup()._build_encoder(),
             lambda: feature_ops.ExtractImageFeaturesWithVAE().setup()._build_encoder(),
             lambda: distillation_ops.PrepareDistillationScores().setup(
                 flmr_config=TEACHER).build_teacher(),
             lambda: infoseek_ops.build_captioner({})]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ------------------------------------------------------ the slice, from the CLI
def _m2kr_directories(root, n_train=6, n_test=4, n_passages=12):
    """An M2KR-shaped ``DatasetDict`` (``make_dummy_m2kr``'s columns) and its
    passages, written by ``datasets``, with 32 x 32 images (one a JPEG)
    repeated across questions."""
    rng = np.random.default_rng(0)
    imgs = []
    for i in range(3):
        img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        p = os.path.join(root, "images", f"{i}.{'jpg' if i == 0 else 'png'}")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        if i == 0:
            PIL_Image.fromarray(img).save(p, quality=92)
        else:
            write_png(p, img)
        imgs.append(p)
    answers = ["paris", "rome", "berlin"]

    def split(n, off):
        return datasets.Dataset.from_dict({
            "question_id": [f"q{off + i}" for i in range(n)],
            "question": [f"what is the capital related to item {off + i}" for i in range(n)],
            "instruction": ["Answer the following question with the image:"] * n,
            "img_path": [imgs[i % 3] for i in range(n)],
            "answers": [[answers[i % 3]] for i in range(n)],
            "gold_answer": [answers[i % 3] for i in range(n)],
            "pos_item_ids": [[f"p{(off + i) % n_passages}"] for i in range(n)],
            "source_name": ["evqa"] * n})

    passages = datasets.Dataset.from_dict({
        "passage_id": [f"p{i}" for i in range(n_passages)],
        "passage_content": [f"passage {i} about {answers[i % 3]} the capital city"
                            for i in range(n_passages)],
        "source_name": ["evqa"] * n_passages})
    datasets.DatasetDict({"train": split(n_train, 0), "test": split(n_test, 100)}).save_to_disk(
        os.path.join(root, "EVQA_data"))
    datasets.DatasetDict({"train_passages": passages, "test_passages": passages}).save_to_disk(
        os.path.join(root, "EVQA_passages"))


NODES = ("input:LoadM2KR", "process:Caption", "process:ViT", "process:Distill")


def _slice_config(tmp_path):
    """``configs/evqa_flmr.json`` with phase 13's pipeline at a tiny size."""
    from reranking_multimodal_retrievers_tpu.models.vit import CLIPVisionConfig

    conf, _, _, ckpt, tok_dir = _tiny_blip2(tmp_path)
    vision = {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 1,
              "num_attention_heads": 4, "image_size": 32, "patch_size": 16}
    vit_ckpt = tmp_path / "vit"
    vit_ckpt.mkdir()
    # the inner vision_model's names, as the JAX node's checkpoint holds them
    sd = weights.clip_vision_state_dict(_jax_vit_params(CLIPVisionConfig(**vision)))
    write_safetensors(str(vit_ckpt / "model.safetensors"),
                      {k.removeprefix("vision_model."): v for k, v in sd.items()})
    teacher = _teacher_checkpoint(str(tmp_path / "teacher"))
    _m2kr_directories(str(tmp_path / "m2kr"))
    with open(os.path.join(ROOT, "configs", "evqa_flmr.json")) as f:
        cfg = json.load(f)
    t = cfg["data_pipeline"]["transforms"]
    t["input:LoadM2KR"]["setup_kwargs"] = {
        "data_path": f"{tmp_path / 'm2kr' / 'EVQA_data'}///EVQA_data",
        "passage_path": f"{tmp_path / 'm2kr' / 'EVQA_passages'}///EVQA_passages",
        "num_data": {"train": 5, "test": 4}}
    t["process:Caption"] = {"transform_name": "CaptionImageWithBLIP2v3",
                            "input_node": "input:LoadM2KR", "setup_kwargs": {
                                "captioner_checkpoint": ckpt, "tokenizer_name": tok_dir,
                                "blip2_config": conf, "max_caption_length": 4, "batch_size": 2,
                                "caption_store_dir": "store"}}
    t["process:ViT"] = {"transform_name": "ExtractImageFeaturesWithViTv2",
                        "input_node": "process:Caption", "setup_kwargs": {
                            "vision_config": vision, "checkpoint_dir": str(vit_ckpt),
                            "batch_size": 4, "cache_folder": "store"}}
    t["process:Distill"] = {"transform_name": "PrepareDistillationScores",
                            "input_node": "process:ViT", "setup_kwargs": {
                                "flmr_config": TEACHER, "model_checkpoint_dir": teacher,
                                "num_negatives": 4, "query_maxlen": 16, "doc_maxlen": 24}}
    t["process:Wrap"]["input_node"] = "process:Distill"
    for node in NODES:
        t[node]["cache"] = True
    dc = t["output:PrepareDataloaders"]["setup_kwargs"]["datasets_config"]
    dc["valid"][0]["split"] = "test"
    cfg["meta"]["EXPERIMENT_FOLDER"] = "experiments"
    path = tmp_path / "slice.json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def _cached(pkg, workdir, node):
    cache = __import__(f"{pkg}.data.cache_system", fromlist=["x"])
    safe = node.replace(":", "__")
    names = [n for n in os.listdir(workdir / "cache") if n.startswith(safe + "-")]
    assert len(names) == 1, (node, names)
    stem = names[0].removesuffix(".hf").removesuffix(".tables.pkl").removesuffix(".pkl")
    return cache.load_data_from_disk(stem, str(workdir / "cache"))


def test_prepare_data_cli_equals_jax_then_test(tmp_path, monkeypatch):
    from reranking_multimodal_retrievers_tpu.cli import main as jmain
    from reranking_multimodal_retrievers_tpu_torch.cli import main as pmain

    config = _slice_config(tmp_path)
    for pkg, cli in ((J, jmain), (P, pmain)):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        assert cli.main(["--config", config, "--mode", "prepare_data"]) == 0
    for node in NODES:
        want = _cached(J, tmp_path / J, node)
        got = _cached(P, tmp_path / P, node)
        _same(dict(want), got, node, TOL)
    got = _cached(P, tmp_path / P, "process:Distill")
    assert {"caption", "image_features", "neg_item_ids", "scores"} <= set(
        got["train"].column_names)
    assert len(got["train"]) == 5 and len(got["test"]) == 4
    # the port's FLMR test over the prepared data (served from its cache)
    assert pmain.main(["--config", config, "--mode", "test"]) == 0
    exp = tmp_path / P / "experiments" / "evqa_flmr"
    assert any(exp.rglob("test_predictions_rank_0.json"))
