"""OK-VQA raw-data transforms (port of the JAX package's
``data/ops/okvqa_ops.py`` over ``data/table.py`` tables; reference
`src/data_ops/vqa_data_ops.py`).

These load the original OK-VQA annotation/question JSONs + Google-Search
corpus rather than the preprocessed M2KR tables; all functors synthesize
M2KR-shaped dummy data offline so pipelines run without the raw files.
"""

from __future__ import annotations

import json
import logging
import os

from ...utils.registries import register_transform_functor
from ..table import Table, concatenate_tables
from ..transforms import HFDatasetTransform
from .m2kr_ops import make_dummy_m2kr

logger = logging.getLogger(__name__)


@register_transform_functor
class LoadOKVQAData(HFDatasetTransform):
    """Parse OK-VQA v1.1 question/annotation JSONs into question rows with
    answer lists and image paths (reference `vqa_data_ops.py:265-497`)."""

    def setup(self, vqa_data_path=None, image_data_path=None, **kwargs):
        self.vqa_data_path = vqa_data_path or {}
        self.image_data_path = image_data_path or {}
        return self

    def _call(self, data=None):
        from collections import Counter

        if self.use_dummy_data or not self.vqa_data_path:
            return make_dummy_m2kr()

        out = {}
        for split, paths in self.vqa_data_path.items():
            with open(paths["question_file"]) as f:
                questions = {q["question_id"]: q for q in json.load(f)["questions"]}
            with open(paths["annotation_file"]) as f:
                annotations = json.load(f)["annotations"]
            rows = {k: [] for k in
                    ("question_id", "question", "img_path", "answers", "gold_answer")}
            img_dir = self.image_data_path.get(split, "")
            prefix = paths.get("image_prefix", "COCO_val2014_")
            for ann in annotations:
                q = questions[ann["question_id"]]
                answers = [a["answer"] for a in ann["answers"]]
                rows["question_id"].append(str(ann["question_id"]))
                rows["question"].append(q["question"])
                rows["img_path"].append(
                    os.path.join(img_dir, f"{prefix}{ann['image_id']:012d}.jpg")
                )
                rows["answers"].append(answers)
                rows["gold_answer"].append(Counter(answers).most_common(1)[0][0])
            out[split] = Table.from_dict(rows)
        return out


@register_transform_functor
class LoadGoogleSearchPassageData(HFDatasetTransform):
    """Load the Google-Search passage corpus (reference `vqa_data_ops.py:690-802`)."""

    def setup(self, passage_data_path=None, use_full_split=True, **kwargs):
        self.passage_data_path = passage_data_path
        self.use_full_split = use_full_split
        return self

    def _call(self, data=None):
        import csv

        if self.use_dummy_data or not self.passage_data_path:
            d = make_dummy_m2kr()
            return {"train_passages": d["train_passages"],
                    "valid_passages": d["valid_passages"],
                    "test_passages": d["test_passages"]}
        rows = {"passage_id": [], "passage_content": []}
        with open(self.passage_data_path) as f:
            reader = csv.reader(f, delimiter="\t")
            for i, row in enumerate(reader):
                rows["passage_id"].append(str(row[0]))
                rows["passage_content"].append(row[1])
        table = Table.from_dict(rows)
        return {f"{s}_passages": table for s in ("train", "valid", "test")}


@register_transform_functor
class LoadGoogleSearchAnnotations(HFDatasetTransform):
    """Attach pseudo-relevance positives from Google-Search annotations
    (reference `vqa_data_ops.py:804-944`): per question, passages whose
    content contains an answer string become ``pos_item_ids``."""

    def setup(self, annotations_path=None, use_all_samples: bool = False,
              **kwargs):
        self.annotations_path = annotations_path or {}
        # reference `vqa_data_ops.py:880-895`: questions with no matching
        # passage are DROPPED in train mode; with use_all_samples (testing)
        # they get the sentinel first passage instead
        self.use_all_samples = use_all_samples
        return self

    def _call(self, inputs):
        if isinstance(inputs, list):
            data, passages = inputs
        else:
            data, passages = inputs, None
        if self.use_dummy_data or passages is None:
            return data if isinstance(data, dict) else make_dummy_m2kr()

        id2content = {}
        for key in passages.keys():
            for row in passages[key]:
                id2content[row["passage_id"]] = row["passage_content"]
        # lower the corpus once, not once per question (the real GS corpus
        # is ~112k passages × ~14k questions)
        lowered = [(pid, content.lower())
                   for pid, content in id2content.items()]
        sentinel = [next(iter(id2content))] if id2content else []

        def annotate(example):
            answers = [a.lower() for a in example["answers"]]
            pos = [pid for pid, content in lowered
                   if any(a in content for a in answers)]
            example["pos_item_ids"] = pos[:10] or (
                sentinel if self.use_all_samples else [])
            return example

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            mapped = data[split].map(annotate)
            if not self.use_all_samples:
                mapped = mapped.filter(lambda x: len(x["pos_item_ids"]) > 0)
            data[split] = mapped
        for key in passages.keys():
            data[key] = passages[key]
        return data


def select_roi_objects(objects, question: str, max_objects: int):
    """The reference's ROI selection policy (`vqa_data_ops.py:517-551`):
    objects whose class name appears in the question are always selected;
    the rest are considered largest-area first and dropped when contained in
    an already-selected object of the same class; capped at ``max_objects``."""
    selected = []
    sized = []
    for obj in objects or []:
        if not isinstance(obj, dict) or "rect" not in obj:
            continue
        xmin, ymin, xmax, ymax = obj["rect"]
        area = (ymax - ymin) * (xmax - xmin)
        sized.append((area, obj))
        cls = str(obj.get("class", "")).lower().strip()
        if cls and cls in (question or "").lower():
            selected.append(obj)
    sized.sort(key=lambda t: t[0], reverse=True)
    for _, obj in sized:
        if len(selected) >= max_objects:
            break
        xmin, ymin, xmax, ymax = obj["rect"]
        valid = True
        for ex in selected:
            if ex.get("class") == obj.get("class"):
                e_xmin, e_ymin, e_xmax, e_ymax = ex["rect"]
                if xmin >= e_xmin and ymin >= e_ymin and xmax <= e_xmax and ymax <= e_ymax:
                    valid = False  # contained duplicate of the same class
        if valid:
            selected.append(obj)
    return selected[:max_objects] if max_objects else selected


@register_transform_functor
class CropRegionOfInterestImages(HFDatasetTransform):
    """Select and register object ROIs per question (reference
    `vqa_data_ops.py:499-598`): question-mentioned classes first, then
    largest-area objects with containment dedup; each ROI gets a stable id
    ``{img_path}|||{class}_{x1}_{y1}_{x2}_{y2}`` and a row in an ``images``
    registry table so feature pre-extraction picks the crops up."""

    def setup(self, max_objects: int = 4, **kwargs):
        self.max_objects = max_objects
        return self

    def _call(self, data):
        new_image_rows = {"id": [], "img_path": [], "obj_class": [], "crop": []}
        seen = set()

        def add_rois(example):
            selected = select_roi_objects(
                example.get("objects"), example.get("question", ""),
                self.max_objects,
            )
            rois = []
            for obj in selected:
                x1, y1, x2, y2 = (round(v, 2) for v in obj["rect"])
                rid = f"{example.get('img_path','')}|||{obj.get('class','')}_{x1}_{y1}_{x2}_{y2}"
                if rid not in seen:
                    seen.add(rid)
                    new_image_rows["id"].append(rid)
                    new_image_rows["img_path"].append(example.get("img_path", ""))
                    new_image_rows["obj_class"].append(str(obj.get("class", "")))
                    new_image_rows["crop"].append([x1, y1, x2, y2])
                rois.append(rid)
            example["ROIs"] = rois
            return example

        for split in [s for s in data.keys() if not s.endswith("_passages") and s != "images"]:
            if "objects" in data[split].column_names:
                data[split] = data[split].map(add_rois)

        roi_table = Table.from_dict(new_image_rows)
        if "images" in data:
            data["images"] = concatenate_tables(
                [data["images"].select_columns(sorted(
                    set(data["images"].column_names) & set(roi_table.column_names)
                )), roi_table.select_columns(sorted(
                    set(data["images"].column_names) & set(roi_table.column_names)
                ))]
            ) if len(roi_table) else data["images"]
        else:
            data["images"] = roi_table
        return data


def crop_roi_images(roi_ids, image_registry):
    """Materialize the crops for ROI ids from a registry built by
    :class:`CropRegionOfInterestImages` (`vqa_data_ops.py:554-572`), as RGB
    ``uint8 [h, w, 3]`` arrays where the JAX package gives PIL images: the
    same pixels, the box rounded to whole pixels as PIL's ``crop`` rounds
    it."""
    from ..image_io import read_image

    out = []
    for rid in roi_ids:
        row = image_registry.get(rid)
        if not row or not os.path.exists(row.get("img_path", "")):
            continue
        img = read_image(row["img_path"])
        h, w = img.shape[:2]
        x1, y1, x2, y2 = row["crop"]
        left, top, right, bottom = (int(round(v)) for v in (
            max(0, x1), max(0, y1), min(w, x2), min(h, y2)))
        out.append(img[top:bottom, left:right])
    return out


@register_transform_functor
class LoadVinVLFeatures(HFDatasetTransform):
    """Pre-extracted VinVL object detections from TSV
    (``image_key\\tjson``; per-object dense ``feature`` vectors dropped) —
    reference `vqa_data_ops.py:67-120`."""

    def setup(self, VinVL_features=None, **kwargs):
        self.vinvl_features = VinVL_features or {}
        return self

    def _call(self, data=None):
        import csv

        csv.field_size_limit(100_000_000)
        out = {}
        for split, path in self.vinvl_features.items():
            if not os.path.exists(path):
                logger.warning("VinVL file missing: %s", path)
                continue
            with open(path) as f:
                for row in csv.reader(f, delimiter="\t"):
                    image_key, prediction = row[0], json.loads(row[1])
                    for obj in prediction.get("objects", []):
                        obj.pop("feature", None)
                    out[image_key] = prediction
        logger.info("[Data Statistics] VinVL features %d", len(out))
        return {"vinvl_features": out}


@register_transform_functor
class LoadOscarCaptionFeatures(HFDatasetTransform):
    """Oscar caption JSONs merged into one {image_key: captions} dict
    (reference `vqa_data_ops.py:122-148`)."""

    def setup(self, caption_features=None, **kwargs):
        self.caption_features = caption_features or {}
        return self

    def _call(self, data=None):
        out = {}
        for path in self.caption_features.values():
            if not os.path.exists(path):
                logger.warning("caption file missing: %s", path)
                continue
            with open(path) as f:
                out.update(json.load(f))
        logger.info("[Data Statistics] Caption features %d", len(out))
        return {"caption_features": out}


def _poly_area(xs, ys):
    import numpy as np

    xs, ys = np.asarray(xs, float), np.asarray(ys, float)
    return 0.5 * abs(float(np.dot(xs, np.roll(ys, 1)) - np.dot(ys, np.roll(xs, 1))))


@register_transform_functor
class LoadGoogleOCRFeatures(HFDatasetTransform):
    """Per-image Google-OCR JSONs (``{image_key}_ocr.json``), optionally
    combined into the VinVL objects: an OCR region fully inside an object's
    box attaches its text with score = polygon_area / object_area
    (reference `vqa_data_ops.py:150-261`)."""

    def setup(self, ocr_features=None, **kwargs):
        self.ocr_config = ocr_features or {}
        return self

    def _call(self, inputs):
        import numpy as np

        vinvl = (inputs or {}).get("vinvl_features", {})
        ocr = {}
        for split in ("train", "test"):
            root = self.ocr_config.get(split)
            if not root:
                continue
            for image_key in vinvl:
                path = os.path.join(root, f"{image_key}_ocr.json")
                if os.path.exists(path):
                    with open(path) as f:
                        ocr[image_key] = json.load(f)
        with_ann = sum(
            1 for a in ocr.values() if a.get("filtered_text_annotations")
        )
        logger.info("[Data Statistics] OCR features %d, %d with annotations",
                    len(ocr), with_ann)

        if self.ocr_config.get("combine_with_vinvl"):
            for image_key, prediction in vinvl.items():
                count = 0
                for ann in ocr.get(image_key, {}).get("filtered_text_annotations", []):
                    description = ann["description"].replace("\n", " ")
                    vertices = ann["vertices"]
                    xs, ys = list(zip(*vertices))
                    area = _poly_area(xs, ys)
                    np_v = np.asarray(vertices, float)
                    for obj in prediction.get("objects", []):
                        xmin, ymin, xmax, ymax = obj["rect"]
                        obj_area = (ymax - ymin) * (xmax - xmin)
                        within = (
                            (np_v[:, 0] >= xmin).all() and (np_v[:, 0] <= xmax).all()
                            and (np_v[:, 1] >= ymin).all() and (np_v[:, 1] <= ymax).all()
                        )
                        score = area / obj_area if within and obj_area else 0.0
                        if score > 0:
                            count += 1
                            obj.setdefault("ocr", []).append(
                                {"text": description, "score": score}
                            )
                prediction["ocr"] = count
        return {"vinvl_features": vinvl, "ocr_features": ocr}
