"""Visual Genome transforms (port of the JAX package's ``data/ops/vg_ops.py``
over ``data/table.py`` tables; reference `src/data_ops/vg_data_ops.py:49-195`)."""

from __future__ import annotations

import json
import logging
import os
import random

from ...utils.registries import register_transform_functor
from ..table import Table
from ..transforms import HFDatasetTransform
from .m2kr_ops import _load_hf, make_dummy_m2kr

logger = logging.getLogger(__name__)


@register_transform_functor
class LoadVisualGenomeData(HFDatasetTransform):
    """Load VG image metadata + region descriptions from the official JSONs
    (reference `:49-114`): resolve each image to its VG_100K/VG_100K_2 path
    from the url and attach the region-description list."""

    def setup(self, data_path=None, data_paths=None, **kwargs):
        self.data_path = data_path
        self.data_paths = data_paths or {}
        return self

    def _call(self, data=None):
        if self.use_dummy_data or not (self.data_path or self.data_paths):
            return make_dummy_m2kr()
        if self.data_path:
            return _load_hf(self.data_path)

        image_data_path = self.data_paths["image_data_path"]
        with open(self.data_paths["image_meta_file"]) as f:
            image_meta = json.load(f)
        with open(self.data_paths["region_description_file"]) as f:
            region_descriptions = {e["id"]: e for e in json.load(f)}

        rows = {"img_id": [], "img_path": [], "descriptions": []}
        for img_dict in image_meta:
            img_id = img_dict["image_id"]
            img_dir = "VG_100K_2" if "VG_100K_2" in img_dict["url"] else "VG_100K"
            rows["img_id"].append(str(img_id))
            rows["img_path"].append(
                os.path.join(image_data_path, img_dir, f"{img_id}.jpg")
            )
            rows["descriptions"].append(
                [r["phrase"] for r in region_descriptions.get(img_id, {}).get("regions", [])]
            )
        logger.info("[Data Statistics] VG data %d", len(rows["img_id"]))
        return {"train": Table.from_dict(rows)}


@register_transform_functor
class PrepareVisualGenomeForRetrieval(HFDatasetTransform):
    """Region descriptions become the retrieval corpus (reference `:117-195`):
    descriptions are deduplicated into a passage table (content-keyed ids);
    each image's region phrases are its positives; images shuffle then split
    80/20 into train/valid."""

    def setup(self, train_valid_ratio: float = 0.8, seed: int = 42, **kwargs):
        self.train_valid_ratio = train_valid_ratio
        self.seed = seed
        return self

    def _call(self, data):
        table = data.get("train") or next(
            data[s] for s in data.keys() if not s.endswith("_passages")
        )
        if "descriptions" not in table.column_names:
            # simplified schema (dummy rows): 1 synthetic passage per row
            out = {}
            for split in [s for s in data.keys() if not s.endswith("_passages")]:
                t = data[split]
                if "pos_item_ids" in t.column_names:
                    out[split] = t
                    if f"{split}_passages" in data:
                        out[f"{split}_passages"] = data[f"{split}_passages"]
                    continue
                pids = [f"vg_{split}_{i}" for i in range(len(t))]
                contents = [
                    (row.get("passage_content") or row.get("question") or "")
                    for row in t
                ]
                out[split] = t.add_column("pos_item_ids", [[p] for p in pids])
                out[f"{split}_passages"] = Table.from_dict(
                    {"passage_id": pids, "passage_content": contents}
                )
            return out

        doc2id = {}
        rows = []
        order = list(range(len(table)))
        random.Random(self.seed).shuffle(order)
        for idx in order:
            item = table[idx]
            pos_ids, pos_contents = [], []
            for phrase in item["descriptions"]:
                pid = doc2id.setdefault(phrase, str(len(doc2id)))
                pos_ids.append(pid)
                pos_contents.append(phrase)
            rows.append({
                "question_id": str(item["img_id"]),
                "img_id": str(item["img_id"]),
                "img_path": item.get("img_path", ""),
                "question": "",  # VG pretraining has no question text
                "pos_item_ids": pos_ids,
                "pos_item_contents": pos_contents,
            })
        cut = int(len(rows) * self.train_valid_ratio)
        splits = {"train": rows[:cut], "valid": rows[cut:]}
        passages = Table.from_dict({
            "passage_id": list(doc2id.values()),
            "passage_content": list(doc2id.keys()),
        })
        out = {}
        cols = ("question_id", "img_id", "img_path", "question",
                "pos_item_ids", "pos_item_contents")
        for split, items in splits.items():
            out[split] = (
                Table.from_dict({k: [r[k] for r in items] for k in items[0]})
                if items
                else Table.from_dict({k: [] for k in cols})
            )
            out[f"{split}_passages"] = passages
        logger.info(
            "[Data Statistics] passages %d, train %d, valid %d",
            len(passages), len(out["train"]), len(out["valid"]),
        )
        return out
