"""M2KR benchmark loading/merging — the data path every FLMR/Rerank config
uses (reference `src/data_ops/merge_data_ops.py:200-683`;
`configs/data/okvqa_data.libsonnet:8-27`), over ``data/table.py`` tables.

:func:`_load_hf` reads a real M2KR split saved with ``datasets``'
``save_to_disk`` through ``data/arrow_io.py``, without ``datasets``. Hub ids
(and the parquet snapshots ``load_dataset`` reads) need the network or
``pyarrow`` and raise. The dummy data and every transform run as in the JAX
package."""

from __future__ import annotations

import logging
import os
import random

from ...utils.registries import register_transform_functor
from ..image_io import write_png
from ..table import Table, concatenate_tables
from ..transforms import HFDatasetTransform

logger = logging.getLogger(__name__)


def _load_hf(path: str):
    """Load a ``save_to_disk`` directory (a split dict of tables, or one
    table), as the JAX package's ``_load_hf`` does with
    ``datasets.load_from_disk``. Its ``hub-path///subfolder`` convention
    (the reference's, `:243-260`) is kept exactly: for a local directory
    ``path///sub`` it loads ``path`` and ignores ``sub``. Anything else (a
    hub id) raises ``NotImplementedError`` naming the path."""
    from ..arrow_io import is_saved_dataset, load_from_disk

    if "///" in path:
        path = path.split("///", 1)[0]
    if is_saved_dataset(path):
        return load_from_disk(path)
    raise NotImplementedError(
        f"{path!r} is not a save_to_disk directory: hub ids and parquet snapshots need "
        "the network or pyarrow, which the port does without; save the dataset with "
        "datasets' save_to_disk and point the config at that directory")


def make_dummy_m2kr(num_rows=16, num_passages=32, with_images=False, image_dir=None):
    """Synthesize a tiny M2KR-shaped DatasetDict for offline/dummy runs
    (the reference's dummy-data mode role, `src/main.py:85-90`)."""
    answers = ["paris", "rome", "berlin", "london"]
    passage_rows = {
        "passage_id": [f"p{i}" for i in range(num_passages)],
        "passage_content": [
            f"passage {i} about {answers[i % len(answers)]} the capital city"
            for i in range(num_passages)
        ],
        # M2KR passages carry their originating dataset (used by
        # validation_indexing_source and use_self_negatives)
        "source_name": [
            ["okvqa", "wit"][i % 2] for i in range(num_passages)
        ],
    }
    img_paths = [""] * num_rows
    if with_images and image_dir:
        import numpy as np

        os.makedirs(image_dir, exist_ok=True)
        img_paths = []
        rng = np.random.default_rng(0)
        for i in range(num_rows):
            p = os.path.join(image_dir, f"img_{i}.png")
            if not os.path.exists(p):
                write_png(p, rng.integers(0, 255, size=(64, 64, 3), dtype=np.uint8))
            img_paths.append(p)
    rows = {
        "question_id": [f"q{i}" for i in range(num_rows)],
        "question": [
            f"what is the capital related to item {i}" for i in range(num_rows)
        ],
        "instruction": ["Answer the following question with the image:"] * num_rows,
        "img_path": img_paths,
        "answers": [[answers[i % len(answers)]] for i in range(num_rows)],
        "gold_answer": [answers[i % len(answers)] for i in range(num_rows)],
        "pos_item_ids": [[f"p{i % num_passages}"] for i in range(num_rows)],
        # each question's originating dataset matches its positive passage's
        # source (p{i} has source ['okvqa','wit'][i % 2])
        "source_name": [["okvqa", "wit"][i % 2] for i in range(num_rows)],
    }
    split = Table.from_dict(rows)
    passages = Table.from_dict(passage_rows)
    return {
        "train": split,
        "valid": split,
        "test": split,
        "train_passages": passages,
        "valid_passages": passages,
        "test_passages": passages,
    }


@register_transform_functor
class LoadPreprocessedData(HFDatasetTransform):
    """Load an M2KR dataset + its passage collection (reference
    ``LoadPreprocessedData_v2``, `merge_data_ops.py:200-366`): subfolder
    convention, split shuffling, per-split row selection, instruction
    sampling + combination with the question, image-root remapping, and
    ``{split}_passages`` attachment."""

    def setup(
        self,
        data_path=None,
        passage_path=None,
        image_root_folder=None,
        add_instruction=None,
        shuffle_splits=None,
        load_instruction=True,
        num_data=None,
        num_passages=None,
        **kwargs,
    ):
        self.data_path = data_path
        self.passage_path = passage_path
        self.image_root_folder = image_root_folder
        self.add_instruction = add_instruction
        self.shuffle_splits = shuffle_splits
        self.load_instruction = load_instruction
        self.num_data = num_data
        self.num_passages = num_passages
        return self

    def _call(self, data=None):
        if self.use_dummy_data or not self.data_path:
            import tempfile

            res = make_dummy_m2kr(
                with_images=True,
                # not the JAX package's directory: its PIL writes are not
                # atomic, and another process of that package may be writing
                image_dir=os.path.join(tempfile.gettempdir(), "rmr_dummy_images_torch"),
            )
        else:
            res = _load_hf(self.data_path)
            passages = _load_hf(self.passage_path)
            res = dict(res)
            for split in list(res.keys()):
                if f"{split}_passages" in passages:
                    sp = passages[f"{split}_passages"]
                    if self.num_passages:
                        sp = sp.select(range(min(self.num_passages, len(sp))))
                    res[f"{split}_passages"] = sp

        all_splits = [s for s in res.keys() if not s.endswith("_passages")]

        for split in self.shuffle_splits or []:
            res[split] = res[split].shuffle(seed=42)

        if self.num_data:
            for split, n in self.num_data.items():
                if n != -1 and split in res:
                    res[split] = res[split].select(range(min(n, len(res[split]))))

        if self.add_instruction:
            sampler = random.Random(42)

            def add_instr(example):
                example["instruction"] = sampler.choice(self.add_instruction)
                return example

            for split in all_splits:
                res[split] = res[split].map(add_instr, load_from_cache_file=False)

        if self.load_instruction:
            def combine(example):
                # instruction-prefixed question (reference `:295-315`)
                i = (example.get("instruction") or "").strip()
                q = example.get("question") or ""
                if i.endswith("."):
                    i = i[:-1]
                if not i:
                    # no instruction: leave the question untouched rather
                    # than prefixing a stray ": "
                    example["question"] = q.strip()
                else:
                    example["question"] = (
                        f"{i} {q}".strip() if i.endswith(":")
                        else f"{i}: {q}".strip()
                    )
                return example

            for split in all_splits:
                if "instruction" in res[split].column_names:
                    res[split] = res[split].map(combine, load_from_cache_file=False)

        if self.image_root_folder:
            def remap(example):
                example["img_path"] = os.path.join(
                    self.image_root_folder, example["img_path"]
                )
                return example

            for split in all_splits:
                if "img_path" in res[split].column_names:
                    res[split] = res[split].map(remap, load_from_cache_file=False)

        return res


@register_transform_functor
class ConcatenatePassageDatasets(HFDatasetTransform):
    """Merge multiple passage collections, deduplicating by passage_id
    (reference `merge_data_ops.py:370-435`)."""

    def setup(self, names=None, concat_splits=None, **kwargs):
        self.names = names
        self.concat_splits = concat_splits or {}
        return self

    def _call(self, inputs):
        if not isinstance(inputs, list):
            inputs = [inputs]
        out = {}
        for split, use in self.concat_splits.items():
            tables = []
            for take, src in zip(use, inputs):
                if take is False or split not in src:
                    continue
                t = src[split]
                if isinstance(take, int) and take > 0:
                    t = t.select(range(min(take, len(t))))
                tables.append(t)
            if tables:
                merged = concatenate_tables(tables)
                seen, keep = set(), []
                for i, pid in enumerate(merged["passage_id"]):
                    if pid not in seen:
                        seen.add(pid)
                        keep.append(i)
                out[split] = merged.select(keep)
        return out


@register_transform_functor
class ConcatenateDatasets(HFDatasetTransform):
    """Merge question datasets split-wise (reference `merge_data_ops.py:437-508`)."""

    def setup(self, concat_splits=None, negative_names=None, **kwargs):
        self.concat_splits = concat_splits or {}
        return self

    def _call(self, inputs):
        if not isinstance(inputs, list):
            inputs = [inputs]
        out = {}
        for split, use in self.concat_splits.items():
            tables = []
            for take, src in zip(use, inputs):
                if take is False or split not in src:
                    continue
                t = src[split]
                if isinstance(take, int) and take > 0:
                    t = t.select(range(min(take, len(t))))
                tables.append(t)
            if tables:
                cols = set.intersection(*(set(t.column_names) for t in tables))
                tables = [t.select_columns(sorted(cols)) for t in tables]
                out[split] = concatenate_tables(tables)
        return out


@register_transform_functor
class AddTextBasedVision(HFDatasetTransform):
    """Verbalize vision fields into the question text
    (reference `merge_data_ops.py:510-597`)."""

    def setup(self, caption_config=None, object_config=None, **kwargs):
        self.caption_config = caption_config or {}
        self.object_config = object_config or {}
        return self

    def _call(self, data):
        def add(example):
            parts = [example.get("question", "")]
            if self.caption_config and example.get("caption"):
                s = self.caption_config.get("separation_tokens", {})
                parts.append(f"{s.get('start','')} {example['caption']} {s.get('end','')}".strip())
            if self.object_config and example.get("objects"):
                s = self.object_config.get("separation_tokens", {})
                names = " ".join(
                    o.get("class", str(o)) if isinstance(o, dict) else str(o)
                    for o in example["objects"]
                )
                parts.append(f"{s.get('start','')} {names} {s.get('end','')}".strip())
            example["question"] = " ".join(p for p in parts if p)
            return example

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            data[split] = data[split].map(add, load_from_cache_file=False)
        return data


@register_transform_functor
class AddInstruction(HFDatasetTransform):
    """Attach a (sampled) instruction column (reference `merge_data_ops.py:599-683`)."""

    def setup(self, instructions=None, **kwargs):
        self.instructions = instructions or []
        return self

    def _call(self, data):
        sampler = random.Random(42)

        def add(example):
            example["instruction"] = sampler.choice(self.instructions)
            return example

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            data[split] = data[split].map(add, load_from_cache_file=False)
        return data


@register_transform_functor
class ShuffleData(HFDatasetTransform):
    """Reference `infoseek_data_ops.py:1181-1205`."""

    def setup(self, shuffle_splits=None, seed=42, **kwargs):
        self.shuffle_splits = shuffle_splits or []
        self.seed = seed
        return self

    def _call(self, data):
        for split in self.shuffle_splits:
            if split in data:
                data[split] = data[split].shuffle(seed=self.seed)
        return data


@register_transform_functor
class MergeDataColumns(HFDatasetTransform):
    """Merge columns from a second dataset by question_id
    (reference `infoseek_data_ops.py:1135-1179`)."""

    def setup(self, merge_on="question_id", columns=None, **kwargs):
        self.merge_on = merge_on
        self.columns = columns or []
        return self

    def _call(self, inputs):
        base, extra = inputs
        for split in [s for s in base.keys() if not s.endswith("_passages")]:
            if split not in extra:
                continue
            lookup = {
                row[self.merge_on]: {c: row[c] for c in self.columns}
                for row in extra[split]
            }

            def merge(example):
                example.update(lookup.get(example[self.merge_on], {}))
                return example

            base[split] = base[split].map(merge, load_from_cache_file=False)
        return base
