"""WIT corpus transforms (port of the JAX package's ``data/ops/wit_ops.py``
over ``data/table.py`` tables; reference
`src/data_ops/wit_data_ops.py:62-1408`). The JAX package's pandas join and
group-by in :class:`PrepareWITDataForRetrieval` is table code here, and the
TSV shards are read by ``data/table.py::read_csv`` (``Dataset.from_csv``'s
types). :class:`ConvertWITImagePixels` is an offline conversion step that
re-encodes JPEGs: it keeps PIL, imported inside the node."""

from __future__ import annotations

import json
import logging
import os

from ...utils.registries import register_transform_functor
from ..table import Table, concatenate_tables, read_csv
from ..transforms import HFDatasetTransform
from .m2kr_ops import _load_hf, make_dummy_m2kr
from .wikipedia_ops import BM25Index

logger = logging.getLogger(__name__)


@register_transform_functor
class LoadWITData(HFDatasetTransform):
    """Load WIT TSV shards per split (reference `:62-144`): keep English rows
    (optionally main images only), add an md5-of-image-url ``image_id`` and a
    per-split ``original_data_id`` join key."""

    def setup(self, data_path=None, data_paths=None, only_main_image=False, **kwargs):
        self.data_path = data_path
        self.data_paths = data_paths or {}
        self.only_main_image = only_main_image
        return self

    def _call(self, data=None):
        import hashlib

        if self.use_dummy_data or not (self.data_path or self.data_paths):
            return make_dummy_m2kr()
        if self.data_path:
            return _load_hf(self.data_path)

        out = {}
        for split, paths in self.data_paths.items():
            if split == "image_data_path":
                continue
            paths = paths if isinstance(paths, list) else [paths]
            tables = []
            for p in paths:
                ds = read_csv(p, delimiter="\t")
                if self.only_main_image:
                    ds = ds.filter(
                        lambda x: x["language"] == "en" and bool(x["is_main_image"])
                    )
                else:
                    ds = ds.filter(lambda x: x["language"] == "en")
                tables.append(ds)
            split_ds = concatenate_tables(tables)

            def add_image_id(batch):
                batch["image_id"] = [
                    hashlib.md5(u.encode()).hexdigest() for u in batch["image_url"]
                ]
                return batch

            split_ds = split_ds.map(add_image_id, batched=True)
            split_ds = split_ds.add_column(
                "original_data_id", [f"{split}_{i}" for i in range(len(split_ds))]
            )
            out[split] = split_ds
        return out


@register_transform_functor
class TruncateWITPassages(HFDatasetTransform):
    """Split long WIT passages into word-budgeted chunks and re-id them as
    ``WIT_{i}`` (reference `:526-620`; the reference's accumulator is buggy —
    it duplicates text across chunks — this implements the documented intent:
    disjoint chunks of ≤ truncation_length words)."""

    def setup(self, truncation_length: int = 100, **kwargs):
        self.truncation_length = truncation_length
        return self

    def _call(self, data):
        key = "passages" if "passages" in data else next(
            k for k in data.keys() if k.endswith("_passages")
        )
        ds = data[key]
        T = self.truncation_length

        def process(batch):
            other = [k for k in batch.keys() if k != "passage_content"]
            out = {k: [] for k in batch.keys()}
            for i, text in enumerate(batch["passage_content"]):
                words = text.split()
                chunks = (
                    [" ".join(words[s : s + T]) for s in range(0, len(words), T)]
                    if len(words) > T
                    else [text]
                )
                for c in chunks:
                    out["passage_content"].append(c)
                    for k in other:
                        out[k].append(batch[k][i])
            return out

        ds = ds.map(process, batched=True)
        if "passage_id" in ds.column_names:
            ds = ds.remove_columns(["passage_id"])
        ds = ds.add_column("passage_id", [f"WIT_{i}" for i in range(len(ds))])
        data[key] = ds
        logger.info("after truncation: %d passages", len(ds))
        return data


@register_transform_functor
class RemoveWITPassagesWithoutImages(HFDatasetTransform):
    """Filter the corpus to passages listed in ``available_documents``
    (reference `:924-951`)."""

    def setup(self, **kwargs):
        return self

    def _call(self, data):
        available = data.get("available_documents") or {}
        key = "passages" if "passages" in data else next(
            k for k in data.keys() if k.endswith("_passages")
        )
        full = data[key]
        data["full_passages"] = full
        data[key] = full.filter(lambda x: available.get(x["passage_id"]) is not None)
        logger.info("reduced corpus %d → %d", len(full), len(data[key]))
        return data


@register_transform_functor
class PrepareWITDataForRetrieval(HFDatasetTransform):
    """Form (image → passages) retrieval examples from WIT rows (reference
    `:623-822`): join each split with the passage table on
    ``original_data_id``, group by ``image_id`` aggregating the matched
    passage ids/contents into ``pos_item_ids``/``pos_item_contents``, set
    ``question_id = img_id``, and optionally keep only the IGLUE test triples
    in the valid split (``iglue_test_file``)."""

    def setup(self, iglue_test_file=None, **kwargs):
        self.iglue_test_file = iglue_test_file
        return self

    def _call(self, data):
        if "passages" not in data or "original_data_id" not in data[
            next(s for s in data.keys() if not s.endswith("_passages") and s != "passages")
        ].column_names:
            # simplified schema (dummy / pre-paired rows): page description
            # becomes the positive passage
            out = {}
            for split in [s for s in data.keys() if not s.endswith("_passages") and s != "passages"]:
                table = data[split]
                if "pos_item_ids" in table.column_names:
                    out[split] = table
                    continue
                pids = [f"wit_{split}_{i}" for i in range(len(table))]
                contents = [
                    (row.get("passage_content") or row.get("context_page_description")
                     or row.get("caption") or "")
                    for row in table
                ]
                out[split] = table.add_column("pos_item_ids", [[p] for p in pids])
                out[f"{split}_passages"] = Table.from_dict(
                    {"passage_id": pids, "passage_content": contents}
                )
            return out

        # the passages of each original_data_id, in passage order (the
        # JAX package's left join on a pandas index)
        passages = data["passages"]
        by_data_id = {}
        for did, pid, content in zip(passages["original_data_id"], passages["passage_id"],
                                     passages["passage_content"]):
            by_data_id.setdefault(did, []).append((pid, content))
        out = {}
        for split in ("train", "valid", "test"):
            if split not in data:
                continue
            split_ds = data[split]
            if self.iglue_test_file and split == "valid" and not self.use_dummy_data:
                keep = {}
                with open(self.iglue_test_file) as f:
                    for line in f:
                        if line.strip():
                            r = json.loads(line)
                            keep[(r["page_url"], r["image_url"],
                                  r["caption_reference_description"])] = 1
                split_ds = split_ds.filter(
                    lambda x: keep.get(
                        (x["page_url"], x["image_url"],
                         x["caption_reference_description"]), None,
                    ) is not None
                )
                logger.info("IGLUE filter kept %d valid examples", len(split_ds))

            # img_id/img_path come from the image registry built by
            # PrepareImagesForWITData (LoadWITData itself never adds them);
            # fall back to image_id / None
            registry = data.get("images", {}) or {}
            cols = split_ds.column_names
            img_ids = split_ds["img_id" if "img_id" in cols else "image_id"]
            img_paths = (split_ds["img_path"] if "img_path" in cols else
                         [(registry.get(i) or {}).get("img_path") for i in split_ds["image_id"]])
            # left join, then group by image_id (sorted, as pandas groups):
            # the list columns collect every joined row, the others take the
            # first
            groups = {}
            for did, image_id, img_id, img_path in zip(split_ds["original_data_id"],
                                                       split_ds["image_id"], img_ids, img_paths):
                g = groups.setdefault(image_id, {"original_data_id": [], "passage_id": [],
                                                 "passage_content": [], "img_id": img_id,
                                                 "img_path": img_path})
                for pid, content in by_data_id.get(did, [(None, None)]):
                    g["original_data_id"].append(did)
                    g["passage_id"].append(pid)
                    g["passage_content"].append(content)
            keys = sorted(groups)
            rows = [groups[k] for k in keys]
            split_ds = Table.from_dict({
                "original_data_id": [r["original_data_id"] for r in rows],
                "pos_item_ids": [r["passage_id"] for r in rows],
                "pos_item_contents": [r["passage_content"] for r in rows],
                "img_id": [r["img_id"] for r in rows],
                "img_path": [r["img_path"] for r in rows],
                "image_id": keys,
            })
            split_ds = split_ds.add_column("question_id", split_ds["img_id"])
            out[split] = split_ds
        out["passages"] = data["passages"]
        return out


@register_transform_functor
class IndexWITPassagesWithElasticSearch(HFDatasetTransform):
    """Lexical index over WIT passages (reference `:824-900`); BM25-backed
    like the Wikipedia variant."""

    def setup(self, **kwargs):
        return self

    def _call(self, data):
        passages = next(data[k] for k in data.keys() if k.endswith("_passages"))
        return {
            "index": BM25Index(list(passages["passage_content"])),
            "passage_ids": list(passages["passage_id"]),
            "passages": data,
        }


@register_transform_functor
class LoadWITPassages(HFDatasetTransform):
    """Concatenate train+valid WIT rows into a passage corpus: assign
    ``WIT_{i}`` passage ids and render ``passage_content`` from the page /
    section / caption fields in the reference's exact field order
    (reference `:464-524`)."""

    _FIELDS = (
        ("section_title", "section title"),
        ("hierarchical_section_title", "hierarchical section title"),
        ("caption_reference_description", "caption reference description"),
        ("caption_attribution_description", "caption attribution description"),
        ("caption_alt_text_description", "caption alt text description"),
    )

    def setup(self, **kwargs):
        return self

    def _call(self, data):
        parts = [data[s] for s in ("train", "valid") if s in data]
        full = concatenate_tables(parts) if len(parts) > 1 else parts[0]
        full = full.add_column("passage_id",
                               [f"WIT_{i}" for i in range(len(full))])

        def render(item):
            content = f"title: {item.get('page_title')}"
            for col, label in self._FIELDS:
                if item.get(col) is not None:
                    content += f" {label}: {item[col]}"
            content += f" content: {item.get('context_page_description')}"
            item["passage_content"] = content
            return item

        full = full.map(render)
        return {"passages": full}


def _validate_image(path) -> bool:
    """True iff ``path`` exists and its header parses as an image (what
    PIL's ``verify`` checks for a PNG or a JPEG; PIL, imported here, checks
    any other format)."""
    import struct

    from ..image_io import PNG_SIGNATURE, _png_header, _segments

    if not path or not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(PNG_SIGNATURE):
            _png_header(data)
            return True
        if data.startswith(b"\xff\xd8"):
            return any(0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC)
                       for m, _, _ in _segments(data))
    except (ValueError, StopIteration, struct.error):
        return False
    from PIL import Image

    try:
        with Image.open(path) as im:
            im.verify()
        return True
    except Exception:
        return False


@register_transform_functor
class PrepareImagesForWITData(HFDatasetTransform):
    """Build the WIT image registry ``{image_id: {img_id, img_path}}`` and
    filter each split to rows whose image file is present on disk (reference
    `:146-326`; the reference's 128-thread rotating-user-agent downloader is
    an offline concern — here images are expected pre-fetched under
    ``image_data_path``, and rows without a decodable file are dropped the
    same way the reference drops failed downloads)."""

    def setup(self, image_data_path=None, validate: bool = True, **kwargs):
        self.image_data_path = image_data_path
        self.validate = validate
        return self

    def _call(self, data):
        images = {}
        for split in [s for s in data.keys()
                      if s not in ("passages",) and not s.endswith("_passages")]:
            split_ds = data[split]
            if not hasattr(split_ds, "column_names") or \
                    "image_id" not in split_ds.column_names:
                continue
            keep_rows = []
            for i, image_id in enumerate(split_ds["image_id"]):
                path = (split_ds[i].get("img_path")
                        or (os.path.join(self.image_data_path, f"{image_id}.jpg")
                            if self.image_data_path else None))
                ok = (not self.validate) or self.use_dummy_data or _validate_image(path)
                if ok:
                    keep_rows.append(i)
                    images[image_id] = {"img_id": image_id, "img_path": path}
            if len(keep_rows) != len(split_ds):
                data[split] = split_ds.select(keep_rows)
                logger.info("%s: kept %d/%d rows with valid images",
                            split, len(keep_rows), len(split_ds))
        data["images"] = images
        return data


@register_transform_functor
class PrepareImagesForWITDataFromPassages(HFDatasetTransform):
    """Same registry construction, but driven by the *passage* table
    (reference `:328-462`) — used when the passage corpus, not the question
    split, is the source of image ids."""

    def setup(self, image_data_path=None, validate: bool = True, **kwargs):
        self.image_data_path = image_data_path
        self.validate = validate
        return self

    def _call(self, data):
        key = "passages" if "passages" in data else next(
            k for k in data.keys() if k.endswith("_passages"))
        table = data[key]
        images = {}
        for row in table:
            image_id = row.get("image_id")
            if image_id is None:
                continue
            path = (row.get("img_path")
                    or (os.path.join(self.image_data_path, f"{image_id}.jpg")
                        if self.image_data_path else None))
            if (not self.validate) or self.use_dummy_data or _validate_image(path):
                images[image_id] = {"img_id": image_id, "img_path": path}
        logger.info("image registry from passages: %d entries", len(images))
        data["images"] = images
        return data


@register_transform_functor
class PrepareWITPassageAnnotations(HFDatasetTransform):
    """Mine pseudo-relevance labels for WIT questions against the lexical
    passage index (reference `:954-1182`, ES multi-match replaced by the
    in-process BM25): per question, retrieve top-k, keep hits as
    ``pos_item_ids`` (string-containment-checked against answers when answers
    exist), and accumulate every hit into ``available_documents`` for the
    corpus-reduction node."""

    def setup(self, k: int = 10, **kwargs):
        self.k = k
        return self

    def _call(self, inputs):
        data, indexed = inputs if isinstance(inputs, list) else (inputs, None)
        assert indexed is not None, "requires [questions, indexed_passages] inputs"
        index: BM25Index = indexed["index"]
        pids = indexed["passage_ids"]
        contents = index.doc_tokens
        available = {}

        def annotate(example):
            text = example.get("question") or example.get(
                "caption_reference_description") or ""
            hits = index.search(text, self.k)
            for i in hits:
                available[pids[i]] = 1
            answers = [a.lower() for a in example.get("answers", [])]
            if answers:
                pos = [pids[i] for i in hits
                       if any(a in " ".join(contents[i]) for a in answers)]
            else:
                pos = [pids[i] for i in hits[:1]]
            example["pos_item_ids"] = pos or ([pids[hits[0]]] if hits else [])
            return example

        for split in [s for s in data.keys()
                      if s not in ("passages", "images")
                      and not s.endswith("_passages")
                      and hasattr(data[s], "map")]:
            data[split] = data[split].map(annotate)
        for key in indexed["passages"].keys():
            if key.endswith("_passages") or key == "passages":
                data[key] = indexed["passages"][key]
        data["available_documents"] = available
        return data


@register_transform_functor
class ReduceWITPassagesSize(HFDatasetTransform):
    """Filter the corpus to ``available_documents`` while keeping the full
    table aside (reference `:1184-1271`)."""

    def setup(self, **kwargs):
        return self

    def _call(self, data):
        available = data.get("available_documents") or {}
        for key in [k for k in data.keys()
                    if k == "passages" or k.endswith("_passages")]:
            if key == "full_passages":
                continue
            full = data[key]
            data["full_passages"] = full
            data[key] = full.filter(lambda x: available.get(x["passage_id"]) is not None)
            logger.info("reducing #docs (%s) %d → %d", key, len(full),
                        len(data[key]))
        return data


@register_transform_functor
class ReduceWITImagesSize(HFDatasetTransform):
    """Shrink the image registry to images referenced by the (reduced)
    passage table; emit ``imgId2path`` (reference `:1273-1312`)."""

    def setup(self, **kwargs):
        return self

    def _call(self, data):
        key = "passages" if "passages" in data else next(
            k for k in data.keys() if k.endswith("_passages"))
        table = data[key]
        images = data.get("images") or {}
        col = "image_id" if "image_id" in table.column_names else None
        available = {k: 1 for k in table[col]} if col else {}
        new_images, img_id2path = {}, {}
        for k, v in images.items():
            if available.get(v["img_id"]) is not None:
                new_images[k] = v
                img_id2path[v["img_id"]] = v["img_path"]
        logger.info("reducing #images %d → %d", len(images), len(new_images))
        return {"images": new_images, "imgId2path": img_id2path}


@register_transform_functor
class ConcatenateImageCorpus(HFDatasetTransform):
    """Merge image registries (and precomputed image-embedding datasets) from
    several corpus pipelines (reference `:1314-1354`)."""

    def setup(self, **kwargs):
        return self

    def _call(self, inputs):
        inputs = inputs if isinstance(inputs, list) else [inputs]
        full_images = {}
        embedding_tables = []
        for part in inputs:
            if "images" in part:
                full_images.update(part["images"])
            if "image_dataset_with_embeddings" in part:
                embedding_tables.append(part["image_dataset_with_embeddings"])
        out = {"images": full_images}
        if embedding_tables:
            out["image_dataset_with_embeddings"] = (
                concatenate_tables(embedding_tables)
                if len(embedding_tables) > 1 else embedding_tables[0]
            )
        return out


@register_transform_functor
class SplitWITPassagesForLargeScaleTraining(HFDatasetTransform):
    """Split the full passage corpus for large-scale training (reference
    `:1356-1408`): training keeps the FULL corpus; the validation/test corpus
    is reduced to exactly the passages referenced by valid+test
    ``pos_item_ids`` (so eval-time indexing stays cheap at scale)."""

    def setup(self, **kwargs):
        return self

    def _call(self, data):
        full = data.get("passages") or data.get("train_passages")
        valid_ids = []
        for split in ("valid", "test"):
            if split in data and "pos_item_ids" in data[split].column_names:
                for ids in data[split]["pos_item_ids"]:
                    valid_ids.extend(ids)
        keep = {k: 1 for k in valid_ids}
        reduced = full.filter(lambda x: keep.get(x["passage_id"]) is not None)
        logger.info(
            "passages associated with validation/test samples: %d of %d",
            len(reduced), len(full),
        )
        out = {k: v for k, v in data.items() if not k.endswith("_passages") and k != "passages"}
        out["train_passages"] = full
        out["valid_passages"] = reduced
        out["test_passages"] = reduced
        return out


@register_transform_functor
class ConvertWITImagePixels(HFDatasetTransform):
    """Decode WIT ``image_pixels`` TSV shards (``image_url``, base64 bytes,
    ``metadata_url``) into on-disk ``{md5(image_url)}.jpg`` files — the id
    convention `LoadWITData` joins against (reference
    `src/tools/convert_wit_data.py:13-64`; there the final ``save`` call is
    commented out — this implements the documented intent). Rows that fail
    to decode, or are under ``min_side`` pixels on either side, are skipped
    and counted. Returns a manifest table of saved ``image_id``s so the
    node composes in a DataPipeline DAG. The decode and re-encode go
    through PIL, imported inside the node: an offline conversion step, the
    one node of the port that needs PIL."""

    def setup(self, pixels_dir=None, images_dir=None, min_side: int = 10,
              **kwargs):
        self.pixels_dir = pixels_dir
        self.images_dir = images_dir
        self.min_side = min_side
        return self

    def _call(self, data=None):
        import base64
        import csv
        import hashlib
        import io
        import sys

        from PIL import Image

        # real WIT image_pixels shards carry base64 payloads far above csv's
        # default 128 KB field cap (any raw image over ~98 KB); without this
        # the reader raises _csv.Error outside the per-row skip path
        csv.field_size_limit(sys.maxsize)
        os.makedirs(self.images_dir, exist_ok=True)
        saved, skipped = [], 0
        shards = sorted(
            f for f in os.listdir(self.pixels_dir)
            if f.endswith((".csv", ".tsv"))
        )
        for shard in shards:
            with open(os.path.join(self.pixels_dir, shard), newline="") as f:
                # reference reads headerless TSV with fixed column order
                for row in csv.reader(f, delimiter="\t"):
                    if len(row) < 2:
                        skipped += 1
                        continue
                    image_url, b64_bytes = row[0], row[1]
                    try:
                        img = Image.open(
                            io.BytesIO(base64.b64decode(b64_bytes))
                        ).convert("RGB")
                    except Exception:
                        logger.warning("error decoding image %s", image_url)
                        skipped += 1
                        continue
                    if min(img.size) < self.min_side:
                        logger.warning(
                            "image too small %s %s", image_url, img.size)
                        skipped += 1
                        continue
                    image_id = hashlib.md5(image_url.encode()).hexdigest()
                    img.save(os.path.join(self.images_dir,
                                          f"{image_id}.jpg"))
                    saved.append(image_id)
        logger.info("converted %d WIT images (%d skipped)",
                    len(saved), skipped)
        return Table.from_dict({"image_id": saved})
