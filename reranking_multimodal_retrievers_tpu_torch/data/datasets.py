"""Dataset wrappers: per-sample assembly + batch collation.

Parity with the reference dataset layer
(`src/data_ops/custom_datasets/base_datasets.py:30-224`,
`dpr_datasets.py:103-257`, `okvqa_datasets.py:107-305`): map-style datasets
over HF tables whose ``collate_fn`` drives the ModuleParser over
``input_modules``/``decoder_input_modules``/``output_modules``; the DPR
variants rejection-sample negatives from the passage corpus per item and
expose question ids / positive ids / negative ids alongside the tensors.

Collate returns fixed-shape NumPy arrays; the executors move them to their
device.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List

import numpy as np

from .module_parser import ModuleParser


class BaseDataset(ModuleParser):
    """Reference `base_datasets.py:30-126`."""

    def __init__(
        self,
        config,
        dataset,
        modules_config,
        tokenizer=None,
        decoder_tokenizer=None,
        image_processor=None,
        mode: str = "train",
    ):
        self.config = config
        self.dataset = dataset
        self.modules_config = modules_config  # {input_modules, decoder_input_modules, output_modules, postprocess_*}
        self.tokenizer = tokenizer
        self.decoder_tokenizer = decoder_tokenizer
        self.image_processor = image_processor
        self.mode = mode

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx) -> Dict[str, Any]:
        return dict(self.dataset[int(idx)])

    # ----------------------------------------------------------- collation
    def _run_postprocess(self, parsed_batch, module_names, batch):
        for pp in module_names:
            name = pp["type"] if isinstance(pp, dict) else pp
            fn = getattr(self, name)
            out = fn(parsed_batch, pp if isinstance(pp, dict) else {})
            batch.update(out)
        return batch

    def collate_fn(self, samples: List[Dict]) -> Dict[str, Any]:
        mc = self.modules_config
        batch: Dict[str, Any] = {}

        parsed = [self.parse_modules(s, mc.get("input_modules", [])) for s in samples]
        # the flattened image list pairs positionally with questions inside
        # PostProcessVisionInputProcessing — a sample contributing a
        # different image count (missing img_path, inconsistent ROI crops)
        # would silently misalign every later row; fail loudly here instead
        img_counts = {len(p["images"]) for p in parsed}
        if len(img_counts) > 1:
            raise ValueError(
                "collate_fn: samples yield differing image counts "
                f"{sorted(img_counts)} — pixel_values rows would misalign "
                "with questions (check img_path presence / ROI settings "
                "across the batch)"
            )
        input_data = {
            "text_sequences": [p["text_sequence"] for p in parsed],
            "images": sum((p["images"] for p in parsed), []),
        }
        feats = [p["image_features"] for p in parsed if p["image_features"] is not None]
        if feats:
            batch["image_features"] = np.stack(feats)
            # expose to the postprocess dict too, so the *FromEmbeddings
            # postprocessors can fire
            input_data["image_features"] = feats
        self._run_postprocess(input_data, mc.get("postprocess_module_list", []), batch)

        if mc.get("decoder_input_modules"):
            dparsed = [
                self.parse_modules(s, mc["decoder_input_modules"]) for s in samples
            ]
            ddata = {
                "text_sequences": _flatten_text(dparsed),
                # passage-side vision inputs (PassageVisionInput) feed the
                # decoder postprocessors (Blip2Vision / ItemVisionFrom
                # Embeddings); without these keys they silently no-op
                "images": sum((p["images"] for p in dparsed), []),
            }
            dfeats = [p["image_features"] for p in dparsed
                      if p["image_features"] is not None]
            if dfeats:
                ddata["image_features"] = dfeats
            dec = self._run_postprocess(
                ddata, mc.get("postprocess_decoder_input_module_list", []), {}
            )
            batch.update(_prefix_decoder(dec))

        if mc.get("output_modules"):
            oparsed = [self.parse_modules(s, mc["output_modules"]) for s in samples]
            odata = {"text_sequences": [p["text_sequence"] for p in oparsed]}
            self._run_postprocess(
                odata, mc.get("postprocess_output_module_list", []), batch
            )

        batch["questions"] = [s.get("question", "") for s in samples]
        batch["question_ids"] = [s.get("question_id") for s in samples]
        if any("answers" in s for s in samples):
            batch["answers"] = [s.get("answers", []) for s in samples]
            batch["gold_answer"] = [s.get("gold_answer", "") for s in samples]
        if any("source_name" in s for s in samples):
            # multi-source M2KR: feeds validation_indexing_source routing
            batch["source_name"] = [s.get("source_name", "") for s in samples]
        if any("wikidata_ranges" in s for s in samples):
            # Infoseek numeric-answer ranges — feed
            # compute_exact_match_with_numeric_values
            batch["wikidata_ranges"] = [
                s.get("wikidata_ranges") for s in samples
            ]
        return batch


def _prefix_decoder(dec: Dict[str, Any]) -> Dict[str, Any]:
    """Context/decoder tensors get ``decoder_`` names so they never collide
    with the query tensors (reference executors read ``batch.input_ids`` for
    the query and ``batch.decoder_input_ids`` for contexts,
    `FLMR_base_executor.py:407-440`)."""
    return {
        (k if k.startswith("decoder_") or k == "labels" else f"decoder_{k}"): v
        for k, v in dec.items()
    }


def _flatten_text(parsed):
    out = []
    for p in parsed:
        if p.get("text_sequences") is not None:
            out.extend(p["text_sequences"])
        else:
            out.append(p["text_sequence"])
    return out


class CommonDatasetForDPR(BaseDataset):
    """Adds contrastive passage sampling (reference `dpr_datasets.py:103-205`):
    per item, 1 positive from ``pos_item_ids`` plus ``num_negative_samples``
    rejection-sampled negatives from the corpus."""

    def __init__(self, *args, passages=None, num_negative_samples: int = 1,
                 seed: int = 42, use_self_negatives: bool = False,
                 id2source=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.passages = passages  # {"id2doc": {id: content}}
        self.num_negative_samples = num_negative_samples
        self.rng = random.Random(seed)
        self._all_ids = list(passages["id2doc"].keys()) if passages else []
        # 'use_self_negatives' module flag (reference `dpr_datasets.py:
        # 128-139`): restrict rejection sampling to negatives from the same
        # source dataset as the query (multi-source M2KR training);
        # PrepareDataloaders wires it from model_config.modules
        self.use_self_negatives = use_self_negatives
        self.id2source = id2source or (passages or {}).get("id2source", {})

    def __getitem__(self, idx):
        sample = dict(self.dataset[int(idx)])
        pos_ids = list(sample.get("pos_item_ids", []))
        pos_id = self.rng.choice(pos_ids) if pos_ids else self._all_ids[0]
        pos_set = set(pos_ids)
        negative_source = (
            sample.get("source_name") if self.use_self_negatives else None
        )
        # row-level hard-negative pool (DPR-style mined negatives — the
        # reference's OKVQA DPR rows carry the same idea as retrieved
        # non-gold passages, `dpr_datasets.py:140-168`): when the row names
        # candidate negative ids, sample from THEM instead of the corpus,
        # falling back to corpus draws if the pool can't fill the quota
        hard_pool = [
            n for n in (sample.get("neg_item_ids") or [])
            if n not in pos_set and n in self.passages["id2doc"]
        ] if self.passages else []
        negs = []
        rejections = 0
        while len(negs) < self.num_negative_samples:
            if hard_pool:
                cand = hard_pool.pop(
                    self.rng.randrange(len(hard_pool)))
                negs.append(cand)
                continue
            cand = self.rng.choice(self._all_ids)
            if cand in pos_set:
                continue
            # count only source-mismatch REJECTIONS toward the escape hatch
            # (a sparse source must not starve sampling, but successful
            # draws must not burn the budget for large N)
            if (negative_source is not None and rejections < 64
                    and self.id2source.get(cand, negative_source)
                    != negative_source):
                rejections += 1
                continue
            negs.append(cand)
        id2doc = self.passages["id2doc"]
        sample["pos_item_id"] = pos_id
        sample["neg_item_ids"] = negs
        sample["passage_contents"] = [id2doc[pos_id]] + [id2doc[n] for n in negs]
        return sample

    def collate_fn(self, samples):
        batch = super().collate_fn(samples)
        mc = self.modules_config
        all_contents = sum((s["passage_contents"] for s in samples), [])
        ddata = {"text_sequences": all_contents}
        dec = self._run_postprocess(
            ddata, mc.get("postprocess_decoder_input_module_list", []), {}
        )
        batch.update(_prefix_decoder(dec))
        batch["pos_item_ids"] = [[s["pos_item_id"]] for s in samples]
        batch["neg_item_ids"] = [s["neg_item_ids"] for s in samples]
        batch["passage_contents"] = all_contents
        return batch


# thin per-dataset aliases (reference `dpr_datasets.py:208-257`): field naming
# is already normalized by the M2KR loaders, so these are name-compatible
# registry entries.
class OKVQADatasetForDPR(CommonDatasetForDPR):
    pass


class WITDatasetForDPR(CommonDatasetForDPR):
    pass


class EVQADatasetForDPR(CommonDatasetForDPR):
    pass


class InfoseekDatasetForDPR(CommonDatasetForDPR):
    pass


class MSMARCODatasetForDPR(CommonDatasetForDPR):
    pass


class CommonDatasetForDistillation(BaseDataset):
    """Reference `distillation_datasets.py:39-122`: items carry teacher
    scores for the listed documents."""

    def __getitem__(self, idx):
        sample = dict(self.dataset[int(idx)])
        sample.setdefault("teacher_scores", sample.get("scores", []))
        return sample

    def collate_fn(self, samples):
        batch = super().collate_fn(samples)
        batch["teacher_scores"] = [s.get("teacher_scores", []) for s in samples]
        return batch
