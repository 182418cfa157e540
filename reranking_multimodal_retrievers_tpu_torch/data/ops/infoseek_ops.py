"""InfoSeek transforms + BLIP2-captioning node (port of the JAX package's
``data/ops/infoseek_ops.py``; reference
`src/data_ops/infoseek_data_ops.py:66-1205`)."""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ...device import platform_device
from ...utils.registries import register_transform_functor
from ..transforms import HFDatasetTransform
from .m2kr_ops import _load_hf, make_dummy_m2kr

logger = logging.getLogger(__name__)


@register_transform_functor
class LoadInfoSeekData(HFDatasetTransform):
    """Reference `:66-370`."""

    def setup(self, data_path=None, **kwargs):
        self.data_path = data_path
        return self

    def _call(self, data=None):
        if self.use_dummy_data or not self.data_path:
            return make_dummy_m2kr()
        return _load_hf(self.data_path)


@register_transform_functor
class PrepareWikipediaPassageAnnotationsForInfoSeek(HFDatasetTransform):
    """Map InfoSeek wikidata entities to passage positives
    (reference `:372-671`): the entity's wikipedia page passages become
    pos_item_ids."""

    def setup(self, **kwargs):
        return self

    def _call(self, inputs):
        data, indexed = inputs if isinstance(inputs, list) else (inputs, None)
        if indexed is None:
            return data
        index = indexed["index"]
        pids = indexed["passage_ids"]

        def annotate(example):
            key = example.get("entity_text") or example.get("question", "")
            hits = index.search(key, 5)
            example["pos_item_ids"] = [pids[i] for i in hits[:1]] if hits else []
            return example

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            data[split] = data[split].map(annotate)
        for key in indexed["passages"].keys():
            if key.endswith("_passages"):
                data[key] = indexed["passages"][key]
        return data


def blip2_greedy_captions(model, tokenizer, images, prompt: str = "",
                          max_new_tokens: int = 20, image_size: int = 224):
    """Greedy BLIP-2 captioning (the role of HF ``model.generate`` in the
    reference captioner, `infoseek_data_ops.py:730-748`), as the JAX
    package's ``blip2_greedy_captions`` runs it: the encoder once, then at
    each step the decoder over the whole fixed ``max_new_tokens + 1`` token
    buffer (no cache), the step's argmax appended; a finished row emits EOS.
    ``images``: RGB arrays; runs on the model's device."""
    from ..image_io import CLIPImageProcessor

    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    pix = torch.as_tensor(CLIPImageProcessor(image_size)(images), device=dev).to(dtype)
    B = pix.shape[0]
    tok_eos = getattr(tokenizer, "eos_token_id", None)
    # eos id 0 is legitimate and must not fall through to the default
    eos_id = tok_eos if tok_eos is not None else 1
    if prompt:
        enc_in = tokenizer([prompt] * B, padding="max_length", truncation=True,
                           max_length=16, return_tensors="np")
        ids = torch.as_tensor(enc_in["input_ids"], device=dev).long()
        am = torch.as_tensor(enc_in["attention_mask"], device=dev).long()
    else:  # T5 empty input: a single EOS token
        ids = torch.full((B, 1), eos_id, dtype=torch.long, device=dev)
        am = torch.ones((B, 1), dtype=torch.long, device=dev)
    start = model.config.text_config.decoder_start_token_id
    tokens = np.full((B, max_new_tokens + 1), start, np.int64)
    done = np.zeros((B,), bool)
    with torch.no_grad():
        enc_states, enc_mask = model.encode_for_generation(ids, am, pix)
        for t in range(max_new_tokens):
            logits = model.decode_logits(torch.as_tensor(tokens, device=dev), enc_states,
                                         enc_mask)[:, t]
            nxt = logits.argmax(dim=-1).cpu().numpy()
            nxt = np.where(done, eos_id, nxt)
            done |= nxt == eos_id
            tokens[:, t + 1] = nxt
            if done.all():
                break
    return [tokenizer.decode([t for t in row[1:] if t != eos_id], skip_special_tokens=True)
            for row in tokens]


def build_captioner(blip2_config, checkpoint_dir=None):
    """BLIP-2 from a config dict on the device ``platform_device`` gives, in
    fp32, with the weights of an HF-named checkpoint directory (drawn from a
    ``torch.Generator`` seeded 0 first, and overwritten)."""
    from ...models.blip2 import (Blip2Config, Blip2ForConditionalGeneration,
                                 Blip2QFormerConfig, Blip2VisionConfig)
    from ...models.checkpoint_dir import load_checkpoint_dir, load_into
    from ...models.t5 import T5Config

    bc = dict(blip2_config or {})
    cfg = Blip2Config(
        vision_config=Blip2VisionConfig(**bc.get("vision_config", {})),
        qformer_config=Blip2QFormerConfig(**bc.get("qformer_config", {})),
        text_config=T5Config(**bc.get("text_config", {})),
        num_query_tokens=bc.get("num_query_tokens", 32),
    )
    dev = platform_device()
    model = Blip2ForConditionalGeneration(cfg, device=dev,
                                          generator=torch.Generator(device=dev).manual_seed(0))
    if checkpoint_dir:
        load_into(model, load_checkpoint_dir(checkpoint_dir))
    return model.eval()


def load_caption_tokenizer(path):
    """The captioner's tokenizer: a WordPiece vocabulary directory
    (``vocab.txt``), where the JAX package calls ``AutoTokenizer``. A
    SentencePiece directory (Flan-T5's own ``spiece.model``) is not read."""
    from ...models.tokenization import WordPieceTokenizer

    if path and os.path.exists(os.path.join(path, "vocab.txt")):
        return WordPieceTokenizer.from_pretrained(path)
    raise NotImplementedError(
        f"tokenizer {path!r}: the port reads WordPiece vocabularies (vocab.txt); "
        "SentencePiece tokenizers are not ported")


@register_transform_functor
class CaptionImageWithBLIP2(HFDatasetTransform):
    """Caption images with BLIP-2 (reference `:673-1133`, three versions —
    per-image caption files are reused as a cache exactly like the
    reference's ``_caption_with_blip``). With a checkpoint the port's
    BLIP-2 greedy-decodes captions on the device (with
    ``use_pallas_attention`` in ``text_config`` its T5 encoder runs K2's
    fp32 head-bias kernel on the card); in dummy mode it attaches
    deterministic placeholders so downstream text-based vision nodes are
    exercisable offline."""

    def setup(self, captioner_checkpoint=None, tokenizer_name=None,
              blip2_config=None, prompt: str = "", max_caption_length: int = 20,
              caption_cache_dir=None, batch_size: int = 8, **kwargs):
        self.captioner_checkpoint = captioner_checkpoint
        self.tokenizer_name = tokenizer_name
        self.blip2_config = blip2_config or {}
        self.prompt = prompt
        self.max_caption_length = max_caption_length
        self.caption_cache_dir = caption_cache_dir
        self.batch_size = batch_size
        return self

    def _call(self, data):
        if self.captioner_checkpoint and not self.use_dummy_data:
            return self._caption_real(data)

        def caption(example, idx):
            example["caption"] = f"an image related to question {idx}"
            return example

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            data[split] = data[split].map(caption, with_indices=True)
        return data

    def _caption_real(self, data):
        from ..image_io import read_image

        model = build_captioner(self.blip2_config, self.captioner_checkpoint)
        tokenizer = load_caption_tokenizer(self.tokenizer_name)
        size = model.config.vision_config.image_size
        cache = self.caption_cache_dir
        if cache:
            os.makedirs(cache, exist_ok=True)

        def caption_batch(batch):
            paths = batch["img_path"]
            cache_files = [
                os.path.join(cache, os.path.basename(p) + ".caption") if cache else None
                for p in paths
            ]
            if cache and all(cf and os.path.exists(cf) for cf in cache_files):
                captions = []
                for cf in cache_files:
                    with open(cf) as f:
                        captions.append(f.read())
                batch["caption"] = captions
                return batch
            images = [read_image(p) if p and os.path.exists(p)
                      else np.zeros((size, size, 3), np.uint8) for p in paths]
            caps = blip2_greedy_captions(model, tokenizer, images, prompt=self.prompt,
                                         max_new_tokens=self.max_caption_length,
                                         image_size=size)
            if cache:
                for cf, c in zip(cache_files, caps):
                    if cf:
                        with open(cf, "w") as f:
                            f.write(c)
            batch["caption"] = caps
            return batch

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            if "img_path" in data[split].column_names:
                data[split] = data[split].map(caption_batch, batched=True,
                                              batch_size=self.batch_size)
        return data


@register_transform_functor
class CaptionImageWithBLIP2v2(CaptionImageWithBLIP2):
    """v1 + a shared caption index (reference `:766-937` writes every caption
    into an ES ``image_captions`` index so other pipelines can look them up):
    captions are published to the :class:`FeatureStore` keyed by ``image_id``
    as they are produced."""

    def setup(self, caption_store_dir="./embedding_cache",
              index_name="image_captions", **kwargs):
        from ..feature_store import FeatureStore

        self.store = FeatureStore(caption_store_dir, index_name=index_name)
        return super().setup(**kwargs)

    def _call(self, data):
        data = super()._call(data)
        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            cols = data[split].column_names
            if "caption" not in cols:
                continue
            key_col = "image_id" if "image_id" in cols else "question_id"
            for key, cap in zip(data[split][key_col], data[split]["caption"]):
                self.store.put(str(key), cap)
        return data


@register_transform_functor
class CaptionImageWithBLIP2v3(CaptionImageWithBLIP2v2):
    """Resumable captioning (reference `:939-1133`: checks the ES index and
    only captions images not yet present, so a preempted multi-process pass
    continues where it stopped): rows whose ``image_id`` already has a stored
    caption are restored from the store and never re-decoded."""

    def _call(self, data):
        store = self.store
        restored = {"n": 0}

        def restore(example):
            cols_key = "image_id" if "image_id" in example else "question_id"
            cached = store.get(str(example[cols_key]))
            if cached is not None:
                example["caption"] = cached
                restored["n"] += 1
            return example

        # pre-fill from the store, then caption only the rows still missing
        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            data[split] = data[split].map(restore)

        def needs_caption(example):
            return not example.get("caption")

        pending = {
            split: data[split].filter(needs_caption)
            for split in data.keys() if not split.endswith("_passages")
        }
        n_pending = sum(len(v) for v in pending.values())
        logger.info("BLIP2v3: %d captions restored from store, %d pending",
                    restored["n"], n_pending)
        if n_pending:
            fresh = super()._call({k: v for k, v in pending.items() if len(v)})
            # merge fresh captions back by key
            for split, table in fresh.items():
                cols = table.column_names
                key_col = "image_id" if "image_id" in cols else "question_id"
                by_key = dict(zip(table[key_col], table["caption"]))

                def fill(example):
                    k = example["image_id" if "image_id" in example else "question_id"]
                    if not example.get("caption") and k in by_key:
                        example["caption"] = by_key[k]
                    return example

                data[split] = data[split].map(fill)
        return data
