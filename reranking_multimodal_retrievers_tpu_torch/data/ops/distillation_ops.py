"""Distillation score preparation (port of the JAX package's
``data/ops/distillation_ops.py``; reference
`src/data_ops/distillation_data_ops.py:51-432`): attach teacher retrieval
scores per (question, document) for student training."""

from __future__ import annotations

import json
import os
import pickle
import random

import numpy as np
import torch

from ...device import platform_device
from ...utils.registries import register_transform_functor
from ..transforms import HFDatasetTransform


def _cached_bert_base_vocab():
    """The ``bert-base-uncased`` directory of the local HF hub cache (the
    snapshot holding ``vocab.txt``), or None: what
    ``BertTokenizerFast.from_pretrained("bert-base-uncased",
    local_files_only=True)`` reads in the JAX package."""
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                  "huggingface"), "hub")
    snapshots = os.path.join(hub, "models--bert-base-uncased", "snapshots")
    if not os.path.isdir(snapshots):
        return None
    for name in sorted(os.listdir(snapshots)):
        if os.path.exists(os.path.join(snapshots, name, "vocab.txt")):
            return os.path.join(snapshots, name)
    return None


@register_transform_functor
class PrepareDistillationScores(HFDatasetTransform):
    """Attach teacher retrieval scores per (question, negatives) group.

    Two modes mirroring the reference (`distillation_data_ops.py:51-432`):
    - **precomputed**: load a {question_id: [{passage_id, score}...]} json/pkl
      (the role of the reference's ElasticSearch cache);
    - **live teacher**: run the port's FLMR teacher (an HF-named checkpoint
      dir, or weights drawn from a ``torch.Generator`` seeded ``seed`` where
      the JAX node draws from ``PRNGKey(seed)``) over 1 positive +
      ``num_negatives`` sampled negatives per question, 8 questions a
      batch, and record the MaxSim scores, under ``torch.no_grad`` on the
      device ``device.py::platform_device`` gives. With
      ``use_pallas_attention`` in the teacher's ``text_config`` its BERT
      runs K2's fp32 key-bias kernel on the card.
    """

    def setup(self, teacher_scores_path=None, docs_per_query: int = 10,
              model_checkpoint_dir=None, flmr_config=None,
              num_negatives: int = 4, splits_to_process=("train",),
              query_maxlen: int = 32, doc_maxlen: int = 64, seed: int = 42,
              **kwargs):
        self.teacher_scores_path = teacher_scores_path
        self.docs_per_query = docs_per_query
        self.model_checkpoint_dir = model_checkpoint_dir
        self.flmr_config = flmr_config
        self.num_negatives = num_negatives
        self.splits_to_process = list(splits_to_process)
        self.query_maxlen = query_maxlen
        self.doc_maxlen = doc_maxlen
        self.seed = seed
        return self

    def _call(self, data):
        if self.teacher_scores_path and os.path.exists(self.teacher_scores_path):
            return self._attach_precomputed(data)
        if self.flmr_config or self.model_checkpoint_dir:
            return self._score_live(data)
        return data

    def _attach_precomputed(self, data):
        if self.teacher_scores_path.endswith(".json"):
            with open(self.teacher_scores_path) as f:
                scores = json.load(f)
        else:
            with open(self.teacher_scores_path, "rb") as f:
                scores = pickle.load(f)

        def attach(example):
            entry = scores.get(str(example["question_id"]), [])
            example["teacher_doc_ids"] = [e["passage_id"] for e in entry][: self.docs_per_query]
            example["teacher_scores"] = [e.get("score", 0.0) for e in entry][: self.docs_per_query]
            return example

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            data[split] = data[split].map(attach)
        return data

    def build_teacher(self):
        """The teacher model on its device, in eval mode."""
        from ...models import FLMRModelForRetrieval
        from ...models.bert import BertConfig
        from ...models.checkpoint_dir import load_checkpoint_dir, load_into
        from ...models.flmr import FLMRConfig
        from ...models.vit import CLIPVisionConfig

        fc = dict(self.flmr_config or {})
        cfg = FLMRConfig(
            text_config=BertConfig(**fc.pop("text_config", {})),
            vision_config=CLIPVisionConfig(**fc.pop("vision_config", {})),
            **fc,
        )
        dev = platform_device()
        model = FLMRModelForRetrieval(cfg, device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(self.seed))
        if self.model_checkpoint_dir and os.path.isdir(self.model_checkpoint_dir):
            load_into(model, load_checkpoint_dir(self.model_checkpoint_dir))
        return model.eval()

    def score(self, model, q_enc, d_enc) -> np.ndarray:
        """The teacher's ``[B, 1 + num_negatives]`` scores of one batch of
        tokenized questions and their documents."""
        dev = next(model.parameters()).device
        with torch.no_grad():
            out = model(
                query_input_ids=torch.as_tensor(q_enc["input_ids"], device=dev).long(),
                query_attention_mask=torch.as_tensor(q_enc["attention_mask"], device=dev).long(),
                context_input_ids=torch.as_tensor(d_enc["input_ids"], device=dev).long(),
                context_attention_mask=torch.as_tensor(d_enc["attention_mask"],
                                                       device=dev).long(),
                num_negative_examples=self.num_negatives,
                use_in_batch_negatives=False,
            )
        return out.scores.float().cpu().numpy()

    def _score_live(self, data):
        import tempfile

        from ...models.tokenization import (FLMRContextTokenizer, FLMRQueryTokenizer,
                                            WordPieceTokenizer, tiny_wordpiece_tokenizer)

        rng = random.Random(self.seed)
        # tokenizers: FLMR tokenizers over the standard vocab when the local
        # HF cache holds it, else a throwaway vocab (the JAX node's fallback)
        cached = _cached_bert_base_vocab()
        base_tok = (WordPieceTokenizer.from_pretrained(cached) if cached
                    else tiny_wordpiece_tokenizer(tempfile.mkdtemp()))
        qt = FLMRQueryTokenizer(base_tok, query_maxlen=self.query_maxlen)
        ct = FLMRContextTokenizer(base_tok, doc_maxlen=self.doc_maxlen)
        model = self.build_teacher()

        for split in self.splits_to_process:
            if split not in data:
                continue
            passages = data.get(f"{split}_passages")
            id2doc = (
                dict(zip(passages["passage_id"], passages["passage_content"]))
                if passages is not None else {}
            )
            all_ids = list(id2doc.keys())

            def score_rows(batch):
                B = len(batch["question_id"])
                neg_ids, contents = [], []
                for i in range(B):
                    pos = (batch.get("pos_item_ids", [[None]] * B)[i] or [None])[0]
                    pos_content = id2doc.get(pos, "")
                    negs = []
                    # sample with replacement among non-positive ids; when
                    # the corpus has no other passage, repeat the positive
                    pool = [p for p in all_ids if p != pos] or all_ids
                    while len(negs) < self.num_negatives and pool:
                        negs.append(rng.choice(pool))
                    neg_ids.append(negs)
                    contents.append([pos_content] + [id2doc[n] for n in negs])
                q_enc = qt(list(batch["question"]))
                d_enc = ct([c for row in contents for c in row])
                batch["neg_item_ids"] = neg_ids
                batch["scores"] = self.score(model, q_enc, d_enc).tolist()
                return batch

            data[split] = data[split].map(score_rows, batched=True, batch_size=8)
        return data
