"""FLMR retriever executor: contrastive training + index-and-search eval
(port of ``executors/flmr_executor.py``).

Parity with `src/executors/FLMR_base_executor.py:77-1183`, as the JAX
package re-architected it:

- training: one eager step per batch (``training/train_state.py``: CE +
  in-batch-negative loss; the reference backprops the ib loss, `:461-464`);
- eval: queries are encoded in batches under ``inference_mode``; the corpus
  is encoded into a device-resident :class:`TokenIndex` and searched with
  exact MaxSim (kernel K1; K3 over a :class:`QuantizedTokenIndex` under
  ``use_int8_index``; the PLAID-role two-stage search under
  ``use_compressed_search``) — the reference's exhaustive branch
  (`:918-991`) is the semantic target;
- results: per-question ``top_ranking_passages`` + metrics + prediction dumps.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, List

import numpy as np
import torch

from ..engine import QuantizedTokenIndex, Searcher, TokenIndex, encode_corpus
from ..models import FLMRConfig, FLMRModelForRetrieval
from ..models.bert import BertConfig
from ..models.vit import CLIPVisionConfig
from ..training import TrainState, make_train_step
from ..utils.config_system import ConfigDict
from ..utils.registries import register_executor
from .base import BaseExecutor

logger = logging.getLogger(__name__)


def flmr_config_from(model_config: ConfigDict, query_tokenizer=None,
                     context_tokenizer=None) -> FLMRConfig:
    """Build an FLMRConfig from experiment config + tokenizer-derived statics
    (reference `FLMR_base_executor.py:146-189` + `modeling_flmr.py:701-718`)."""
    from ..models.tokenization import instruction_token_id, punctuation_skiplist_ids

    fc = dict(model_config.get("flmr", {}))
    text_cfg = BertConfig(**fc.pop("text_config", {}))
    vision_cfg = CLIPVisionConfig(**fc.pop("vision_config", {}))
    extra = {}
    if context_tokenizer is not None and fc.get("mask_punctuation", True):
        extra["punctuation_token_ids"] = punctuation_skiplist_ids(
            getattr(context_tokenizer, "tok", context_tokenizer))
    instr_tok = fc.pop("mask_instruction_token", None)
    if instr_tok and query_tokenizer is not None:
        extra["mask_instruction"] = True
        extra["instruction_token_id"] = instruction_token_id(
            getattr(query_tokenizer, "tok", query_tokenizer), instr_tok)
    return FLMRConfig(text_config=text_cfg, vision_config=vision_cfg, **fc, **extra)


def load_hf_state_dict(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """The state dict of an HF checkpoint directory's ``pytorch_model.bin``
    (the port's models use the reference checkpoints' parameter names)."""
    path = os.path.join(ckpt_dir, "pytorch_model.bin")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{ckpt_dir}: no pytorch_model.bin (safetensors checkpoints "
                                "are not read)")
    return torch.load(path, map_location="cpu", weights_only=True)


@register_executor
class FLMRExecutor(BaseExecutor):
    def frozen_patterns(self):
        """The reference freezes BOTH FLMR vision encoders unconditionally
        (`FLMR_base_executor.py:185-189`), regardless of which other module
        flags are set."""
        patterns = list(super().frozen_patterns())
        if "vision_encoder" not in patterns:
            patterns.append("vision_encoder")
        return patterns

    # ------------------------------------------------------------ model
    def _init_model(self):
        mc = self.config.get_path("model_config", ConfigDict())
        self.flmr_config = flmr_config_from(
            mc,
            query_tokenizer=self.tokenizers.get("tokenizer"),
            context_tokenizer=self.tokenizers.get("decoder_tokenizer"),
        )
        self.num_negative_samples = mc.get("num_negative_samples", 1)
        # drawn on the CPU from the seeded generator, then moved: the same
        # seed gives the same weights on any device
        self.model = FLMRModelForRetrieval(
            self.flmr_config, device="cpu", generator=self.generator).to(self.device)

        ckpt_dir = mc.get("checkpoint_dir")
        if ckpt_dir and os.path.isdir(ckpt_dir):
            logger.info("loading HF checkpoint from %s", ckpt_dir)
            self.model.load_state_dict(load_hf_state_dict(ckpt_dir))

        self._setup_corpus()
        self._train_state = None
        self._restored = None

    def _setup_corpus(self):
        """Build id2doc from the pipeline's passage tables (reference
        ``setup`` `:194-302`), plus per-source sub-corpora when
        ``validation_indexing_source`` is set (`:230-255`: multi-task M2KR
        validation retrieves each query against ITS dataset's passage pool,
        not the merged corpus)."""
        self.id2doc: Dict[str, str] = {}
        self.id2source: Dict[str, str] = {}
        passages = self.prepared_data.get("passages")
        if passages and "id2doc" in passages:
            self.id2doc = dict(passages["id2doc"])
            self.id2source = dict(passages.get("id2source") or {})
        else:
            for mode, loaders in self.data_loaders.items():
                for loader in loaders.values():
                    ds = getattr(loader, "dataset", None)
                    if ds is not None and getattr(ds, "passages", None):
                        self.id2doc.update(ds.passages["id2doc"])
                        self.id2source.update(ds.passages.get("id2source") or {})
        if self.use_dummy_data and len(self.id2doc) > 200:
            # sanity-time corpus reduction (reference `:674-687`)
            self.id2doc = dict(list(self.id2doc.items())[:100])
        self.source_id2doc: Dict[str, Dict[str, str]] = {}
        sources = self.config.get_path("model_config.validation_indexing_source", None)
        if sources:
            for name in sources:
                self.source_id2doc[name] = {}
            for pid, content in self.id2doc.items():
                src = self.id2source.get(pid)
                if src in self.source_id2doc:
                    self.source_id2doc[src][pid] = content

    # ------------------------------------------------------------ train
    def prepare_training(self, total_steps: int):
        optimizer, scheduler, _ = self.build_optimizer(self.model, total_steps)
        state = TrainState.create(self.model, optimizer, scheduler)
        if self._restored is not None and "optimizer" in self._restored:
            # resume (reference restores optimizer state, `:354-359`)
            optimizer.load_state_dict(self._restored["optimizer"])
            scheduler.load_state_dict(self._restored["scheduler"])
            state.step = int(self._restored["step"])
        self._restored = None
        self._train_state = state
        self._step_fn = make_train_step(
            self.model, optimizer, scheduler,
            mesh=self.mesh,
            loss_key=self.config.get_path("train.loss_key", "ib_loss"),
            num_negative_examples=self.num_negative_samples,
        )

    def model_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The training forward's keyword arguments for a collated batch."""
        b = self.to_device(batch)
        model_batch = dict(
            query_input_ids=b["input_ids"],
            query_attention_mask=b["attention_mask"],
            context_input_ids=b["decoder_input_ids"],
            context_attention_mask=b["decoder_attention_mask"],
        )
        if "pixel_values" in b:
            model_batch["query_pixel_values"] = b["pixel_values"]
        if "image_features" in b:
            model_batch["query_image_features"] = b["image_features"]
        return model_batch

    def training_step(self, batch) -> Dict[str, float]:
        self.model.train()
        self._train_state, metrics = self._step_fn(self._train_state,
                                                   self.shard(self.model_batch(batch)))
        return {k: float(v) for k, v in metrics.items()}

    def state_to_save(self):
        if self._train_state is None:
            return {"model": self.model.state_dict(), "step": self.global_step}
        return self._train_state

    def load_checkpoint(self, path: str):
        from ..training.checkpointing import CheckpointManager

        restored = CheckpointManager.restore(path, device=self.device)
        self.model.load_state_dict(restored["model"])
        # optimizer and scheduler state are loaded into the optimizer that
        # prepare_training builds
        self._restored = restored
        if restored.get("step") is not None:
            self.global_step = int(restored["step"])

    # ------------------------------------------------------------- eval
    @torch.inference_mode()
    def encode_queries(self, batch) -> torch.Tensor:
        """Query token matrices ``[B, L_q (+ vision rows), dim]`` of a batch;
        with no pixel values, the text rows only."""
        self.model.eval()
        b = self.to_device(batch)
        if "pixel_values" in b:
            out = self.model.query(b["input_ids"], b["attention_mask"],
                                   pixel_values=b["pixel_values"])
        else:
            out = self.model.query(b["input_ids"], b["attention_mask"],
                                   concat_output_from_vision_encoder=False)
        return out.late_interaction_output

    @torch.inference_mode()
    def build_index(self, id2doc=None) -> TokenIndex:
        """Encode the corpus into a TokenIndex on the executor's device (the
        reference's ``prepare_item_embeddings`` + ColBERT indexing,
        `:662-801`). ``id2doc`` overrides the corpus (the per-source
        validation sub-corpora). As in the JAX package, embeddings pass
        through fp16 on their way to the bf16 index. Over a mesh each rank
        encodes the batches that hold its block of docs (``encode_corpus``)."""
        self.model.eval()
        ct = self.tokenizers["decoder_tokenizer"]
        id2doc = id2doc if id2doc is not None else self.id2doc
        doc_ids = list(id2doc.keys())
        contents = [id2doc[d] for d in doc_ids]
        bs = self.config.get_path("test.index_batch_size", 16)
        dlen = self.config.get_path("model_config.doc_maxlen", 64)
        # 'multimodal_docs' (reference `:703-715`): per-doc precomputed image
        # features join the encode, from the passages dict or prepared_data
        multimodal = (
            "multimodal_docs" in (self.config.get_path("model_config.modules", []) or [])
            or self.config.get_path("model_config.multimodal_docs", False)
        )
        passages = self.prepared_data.get("passages") or {}
        id2feat = (passages.get("id2doc_image_features")
                   or self.prepared_data.get("id2doc_image_features") or {})
        multimodal = multimodal and bool(id2feat)
        zero_feat = (np.zeros_like(np.asarray(next(iter(id2feat.values())), np.float32))
                     if id2feat else None)

        def encode(rows):  # a batch is the doc positions it holds
            enc = ct([contents[i] for i in rows], max_length=dlen)
            ids = torch.as_tensor(enc["input_ids"]).to(self.device)
            am = torch.as_tensor(enc["attention_mask"]).to(self.device)
            if multimodal:
                feats = np.stack([np.asarray(id2feat.get(doc_ids[i], zero_feat), np.float32)
                                  for i in rows])
                out = self.model.doc(ids, am, image_features=torch.as_tensor(feats).to(self.device),
                                     concat_output_from_vision_encoder=True)
            else:
                out = self.model.doc(ids, am)
            return out.late_interaction_output, out.context_mask

        batches = (np.arange(i, min(i + bs, len(contents))) for i in range(0, len(contents), bs))
        return encode_corpus(encode, batches, doc_ids, device=self.device, mesh=self.mesh)

    class _CompressedAdapter:
        """CompressedSearcher → Searcher interface: int indices to doc ids."""

        def __init__(self, inner, doc_ids):
            self.inner = inner
            self.doc_ids = doc_ids

        def search(self, Q, remove_zero_rows: bool = False):
            vals, idx = self.inner.search(Q)
            ids = [[self.doc_ids[j] for j in row if j < len(self.doc_ids)] for row in idx]
            return ids, vals

    def make_searcher(self, index: TokenIndex, k: int):
        """The search path the module flags select (reference
        `FLMR_base_executor.py:722-732`): exact K1 search by default,
        'use_compressed_search' (unless 'exhaustive_search_in_testing') the
        PLAID-role two-stage path, 'use_int8_index' exact K3 search over a
        per-doc-scaled int8 index."""
        modules = self.config.get_path("model_config.modules", []) or []
        if "use_compressed_search" in modules and "exhaustive_search_in_testing" not in modules:
            from ..engine.codec import compress
            from ..engine.plaid import CompressedSearcher

            index = index.gathered()  # the codec trains on the whole index
            cidx = compress(index.embeddings, index.mask, index.doc_ids,
                            num_centroids=int(self.config.get_path(
                                "model_config.num_centroids", 256)),
                            device=self.device)
            return self._CompressedAdapter(CompressedSearcher(cidx, k=k), index.doc_ids)
        if "use_int8_index" in modules:
            return Searcher(QuantizedTokenIndex.from_token_index(index), k=k)
        return Searcher(index, k=k)

    def evaluate(self, mode: str = "test") -> ConfigDict:
        Ks = self.config.get_path("model_config.Ks", [5, 10, 20, 50, 100])
        limit = self.config.get_path(
            f"{mode}.trainer_paras.limit_{'val' if mode == 'valid' else 'test'}_batches")
        modules = self.config.get_path("model_config.modules", []) or []
        index = self.build_index()
        k = min(max(Ks), max(index.num_docs, 1))
        searcher = self.make_searcher(index, k)

        # per-source validation sub-indexes (reference `:230-255`): each
        # query retrieves against its own dataset's passage pool
        source_searchers = {}
        if mode == "valid" and self.source_id2doc:
            for src, sub in self.source_id2doc.items():
                if sub:
                    sidx = self.build_index(id2doc=sub)
                    if "use_int8_index" in modules:
                        sidx = QuantizedTokenIndex.from_token_index(sidx)
                    source_searchers[src] = Searcher(sidx, k=min(max(Ks), max(sidx.num_docs, 1)))

        batch_results: List[dict] = []
        for name, loader in self.eval_dataloaders(mode).items():
            for bi, batch in enumerate(loader):
                if limit and bi >= limit:
                    break
                Q = self.encode_queries(batch)
                ids, scores = searcher.search(Q)
                if source_searchers and "source_name" in batch:
                    # overwrite rows whose source has a dedicated sub-index
                    by_src = {}
                    for qi, src in enumerate(batch["source_name"]):
                        if src in source_searchers:
                            by_src.setdefault(src, []).append(qi)
                    ids, scores = list(ids), np.array(scores)  # writable copy
                    for src, rows in by_src.items():
                        s_ids, s_scores = source_searchers[src].search(Q[rows])
                        for out_i, qi in enumerate(rows):
                            ids[qi] = s_ids[out_i]
                            k_src = min(scores.shape[1], s_scores.shape[1])
                            scores[qi, :k_src] = s_scores[out_i, :k_src]
                real = batch.get("_real_count", len(ids))
                for qi in range(real):
                    entry = {
                        "question_id": batch["question_ids"][qi],
                        "question": batch["questions"][qi],
                        "top_ranking_passages": [
                            {"passage_id": pid, "content": self.id2doc[pid],
                             "score": float(scores[qi][rank])}
                            for rank, pid in enumerate(ids[qi])
                        ],
                    }
                    if "answers" in batch:
                        entry["answers"] = batch["answers"][qi]
                        entry["gold_answer"] = batch["gold_answer"][qi]
                    if "pos_item_ids" in batch:
                        entry["pos_item_ids"] = batch["pos_item_ids"][qi]
                    batch_results.append(entry)

        data_dict = {"batch_retrieval_result": batch_results, "Ks": Ks}
        log_dict = self.compute_metrics(data_dict)
        log_dict["batch_retrieval_result"] = batch_results
        return log_dict

    def save_hf_model(self, out_dir: str):
        """Export the model for downstream use (reference ``save_HF_model``,
        `:1170-1183`): the state dict under the reference checkpoint's
        parameter names (``pytorch_model.bin``, read back by
        ``model_config.checkpoint_dir``) + the config json."""
        os.makedirs(out_dir, exist_ok=True)
        sd = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(self.flmr_config), f, default=str)
