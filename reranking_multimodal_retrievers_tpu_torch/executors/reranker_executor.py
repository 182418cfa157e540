"""Reranker executor: train + rerank-eval over static retrieval results
(port of ``executors/reranker_executor.py``).

Parity with `src/executors/Reranker_base_executor.py:80-1201`, as the JAX
package built it:

- ``init_retrieve``: static retrieval results (question_id → top passages)
  loaded from json/json.gz/pkl (`:244-271`); in dummy mode synthesized from
  the corpus (positives + random distractors);
- train-time doc selection: ground-truth positive + sampled retrieved
  negatives (``negative_sample_model_inputs``, `:486-530`) or random
  retrieved docs with binary labels (``sample_model_inputs``, `:532-566`),
  gated by the ``model_config.modules`` flags;
- test: per batch of queries, rerank the static top-``docs_to_rerank`` docs
  with one ``[B·K, L]`` forward (chunked for the full-context family), sort
  by logit, keep the raw (retriever-ordered) list for the side-by-side
  rerank-vs-raw metrics (`:651-1030`).

Every family of the JAX package is here: the encoder families
(``full_context``, ``spliced``, with or without PreFLMR attention fusion),
the ``interaction`` rerankers over a frozen retriever's token matrices
(:func:`interaction_inputs`; fusion's bias from :func:`fusion_inputs`), and
the ``decoder`` rerankers (the native backbone and BLIP-2 over Flan-T5 or
OPT, a ``decoder_checkpoint_dir`` read by ``models/checkpoint_dir.py``).
The frozen retriever runs under ``torch.no_grad`` and is in no optimizer.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import FLMRModelForRetrieval
from ..models.bert import BertConfig
from ..models.blip2 import Blip2Config, Blip2QFormerConfig, Blip2VisionConfig
from ..models.checkpoint_dir import load_checkpoint_dir, load_into
from ..models.opt import OPTConfig
from ..models.rerankers import (Blip2DecoderHeadRerankModel, Blip2DecoderRerankModel,
                                Blip2RerankConfig, DecoderHeadRerankModel, DecoderRerankConfig,
                                DecoderRerankModel, FullContextRerankModel,
                                InteractionRerankConfig, InteractionRerankModel, RerankConfig,
                                RerankModel, prepare_decoder_rerank_inputs)
from ..models.t5 import T5Config
from ..models.tokenization import prepare_full_context_inputs, remove_instruction_prefix
from ..training.checkpointing import CheckpointManager
from ..training import TrainState, make_rerank_train_step
from ..utils.config_system import ConfigDict
from ..utils.registries import register_executor
from .base import BaseExecutor
from .flmr_executor import flmr_config_from

logger = logging.getLogger(__name__)

@torch.no_grad()
def interaction_inputs(retriever, query_input_ids, query_attention_mask, context_input_ids,
                       context_attention_mask, query_pixel_values: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """The frozen retriever's query and doc token matrices as an
    ``InteractionRerankModel``'s inputs (JAX ``reranker_executor.py:714-748``):
    ``query_late_interaction``, ``context_late_interaction``, ``query_mask``
    and ``context_mask`` (int32). ``query_pixel_values`` is None for a
    text-only reranker or a retriever without its vision encoder."""
    qout = retriever.query(query_input_ids, query_attention_mask, pixel_values=query_pixel_values)
    dout = retriever.doc(context_input_ids, context_attention_mask)
    return dict(query_late_interaction=qout.late_interaction_output,
                context_late_interaction=dout.late_interaction_output,
                query_mask=qout.query_mask,
                context_mask=dout.context_mask.to(torch.int32))


@torch.no_grad()
def fusion_inputs(retriever, query_input_ids, query_attention_mask, context_input_ids,
                  context_attention_mask, num_negative_examples: int,
                  query_pixel_values: Optional[torch.Tensor] = None,
                  fusion_multiplier: float = 1.0) -> Dict[str, object]:
    """PreFLMR attention fusion's inputs (JAX ``reranker_executor.py:674-712``):
    the retriever's masked token scores of each query against its (1 +
    ``num_negative_examples``) candidates, ``preflmr_scores [rows, Lc, Lq]``,
    and ``fusion_multiplier``."""
    out = retriever(query_input_ids=query_input_ids, query_attention_mask=query_attention_mask,
                    context_input_ids=context_input_ids,
                    context_attention_mask=context_attention_mask,
                    query_pixel_values=query_pixel_values,
                    num_negative_examples=num_negative_examples, use_in_batch_negatives=False)
    return {"preflmr_scores": out.scores_raw, "fusion_multiplier": fusion_multiplier}


def _submodules(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A flat state dict grouped by top-level submodule name."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, value in state_dict.items():
        top, _, rest = name.partition(".")
        groups.setdefault(top, {})[rest] = value
    return groups


def warm_start_from_retriever(state_dict: Dict[str, torch.Tensor],
                              retriever_state_dict: Dict[str, torch.Tensor]
                              ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Copy the shared FLMR-backbone submodules of a trained retriever's
    state dict into a freshly initialised reranker's.

    The reference never trains a monoPreFLMR reranker from scratch: its
    ``RerankModel`` splices the encoders of a pretrained PreFLMR
    (`Reranker_base_executor.py:185-242`; `rerank_model.py:88-101`) and only
    the cross-encoder head and input mapping start fresh. The submodule
    names are shared by construction (``context_text_encoder``,
    ``context_vision_encoder``, ``context_vision_projection``,
    ``transformer_mapping_*``), so warm-starting copies top-level
    submodules. A submodule in both must have the same parameter names and
    shapes (a loud failure beats silently keeping random weights); the
    copied tensors take the reranker's dtype. Submodules only in the
    reranker keep their fresh init.

    Returns ``(merged_state_dict, restored_submodule_names)``."""
    mine, theirs = _submodules(state_dict), _submodules(retriever_state_dict)
    merged = dict(state_dict)
    restored = []
    for top, sub in mine.items():
        if top not in theirs:
            continue
        rsub = theirs[top]
        if set(sub) != set(rsub):
            raise ValueError(
                f"reranker backbone warm-start: submodule {top!r} has other parameters in "
                "the reranker's flmr config than in the retriever checkpoint")
        if any(sub[k].shape != rsub[k].shape for k in sub):
            raise ValueError(
                f"reranker backbone warm-start: submodule {top!r} parameter shapes differ "
                "between the reranker's flmr config and the retriever checkpoint")
        for k in sub:
            merged[f"{top}.{k}"] = rsub[k].to(device=sub[k].device, dtype=sub[k].dtype)
        restored.append(top)
    return merged, restored


def decoder_reranker_config(mc, loss_fn: str, pos_weight: Optional[float]):
    """``(config, model class)`` of the decoder family from
    ``model_config.decoder`` (JAX ``reranker_executor.py:142-194``): the
    ``native`` backbone over a BERT text config, or BLIP-2 (``blip2``:
    Flan-T5, ``blip2_opt``: OPT). ``decoder_head`` picks the two-head
    model (Model B) over yes/no scoring (Model A)."""
    dec_kwargs = dict(mc.get("decoder", {}))
    backbone = dec_kwargs.pop("backbone", "native")
    head = mc.get("decoder_head", False)
    if backbone in ("blip2", "blip2_opt"):
        text_cls = OPTConfig if backbone == "blip2_opt" else T5Config
        blip2 = Blip2Config(
            vision_config=Blip2VisionConfig(**dec_kwargs.pop("vision_config", {})),
            qformer_config=Blip2QFormerConfig(**dec_kwargs.pop("qformer_config", {})),
            text_config=text_cls(**dec_kwargs.pop("text_config", {})),
            num_query_tokens=dec_kwargs.pop("num_query_tokens", 32))
        cfg = Blip2RerankConfig(blip2=blip2, loss_fn=loss_fn, pos_weight=pos_weight,
                                **dec_kwargs)
        return cfg, (Blip2DecoderHeadRerankModel if head else Blip2DecoderRerankModel)
    if backbone != "native":
        raise ValueError(f"model_config.decoder.backbone must be 'native', 'blip2' or "
                         f"'blip2_opt', got {backbone!r}")
    cfg = DecoderRerankConfig(text_config=BertConfig(**dec_kwargs.pop("text_config", {})),
                              loss_fn=loss_fn, pos_weight=pos_weight, **dec_kwargs)
    return cfg, (DecoderHeadRerankModel if head else DecoderRerankModel)


@register_executor
class RerankerExecutor(BaseExecutor):
    # ------------------------------------------------------------ model
    def _init_model(self):
        mc = self.config.get_path("model_config", ConfigDict())
        self.modules = list(mc.get("modules", []))
        self.Ks = mc.get("Ks", [5, 10, 20, 50, 100])
        self.docs_to_rerank = mc.get("docs_to_rerank", max(self.Ks))
        self.num_negative_samples = mc.get("num_negative_samples", 4)
        self.fusion_multiplier = mc.get("fusion_multiplier", 1.0)
        self._rng = random.Random(self.config.get_path("meta.seed", 42) or 42)

        ce_cfg = BertConfig(**mc.get("cross_encoder", {"num_hidden_layers": 1}))
        loss_fn = mc.get("loss_fn", "BCE")
        pos_weight = mc.get("pos_weight")
        if "weighted_regression" in self.modules and pos_weight is None:
            # reference `Reranker_base_executor.py:196-199`: weight the BCE
            # positive class by the group size (1 pos : N negs); an explicit
            # pos_weight in the config wins over the flag's derived value
            pos_weight = float(self.num_negative_samples + 1)
        # weights are drawn on the CPU from the seeded generator, then moved
        # (the same weights on any device); the decoder family is drawn on
        # its device (``device_generator``)
        where, gen = "cpu", self.generator
        if "interaction_reranker" in self.modules:
            self.reranker_family = "interaction"
            # fusion x MORES is supported (JAX ``reranker_executor.py:127-131``):
            # the fusion block biases MORES's cross-attention
            self.reranker_config = InteractionRerankConfig(
                cross_encoder=ce_cfg, interaction_type=mc.get("interaction_type", "CrossEncoder"),
                loss_fn=loss_fn, pos_weight=pos_weight,
                late_interaction_dim=mc.get("late_interaction_dim", 128))
            cls = InteractionRerankModel
        elif "decoder_reranker" in self.modules:
            self.reranker_family = "decoder"
            self.reranker_config, cls = decoder_reranker_config(mc, loss_fn, pos_weight)
            where, gen = self.device, self.device_generator()
        else:
            # encoder family: joint-retokenization FullContext when flagged,
            # otherwise the spliced-query RerankModel — the reference's
            # module→class mapping (`Reranker_base_executor.py:151-183`)
            flmr_cfg = flmr_config_from(
                mc,
                query_tokenizer=self.tokenizers.get("tokenizer"),
                context_tokenizer=self.tokenizers.get("decoder_tokenizer"),
            )
            self.reranker_config = RerankConfig(
                flmr=flmr_cfg,
                cross_encoder=ce_cfg,
                loss_fn=loss_fn,
                pos_weight=pos_weight,
                max_query_length=mc.get("max_query_length", 32),
                max_decoder_source_length=mc.get("max_decoder_source_length", 512),
            )
            if "full_context_reranker" in self.modules:
                self.reranker_family = "full_context"
                cls = FullContextRerankModel
            else:
                self.reranker_family = "spliced"
                cls = RerankModel
        self.reranker = cls(self.reranker_config, device=where, generator=gen).to(self.device)
        if self.reranker_family == "decoder":
            ckpt_dir = mc.get("decoder_checkpoint_dir")
            if ckpt_dir and os.path.isdir(ckpt_dir) and isinstance(self.reranker_config,
                                                                   Blip2RerankConfig):
                # the HF BLIP-2 state dict goes into the backbone; a head
                # model's classifier1/classifier2 keep their init (JAX
                # ``reranker_executor.py:195-210``, ``_init_params:283-288``)
                logger.info("loading the BLIP-2 checkpoint %s", ckpt_dir)
                load_into(self.reranker.model, load_checkpoint_dir(ckpt_dir))
        self.retriever = None
        if self.reranker_family == "interaction" or "preflmr_attention_fusion" in self.modules:
            self._build_retriever(mc)

        self._setup_corpus()
        self.init_retrieve()
        self._warm_start()
        self._train_state = None
        self._restored = None
        self._rerank_fn = None

    def _build_retriever(self, mc):
        """The frozen retriever of the interaction rerankers and of attention
        fusion (JAX ``reranker_executor.py:237-256, 312-353``): built from
        ``model_config.retriever_flmr`` when given, else from the reranker's
        ``flmr``, and loaded from ``retriever_model_path``, an
        ``FLMRExecutor`` checkpoint whose parameters must be exactly this
        model's (a mismatched config raises instead of scoring with random
        weights)."""
        r_mc = mc
        if mc.get("retriever_flmr"):
            r_mc = ConfigDict(dict(mc, flmr=mc["retriever_flmr"]))
        self.retriever_config = flmr_config_from(
            r_mc,
            query_tokenizer=self.tokenizers.get("tokenizer"),
            context_tokenizer=self.tokenizers.get("decoder_tokenizer"),
        )
        self.retriever = FLMRModelForRetrieval(self.retriever_config, device="cpu",
                                               generator=self.generator).to(self.device)
        self.retriever.eval().requires_grad_(False)
        rpath = mc.get("retriever_model_path")
        if not rpath:
            return
        restored = CheckpointManager.restore(rpath, device="cpu", mmap=True)
        got = restored["model"]
        want = self.retriever.state_dict()
        if set(got) != set(want) or any(tuple(got[k].shape) != tuple(want[k].shape)
                                        for k in want):
            raise ValueError(f"retriever_model_path {rpath}: the checkpoint's parameters do "
                             "not match model_config.flmr (the frozen retriever)")
        self.retriever.load_state_dict(got)
        logger.info("loaded the frozen retriever from %s", rpath)

    def _setup_corpus(self):
        self.id2doc: Dict[str, str] = {}
        passages = self.prepared_data.get("passages")
        if passages and "id2doc" in passages:
            self.id2doc = dict(passages["id2doc"])
        else:
            for loaders in self.data_loaders.values():
                for loader in loaders.values():
                    ds = getattr(loader, "dataset", None)
                    if ds is not None and getattr(ds, "passages", None):
                        self.id2doc.update(ds.passages["id2doc"])

    def _warm_start(self):
        """``model_config.reranker_backbone_path``: warm-start the spliced
        FLMR encoders from a trained retriever checkpoint — the reference's
        standing recipe."""
        bpath = self.config.get_path("model_config.reranker_backbone_path", None)
        if not bpath:
            return
        restored_ckpt = CheckpointManager.restore(bpath, device=self.device)
        merged, restored = warm_start_from_retriever(self.reranker.state_dict(),
                                                     restored_ckpt["model"])
        if not restored:
            raise ValueError(f"reranker_backbone_path {bpath}: no shared FLMR "
                             "submodules found to warm-start")
        self.reranker.load_state_dict(merged)
        logger.info("warm-started reranker backbone from %s: %s", bpath, restored)

    # -------------------------------------------------- static retrieval
    def init_retrieve(self):
        """Reference `:244-271`."""
        path = self.config.get_path("model_config.retrieve_result_path")
        self.questionId2topPassages: Dict[str, List[dict]] = {}
        # transparent .gz fallback: large static-retrieval dumps are
        # committed gzipped (git-friendly) while configs keep pointing at
        # the plain path — a fresh checkout works without a manual gunzip
        if path and not os.path.exists(path) and os.path.exists(path + ".gz"):
            path = path + ".gz"
        if path and os.path.exists(path):
            if path.endswith(".json.gz"):
                import gzip
                with gzip.open(path, "rt") as f:
                    loaded = json.load(f)
            elif path.endswith(".json"):
                with open(path) as f:
                    loaded = json.load(f)
            else:
                with open(path, "rb") as f:
                    loaded = pickle.load(f)
            # accepted shapes: {qid: [{passage_id, score}...]}, the
            # prediction-dump format from FLMRExecutor.logging_results, or a
            # reference-produced dump ({"output": [...]}, the layout
            # `src/tools/reduce_retrieval_result_file_size.py` pickles)
            if "predictions" in loaded or "output" in loaded:
                # branch on key presence, not truthiness: a framework dump
                # with an empty predictions list is valid and must not fall
                # through to a KeyError on "output"
                entries = (loaded["predictions"] if "predictions" in loaded
                           else loaded["output"])
                for entry in entries:
                    self.questionId2topPassages[str(entry["question_id"])] = entry[
                        "top_ranking_passages"
                    ]
            else:
                self.questionId2topPassages = {str(k): v for k, v in loaded.items()}
        elif self.use_dummy_data:
            self._synthesize_static_retrieval()
        else:
            logger.warning("no static retrieval results configured")

    def _synthesize_static_retrieval(self):
        all_ids = list(self.id2doc.keys())
        for loaders in self.data_loaders.values():
            for loader in loaders.values():
                ds = getattr(loader, "dataset", None)
                table = getattr(ds, "dataset", None)
                if table is None:
                    continue
                for row in table:
                    qid = str(row["question_id"])
                    if qid in self.questionId2topPassages:
                        continue
                    pos = list(row.get("pos_item_ids", []))
                    pos_set = set(pos)
                    # only docs_to_rerank docs survive the slice — stop the
                    # corpus scan there instead of materializing all of it
                    pool = list(pos)
                    for p in all_ids:
                        if len(pool) >= self.docs_to_rerank:
                            break
                        if p not in pos_set:
                            pool.append(p)
                    pool = pool[: self.docs_to_rerank]
                    self._rng.shuffle(pool)
                    self.questionId2topPassages[qid] = [
                        {"passage_id": p, "content": self.id2doc[p], "score": 1.0}
                        for p in pool
                    ]

    def static_retrieve(self, question_id) -> List[dict]:
        """Reference `:1032-1054`; lists shorter than K pad by replication
        (reference `FLMR_base_executor.py:1006-1015`). Entries from reduced
        static files (`tools/reduce_retrieval_file.py` strips ``content``,
        mirroring `src/tools/reduce_retrieval_result_file_size.py`) get their
        content re-resolved from the passage corpus, as the reference does
        via its own ``passage_id2doc`` lookup."""
        docs = self.questionId2topPassages.get(str(question_id), [])
        resolved = []
        for d in docs[: self.docs_to_rerank]:
            if "content" in d:
                resolved.append(d)
                continue
            # reference dumps may carry int passage ids while the corpus is
            # keyed by str (or vice versa) — normalize instead of silently
            # handing the reranker an empty passage
            pid = d["passage_id"]
            content = self.id2doc.get(pid)
            if content is None:
                content = self.id2doc.get(str(pid))
            if content is None:
                logger.warning(
                    "static-retrieval passage id %r absent from corpus; "
                    "reranking it as empty text", pid)
                content = ""
            resolved.append({**d, "content": content})
        docs = resolved
        while docs and len(docs) < self.docs_to_rerank:
            docs = docs + docs[: self.docs_to_rerank - len(docs)]
        return docs

    # ------------------------------------------------------------ train
    def trained_model(self) -> torch.nn.Module:
        """The model that trains, is saved and is restored."""
        return self.reranker

    def _create_train_state(self, total_steps: int) -> TrainState:
        """A TrainState over :meth:`trained_model` with its optimizer, the
        restored optimizer and scheduler state when a checkpoint was loaded."""
        model = self.trained_model()
        optimizer, scheduler, _ = self.build_optimizer(model, total_steps)
        state = TrainState.create(model, optimizer, scheduler)
        if self._restored is not None and "optimizer" in self._restored:
            optimizer.load_state_dict(self._restored["optimizer"])
            scheduler.load_state_dict(self._restored["scheduler"])
            state.step = int(self._restored["step"])
        self._restored = None
        self._train_state = state
        return state

    def prepare_training(self, total_steps: int):
        state = self._create_train_state(total_steps)
        self._step = make_rerank_train_step(self.reranker, state.optimizer, state.scheduler,
                                            num_negative_examples=self.num_negative_samples)

    def _select_training_docs(self, qid, pos_ids):
        """negative_sample vs sample modes (reference `:486-566`)."""
        retrieved = [d["passage_id"] for d in self.static_retrieve(qid)]
        if not retrieved:
            retrieved = list(self.id2doc.keys())[: self.docs_to_rerank]
        if "neg_sample_retrieved" in self.modules or "train_with_retrieved_docs" not in self.modules:
            # 1 positive + N negatives, both RANDOMLY sampled from the
            # retrieved list (reference `negative_sample_model_inputs`,
            # `Reranker_base_executor.py:486-531`: `local_random.sample`).
            # Sampling matters: with a deterministic top-N slice the model
            # only ever sees the same num_negative_samples docs per query and
            # the remaining retrieved candidates are out-of-distribution at
            # eval time — rerank then *degrades* the raw order.
            pos_set = set(pos_ids)
            retrieved_pos = [p for p in retrieved if p in pos_set]
            if retrieved_pos:
                pos = self._rng.choice(retrieved_pos)
            elif pos_ids:
                pos = self._rng.choice(pos_ids)
            else:
                pos = retrieved[0]
            negs = [p for p in retrieved if p not in pos_set]
            if len(negs) < self.num_negative_samples:
                # top up from the corpus, stopping once we have enough —
                # never materialize an 80k-element list per training sample
                for p in self.id2doc:
                    if len(negs) >= self.num_negative_samples:
                        break
                    if p not in pos_set:
                        negs.append(p)
            elif len(negs) > self.num_negative_samples:
                negs = self._rng.sample(negs, self.num_negative_samples)
            selected = [pos] + negs[: self.num_negative_samples]
            labels = [1] + [0] * self.num_negative_samples
        else:
            # random N+1 retrieved docs with binary labels (`:532-566`)
            selected = self._rng.sample(retrieved, min(len(retrieved), self.num_negative_samples + 1))
            while len(selected) < self.num_negative_samples + 1:
                selected.append(selected[-1])
            labels = [1 if p in set(pos_ids) else 0 for p in selected]
        return selected, labels

    def _sampled_labels(self) -> bool:
        """Whether a training batch carries the sampled docs' binary labels
        ('train_with_retrieved_docs' without 'neg_sample_retrieved')."""
        return ("train_with_retrieved_docs" in self.modules
                and "neg_sample_retrieved" not in self.modules)

    def _training_batch(self, batch, labelled: bool) -> Dict[str, object]:
        """The reranker's forward arguments for a collated batch: each
        query's selected docs (reference `:486-566`), and with ``labelled``
        their binary labels."""
        nway = self.num_negative_samples + 1
        doc_ids, labels = [], []
        for qi, qid in enumerate(batch["question_ids"]):
            pos = (batch.get("pos_item_ids") or [[]] * len(batch["question_ids"]))[qi]
            sel, lab = self._select_training_docs(qid, [p for p in pos if p])
            doc_ids.extend(sel)
            labels.extend(lab)
        contents = [self.id2doc.get(d, "") for d in doc_ids]
        queries = [remove_instruction_prefix(q) for q in batch["questions"]]
        model_batch = self._build_rerank_inputs(batch, queries, contents, nway)
        if labelled:
            model_batch["labels"] = torch.tensor(labels, dtype=torch.float32,
                                                 device=self.device)
        return model_batch

    def training_step(self, batch) -> Dict[str, float]:
        self.reranker.train()
        self._train_state, metrics = self._step(
            self._train_state, self._training_batch(batch, self._sampled_labels()))
        return {"loss": float(metrics["loss"])}

    def _build_rerank_inputs(self, batch, queries, contents, nway) -> Dict[str, object]:
        """The reranker's forward arguments on the executor's device for
        ``queries`` and their ``nway`` candidates each (JAX
        ``reranker_executor.py:602-672``)."""
        def dev(x):
            return torch.as_tensor(x).to(self.device)

        if self.reranker_family == "interaction":
            model_batch = self._interaction_inputs(batch, contents)
            self._maybe_attach_fusion(model_batch, batch, contents, nway)
            return model_batch
        if self.reranker_family == "decoder":
            tok = getattr(self.tokenizers.get("decoder_tokenizer"), "tok", None)
            mc = self.config.get_path("model_config", ConfigDict())
            enc = prepare_decoder_rerank_inputs(
                queries, contents, tok,
                max_query_length=mc.get("max_query_length", 32),
                max_context_length=mc.get("max_context_length", 64),
                max_decoder_source_length=mc.get("max_decoder_source_length", 128),
                docs_per_query=nway)
            return dict(input_ids=dev(enc["input_ids"]),
                        attention_mask=dev(enc["attention_mask"]),
                        pixel_values=(dev(batch["pixel_values"]) if "pixel_values" in batch
                                      else None))
        pix = None
        if "text_only" not in self.modules and "pixel_values" in batch:
            pix = dev(batch["pixel_values"])
        if self.reranker_family == "spliced":
            # raw query tokens + separately tokenized contexts; the model
            # splices them (reference `rerank_model.py:204-224`)
            enc_d = self._tokenize_contexts(contents)
            model_batch = dict(
                query_input_ids=dev(batch["input_ids"]),
                query_attention_mask=dev(batch["attention_mask"]),
                query_pixel_values=pix,
                context_input_ids=dev(enc_d["input_ids"]),
                context_attention_mask=dev(enc_d["attention_mask"]),
            )
            self._maybe_attach_fusion(model_batch, batch, contents, nway)
            return model_batch
        cfg = self.reranker_config
        tok = getattr(self.tokenizers.get("tokenizer"), "tok", None) or getattr(
            self.tokenizers.get("decoder_tokenizer"), "tok", None)
        enc = prepare_full_context_inputs(
            queries, contents, tok,
            max_query_length=cfg.max_query_length,
            max_context_length=cfg.max_context_length,
            max_decoder_source_length=cfg.max_decoder_source_length,
            docs_per_query=nway,
        )
        return {
            "input_ids": dev(enc["input_ids"]),
            "attention_mask": dev(enc["attention_mask"]),
            "token_type_ids": dev(enc["token_type_ids"]),
            "query_pixel_values": pix,
        }

    def _tokenize_contexts(self, contents):
        ct = self.tokenizers["decoder_tokenizer"]
        return ct(contents, max_length=self.config.get_path("model_config.doc_maxlen", 64))

    def _retriever_pixels(self, batch):
        """The query images for the frozen retriever: none under
        ``text_only`` (its token scores carry the same query rows as the
        text-only reranker they bias) or for a retriever without vision."""
        if ("pixel_values" not in batch or "text_only" in self.modules
                or not self.retriever_config.use_vision_encoder):
            return None
        return torch.as_tensor(batch["pixel_values"]).to(self.device)

    def _maybe_attach_fusion(self, model_batch, batch, contents, nway):
        """PreFLMR attention fusion (JAX ``reranker_executor.py:674-712``):
        the frozen retriever's masked token scores become an additive
        attention bias in the cross-encoder."""
        if "preflmr_attention_fusion" not in self.modules:
            return
        if "context_input_ids" in model_batch:
            ctx_ids = model_batch["context_input_ids"]
            ctx_mask = model_batch["context_attention_mask"]
        else:
            enc_d = self._tokenize_contexts(contents)
            ctx_ids = torch.as_tensor(enc_d["input_ids"]).to(self.device)
            ctx_mask = torch.as_tensor(enc_d["attention_mask"]).to(self.device)
        model_batch.update(fusion_inputs(
            self.retriever, torch.as_tensor(batch["input_ids"]).to(self.device),
            torch.as_tensor(batch["attention_mask"]).to(self.device), ctx_ids, ctx_mask,
            num_negative_examples=nway - 1, query_pixel_values=self._retriever_pixels(batch),
            fusion_multiplier=self.fusion_multiplier))

    def _interaction_inputs(self, batch, contents):
        """The frozen retriever's late-interaction matrices of the queries
        and of their candidates (JAX ``reranker_executor.py:714-748``)."""
        enc_d = self._tokenize_contexts(contents)
        return interaction_inputs(
            self.retriever, torch.as_tensor(batch["input_ids"]).to(self.device),
            torch.as_tensor(batch["attention_mask"]).to(self.device),
            torch.as_tensor(enc_d["input_ids"]).to(self.device),
            torch.as_tensor(enc_d["attention_mask"]).to(self.device),
            query_pixel_values=self._retriever_pixels(batch))

    def state_to_save(self):
        if self._train_state is None:
            return {"model": self.trained_model().state_dict(), "step": self.global_step}
        return self._train_state

    def load_checkpoint(self, path: str):
        # on the host, mapped: the model's tensors are copied to the device,
        # and the optimizer's are read only if a resume needs them
        restored = CheckpointManager.restore(path, device="cpu", mmap=True)
        self.trained_model().load_state_dict(restored["model"])
        # optimizer and scheduler state are loaded into the optimizer that
        # prepare_training builds
        self._restored = restored
        if restored.get("step") is not None:
            self.global_step = int(restored["step"])

    # ------------------------------------------------------------- eval
    @torch.no_grad()
    def _fast_validate(self, limit) -> ConfigDict:
        """Loss-only validation — the reference's ``fast_evaluate_outputs``
        path (`Reranker_base_executor.py:641-645`). Doc selection mirrors
        training (static retrieval; the ``test_with_retrieved_docs`` flag
        adds sampled-doc labels exactly like ``train_with_retrieved_docs``,
        reference `:730-751`)."""
        self.reranker.eval()
        loss_sum, weight_sum = 0.0, 0.0
        for name, loader in self.eval_dataloaders("valid").items():
            for bi, batch in enumerate(loader):
                if limit and bi >= limit:
                    break
                # drop padding-duplicated tail rows: a batch-mean loss over
                # padded rows over-weights the duplicated samples
                real = batch.get("_real_count", len(batch["question_ids"]))
                nb = len(batch["question_ids"])
                if real < nb:
                    batch = {k: (v[:real] if hasattr(v, "__len__") and len(v) == nb else v)
                             for k, v in batch.items()}
                model_batch = self._training_batch(
                    batch, "test_with_retrieved_docs" in self.modules or self._sampled_labels())
                out = self.reranker(**model_batch,
                                    num_negative_examples=self.num_negative_samples)
                loss_sum += float(out.loss) * real
                weight_sum += real
        out = ConfigDict(metrics={}, artifacts={})
        out.metrics["loss"] = loss_sum / weight_sum if weight_sum else 0.0
        return out

    def _forward_fn(self, K: int):
        """``fwd(model_batch) -> logits [B, K]`` of the eval forward: the
        chunked ``[B·K, L]`` program for the full-context family
        (``engine/rerank_eval.py``), one forward for the spliced one."""
        chunk_size = self.config.get_path("model_config.eval_chunk_size", 64)
        if "split_testing_batch" in self.modules:
            # reference `:838-919` halves OOM-ing test batches at runtime;
            # here the static equivalent is a half-size chunk
            chunk_size = max(1, chunk_size // 2)
        if self.reranker_family == "full_context":
            from ..engine import make_chunked_rerank_fn

            chunked = make_chunked_rerank_fn(self.reranker, nway=K, chunk_size=chunk_size,
                                             mesh=self.mesh)
            return lambda mb: chunked(mb["input_ids"], mb["attention_mask"],
                                      mb["token_type_ids"], mb.get("query_pixel_values"))

        def plain_fwd(mb):
            with torch.inference_mode():
                return self.reranker(**mb, num_negative_examples=K - 1).logits.reshape(-1, K)

        return plain_fwd

    def evaluate(self, mode: str = "test") -> ConfigDict:
        limit = self.config.get_path(
            f"{mode}.trainer_paras.limit_{'val' if mode == 'valid' else 'test'}_batches")
        if mode == "valid" and "full_validation" not in self.modules:
            # reference default (`Reranker_base_executor.py:641-645`):
            # validation computes loss only; the full rerank runs only when
            # the 'full_validation' module flag is set
            return self._fast_validate(limit)
        self.reranker.eval()
        K = self.docs_to_rerank
        batch_results: List[dict] = []
        # the [B·K, L] joint forward that replaces the reference's per-query
        # loop (`Reranker_base_executor.py:785-935`)
        fwd = self._forward_fn(K)
        for name, loader in self.eval_dataloaders(mode).items():
            for bi, batch in enumerate(loader):
                if limit and bi >= limit:
                    break
                n_rows = len(batch["question_ids"])
                real = batch.get("_real_count", n_rows)
                # queries with no static retrieval results keep a placeholder
                # doc list and are *marked*, not dropped — dropping silently
                # overstates coverage in the metrics
                per_q_docs = [self.static_retrieve(batch["question_ids"][qi])
                              for qi in range(n_rows)]
                fallback = [{"passage_id": p, "content": self.id2doc[p], "score": 0.0}
                            for p in list(self.id2doc.keys())[:K]]
                contents, queries = [], []
                for qi in range(n_rows):
                    docs = per_q_docs[qi] or fallback
                    per_q_docs[qi] = docs
                    contents.extend(d["content"] for d in docs)
                    queries.append(remove_instruction_prefix(batch["questions"][qi]))
                model_batch = self._build_rerank_inputs(batch, queries, contents, K)
                logits = fwd(model_batch).float().cpu().numpy().reshape(n_rows, K)
                for qi in range(real):
                    docs = per_q_docs[qi]
                    missing_static = not self.questionId2topPassages.get(
                        str(batch["question_ids"][qi]))
                    row = logits[qi]
                    order = np.argsort(-row)
                    entry = {
                        "question_id": batch["question_ids"][qi],
                        "question": batch["questions"][qi],
                        "top_ranking_passages": [
                            {"passage_id": docs[j]["passage_id"],
                             "content": docs[j]["content"], "score": float(row[j])}
                            for j in order
                        ],
                        "raw_top_ranking_passages": [
                            {"passage_id": d["passage_id"], "content": d["content"],
                             "score": float(d.get("score", 0.0))}
                            for d in docs
                        ],
                    }
                    if missing_static:
                        entry["static_retrieval_missing"] = True
                    if "answers" in batch:
                        entry["answers"] = batch["answers"][qi]
                        entry["gold_answer"] = batch["gold_answer"][qi]
                    if "pos_item_ids" in batch:
                        entry["pos_item_ids"] = batch["pos_item_ids"][qi]
                    batch_results.append(entry)

        data_dict = {"batch_retrieval_result": batch_results, "Ks": self.Ks}
        log_dict = self.compute_metrics(data_dict)
        log_dict["batch_retrieval_result"] = batch_results
        return log_dict
