"""RAG answer-generation executor (port of ``executors/rag_executor.py``).

The reference's ``RagBlipExecutor`` (`src/executors/RAG_BLIP_executor.py:71`)
as the JAX package made it work:

- training: the RAG-sequence marginal likelihood over each question's
  ``rag_num_docs`` retrieved docs, ``-log sum_k p(doc_k|q) p(answer|q,
  doc_k)``, one ``[B*K, L]`` forward (reference `:391-460`);
- generation: a greedy decode per retrieved doc with the teacher-forced
  loss of each doc's own generation (the reference's
  ``generation_outputs_for_docs`` / ``loss_with_doc_scores``, `:520-648`);
  the prediction is the lowest-loss doc's;
- generators: the native :class:`VisionSeq2SeqLM`, or ``backbone:
  "blip2"`` (ViT -> Q-Former -> Flan-T5), optionally from a
  ``decoder_checkpoint_dir``.

Static retrieval and the corpus come from :class:`RerankerExecutor`.
"""

from __future__ import annotations

import logging
import os
import random
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..models.bert import BertConfig
from ..models.blip2 import (Blip2Config, Blip2ForConditionalGeneration, Blip2QFormerConfig,
                            Blip2VisionConfig)
from ..models.checkpoint_dir import load_checkpoint_dir, load_into
from ..models.rerankers.decoder import DecoderRerankConfig, VisionSeq2SeqLM
from ..models.t5 import T5Config
from ..training.train_state import apply_update
from ..utils.config_system import ConfigDict
from ..utils.registries import register_executor
from .reranker_executor import RerankerExecutor

logger = logging.getLogger(__name__)


def greedy_decode_with_nll(decode_logits, enc_states, enc_mask, start_id: int, pad_id: int,
                           max_len: int):
    """Greedy decode and the teacher-forced NLL of the generated tokens over
    the same encoder states (JAX ``rag_executor.py:42-83``);
    ``decode_logits(tokens [B, L]) -> [B, L, V]``.

    A left-aligned buffer of ``max_len`` tokens, ``[start, pad, ...]``: step
    ``t`` takes the argmax of position ``t``'s logits (the first maximum on
    a tie) and writes it at ``t + 1``; under the causal mask position ``t``
    sees positions ``<= t`` only, so the pad filler is never attended. The
    generated tokens are rescored in the same layout ``[start, g_0 ..
    g_{L-2}]``. Each step recomputes the whole buffer (no key/value cache),
    as the JAX program does. Returns ``(labels [B, L], losses [B])``: each
    row's mean NLL over its non-pad generated tokens."""
    B, L = enc_states.shape[0], max_len
    tokens = torch.full((B, L), pad_id, dtype=torch.long, device=enc_states.device)
    tokens[:, 0] = start_id
    out = []
    for t in range(L):
        nxt = decode_logits(tokens)[:, t, :].argmax(dim=-1)
        if t + 1 < L:
            tokens[:, t + 1] = nxt
        out.append(nxt)
    labels = torch.stack(out, dim=1)
    dec_in = torch.cat([tokens[:, :1], labels[:, :-1]], dim=1)
    logp = F.log_softmax(decode_logits(dec_in).float(), dim=-1)
    tok_ll = logp.gather(-1, labels[..., None])[..., 0]
    label_mask = (labels != pad_id).float()
    denom = label_mask.sum(-1).clamp(min=1.0)
    return labels, -(tok_ll * label_mask).sum(-1) / denom


@register_executor
class RagExecutor(RerankerExecutor):
    """Static retrieval and corpus from :class:`RerankerExecutor`; scoring
    replaced by per-document answer generation. The generator is ``lm``."""

    def _init_model(self):
        mc = self.config.get_path("model_config", ConfigDict())
        self.modules = list(mc.get("modules", []))
        self.Ks = mc.get("Ks", [5])
        self.docs_to_rerank = mc.get("docs_to_rerank", 5)
        self.num_negative_samples = mc.get("num_negative_samples", 1)
        self.max_answer_length = mc.get("max_answer_length", 10)
        self.max_source_length = mc.get("max_source_length", 64)
        # docs marginalized over per training question (RAG-sequence K)
        self.rag_num_docs = mc.get("rag_num_docs", min(self.docs_to_rerank, 4))
        dec_kwargs = dict(mc.get("decoder", {}))
        self.backbone = dec_kwargs.pop("backbone", "native")
        gen = self.device_generator()
        if self.backbone == "blip2":
            self.generator_config = Blip2Config(
                vision_config=Blip2VisionConfig(**dec_kwargs.pop("vision_config", {})),
                qformer_config=Blip2QFormerConfig(**dec_kwargs.pop("qformer_config", {})),
                text_config=T5Config(**dec_kwargs.pop("text_config", {})),
                num_query_tokens=dec_kwargs.pop("num_query_tokens", 32))
            self.lm = Blip2ForConditionalGeneration(self.generator_config, device=self.device,
                                                    generator=gen)
            self.decoder_start_token_id = self.generator_config.text_config.decoder_start_token_id
        elif self.backbone == "native":
            self.generator_config = DecoderRerankConfig(
                text_config=BertConfig(**dec_kwargs.pop("text_config", {})), **dec_kwargs)
            self.lm = VisionSeq2SeqLM(self.generator_config, device=self.device, generator=gen)
            self.decoder_start_token_id = self.generator_config.decoder_start_token_id
        else:
            raise ValueError(f"model_config.decoder.backbone must be 'native' or 'blip2' for "
                             f"RAG, got {self.backbone!r}")
        self.retriever = None
        # the JAX executor's sampler seed, whatever meta.seed says
        self._rng = random.Random(42)
        self._setup_corpus()
        self.init_retrieve()
        ckpt_dir = mc.get("decoder_checkpoint_dir")
        if ckpt_dir and os.path.isdir(ckpt_dir) and self.backbone == "blip2":
            logger.info("loading the BLIP-2 generator from %s", ckpt_dir)
            load_into(self.lm, load_checkpoint_dir(ckpt_dir))
        self._train_state = None
        self._restored = None

    def trained_model(self) -> torch.nn.Module:
        return self.lm

    # ------------------------------------------------- generator dispatch
    def _vision_prefix(self, pixel_values):
        """Projected vision tokens, once per image."""
        return self.lm.vision_prefix(pixel_values)

    def _encode(self, input_ids, attention_mask, vision_prefix=None):
        """(encoder states, their mask) of either generator."""
        if self.backbone == "blip2":
            return self.lm.encode_for_generation(input_ids, attention_mask,
                                                 vision_prefix=vision_prefix)
        return self.lm.encode(input_ids, attention_mask, vision_prefix=vision_prefix)

    def _decode_logits(self, decoder_input_ids, enc_states, enc_mask):
        if self.backbone == "blip2":
            return self.lm.decode_logits(decoder_input_ids, enc_states, enc_mask)
        return self.lm.decode(decoder_input_ids, enc_states, enc_mask)[0]

    def _dev(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    # ------------------------------------------------------------- train
    def prepare_training(self, total_steps: int):
        self._create_train_state(total_steps)

    def rag_loss(self, batch) -> torch.Tensor:
        """The RAG-sequence marginal NLL of a training batch (JAX
        ``rag_executor.py:228-252``): ``-mean(logsumexp(log_softmax(doc_scores)
        + seq_ll))`` with ``seq_ll`` each doc's teacher-forced answer
        log-likelihood."""
        K = self.rag_num_docs
        pix = batch.get("pixel_values")  # [B, ...]: one per image
        prefix = (torch.repeat_interleave(self._vision_prefix(pix), K, dim=0)
                  if pix is not None else None)
        enc_states, enc_mask = self._encode(batch["input_ids"], batch["attention_mask"],
                                            vision_prefix=prefix)
        logits = self._decode_logits(batch["decoder_input_ids"], enc_states, enc_mask)
        logp = F.log_softmax(logits.float(), dim=-1)
        tok_ll = logp.gather(-1, batch["labels"][..., None])[..., 0]
        seq_ll = (tok_ll * batch["label_mask"]).sum(-1).reshape(-1, K)
        log_prior = F.log_softmax(batch["doc_scores"].float(), dim=-1)
        return -torch.logsumexp(log_prior + seq_ll, dim=-1).mean()

    def _answer_labels(self, tok, texts: List[str]):
        enc = tok(list(texts), padding="max_length", truncation=True,
                  max_length=self.max_answer_length, return_tensors="np")
        labels = np.asarray(enc["input_ids"], np.int64)
        mask = np.asarray(enc["attention_mask"], np.float32)
        start = np.full((labels.shape[0], 1), self.decoder_start_token_id, np.int64)
        return labels, mask, np.concatenate([start, labels[:, :-1]], axis=1)

    def training_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A training batch's tensors (JAX ``rag_executor.py:259-315``): the
        prompts ``"question: {q} context: {d}"`` of each question's first
        ``rag_num_docs`` docs, their scores, and the gold answer's labels
        repeated over the docs."""
        tok = getattr(self.tokenizers.get("decoder_tokenizer"), "tok", None)
        K = self.rag_num_docs
        n = len(batch["question_ids"])
        prompts, scores = [], []
        for qi, qid in enumerate(batch["question_ids"]):
            docs = self.static_retrieve(qid)[:K]
            while docs and len(docs) < K:
                docs = docs + docs[: K - len(docs)]
            if not docs:
                docs = [{"content": "", "score": 0.0}] * K
            prompts.extend(f"question: {batch['questions'][qi]} context: {d['content']}"
                           for d in docs)
            scores.append([float(d.get("score", 1.0)) for d in docs])
        enc = tok(prompts, padding="max_length", truncation=True,
                  max_length=self.max_source_length, return_tensors="np")
        gold = [g or (a[0] if a else "")
                for g, a in zip(batch.get("gold_answer", [""] * n),
                                batch.get("answers", [[]] * n))]
        labels, label_mask, dec_in = self._answer_labels(tok, gold)
        out = dict(input_ids=self._dev(enc["input_ids"], torch.long),
                   attention_mask=self._dev(enc["attention_mask"], torch.long),
                   decoder_input_ids=self._dev(np.repeat(dec_in, K, axis=0)),
                   labels=self._dev(np.repeat(labels, K, axis=0)),
                   label_mask=self._dev(np.repeat(label_mask, K, axis=0)),
                   doc_scores=self._dev(scores, torch.float32))
        if batch.get("pixel_values") is not None:
            out["pixel_values"] = self._dev(batch["pixel_values"], torch.float32)
        return out

    def training_step(self, batch) -> Dict[str, float]:
        self.lm.train()
        loss = self.rag_loss(self.training_batch(batch))
        # like the JAX step: no NaN guard, every step updates
        apply_update(self._train_state, loss, guard=False)
        return {"loss": float(loss.detach())}

    # -------------------------------------------------------------- eval
    def generate_with_losses(self, input_ids, attention_mask, pixel_values):
        """(tokens, each doc's NLL of its own generation) with one encoder
        pass feeding the greedy decode and the teacher-forced loss (JAX
        ``rag_executor.py:317-355``). ``pixel_values``: one image for all
        the rows, or None."""
        pad_id = getattr(getattr(self.tokenizers.get("decoder_tokenizer"), "tok", None),
                         "pad_token_id", 0) or 0
        self.lm.eval()
        with torch.inference_mode():
            prefix = None
            if pixel_values is not None:
                prefix = torch.repeat_interleave(self._vision_prefix(pixel_values),
                                                 input_ids.shape[0] // pixel_values.shape[0],
                                                 dim=0)
            enc_states, enc_mask = self._encode(input_ids, attention_mask, vision_prefix=prefix)
            tokens, losses = greedy_decode_with_nll(
                lambda toks: self._decode_logits(toks, enc_states, enc_mask),
                enc_states, enc_mask, self.decoder_start_token_id, pad_id,
                self.max_answer_length)
        return tokens.cpu().numpy(), losses.cpu().numpy()

    def evaluate(self, mode: str = "test") -> ConfigDict:
        """Per question: generate an answer from each of its first
        ``docs_to_rerank`` docs, keep the lowest-loss doc's as the
        prediction, and score with the config's metrics (JAX
        ``rag_executor.py:357-433``)."""
        tok = getattr(self.tokenizers.get("decoder_tokenizer"), "tok", None)
        limit = self.config.get_path(
            f"{mode}.trainer_paras.limit_{'val' if mode == 'valid' else 'test'}_batches")
        results: List[dict] = []
        for name, loader in self.eval_dataloaders(mode).items():
            for bi, batch in enumerate(loader):
                if limit and bi >= limit:
                    break
                real = batch.get("_real_count", len(batch["question_ids"]))
                pix_all = batch.get("pixel_values")
                for qi in range(real):
                    qid = batch["question_ids"][qi]
                    docs = self.static_retrieve(qid)[: self.docs_to_rerank]
                    prompts = [f"question: {batch['questions'][qi]} context: {d['content']}"
                               for d in docs] or [f"question: {batch['questions'][qi]}"]
                    enc = tok(prompts, padding="max_length", truncation=True,
                              max_length=self.max_source_length, return_tensors="np")
                    pix = (None if pix_all is None
                           else self._dev(np.asarray(pix_all)[qi:qi + 1], torch.float32))
                    out_tokens, losses = self.generate_with_losses(
                        self._dev(enc["input_ids"], torch.long),
                        self._dev(enc["attention_mask"], torch.long), pix)
                    answers = [tok.decode(t, skip_special_tokens=True) for t in out_tokens]
                    best = int(np.argmin(losses)) if len(losses) else 0
                    results.append({
                        "question_id": qid,
                        "prediction": answers[best] if answers else "",
                        "per_doc_predictions": answers,
                        "loss_with_doc_scores": [float(x) for x in losses],
                        "doc_scores": [float(d.get("score", 1.0)) for d in docs],
                        "retrieved_docs": docs,
                        "answers": batch.get("answers", [[]] * real)[qi],
                        # Infoseek numeric-answer range (reference
                        # `RAG_BLIP_executor.py:643`)
                        "numeric_range": batch.get("wikidata_ranges", [None] * real)[qi],
                    })
        data_dict = {
            "predictions": [r["prediction"] for r in results],
            "answers": [r["answers"] for r in results],
            "batch_answers": [r["answers"] for r in results],
            "batch_question_ids": [r["question_id"] for r in results],
            "batch_retrieved_docs": [r["retrieved_docs"] for r in results],
            "batch_generation_outputs_for_docs": [r["per_doc_predictions"] for r in results],
            "batch_loss_with_doc_scores": [r["loss_with_doc_scores"] for r in results],
            "batch_numeric_ranges": [r["numeric_range"] for r in results],
            "batch_predictions": [{"question_id": r["question_id"], "answer": r["prediction"]}
                                  for r in results],
            "batch_retrieval_result": results,
            "Ks": self.Ks,
        }
        log_dict = self.compute_metrics(data_dict)
        log_dict["batch_retrieval_result"] = results
        return log_dict
