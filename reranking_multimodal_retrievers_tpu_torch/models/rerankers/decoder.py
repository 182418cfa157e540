"""monoBLIP-2 decoder rerankers in PyTorch (port of
``models/rerankers/decoder.py``).

The reference scores (query, document) pairs with a vision-conditioned LM:

- Model A (``DecoderRerankModel``, ``Blip2DecoderRerankModel``): prompt
  ``"Query: {q} Document: {d} Relevant:"``; loss = CE of the "yes"/"no"
  target at the first decoder position (T5) or the last prompt position
  (OPT); ranking score = softmax(yes, no)[yes].
- Model B (``DecoderHeadRerankModel``, ``Blip2DecoderHeadRerankModel``):
  two bias-free linear heads over that hidden state, scored through the
  shared rerank loss vocabulary (``losses.py``).

``VisionSeq2SeqLM`` is the JAX package's compact backbone (CLIP-ViT CLS ->
prefix tokens, a BERT encoder and a causal BERT decoder with cross-attention
and LoRA on its FFN) over the port's BERT and CLIP ViT; its causal bias
takes the port's unfused BERT attention. The BLIP-2 models run on the port's
``Blip2ForConditionalGeneration`` (Flan-T5 or OPT); the vision prefix is
computed once per image and broadcast over the candidates
(``vision_feats``), and the OPT branch projects only each row's last prompt
position through the vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import DeviceLike
from ..bert import BertAttention, BertConfig, BertLayer, additive_mask, ATTN_MASK_BIAS
from ..blip2 import Blip2Config, Blip2ForConditionalGeneration
from ..init import materialize_
from ..lora import linear
from ..vit import CLIPVisionConfig, CLIPVisionModel
from .losses import prepare_logits_labels, primary_logits, rerank_loss

POSITIVE_LABEL = "yes"
NEGATIVE_LABEL = "no"
GENERATION_TOKEN = "<GEN>"


@dataclasses.dataclass(frozen=True)
class DecoderRerankConfig:
    text_config: BertConfig = dataclasses.field(default_factory=BertConfig)
    vision_config: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    num_decoder_layers: int = 2
    vision_prefix_length: int = 8
    lora_r: int = 8
    lora_alpha: float = 32.0
    yes_token_id: int = 0
    no_token_id: int = 1
    gen_token_id: int = 2
    decoder_start_token_id: int = 0
    loss_fn: str = "BCE"
    pos_weight: Optional[float] = None

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(text_config=BertConfig.tiny(), vision_config=CLIPVisionConfig.tiny(),
                        num_decoder_layers=1, vision_prefix_length=2, yes_token_id=10,
                        no_token_id=11, gen_token_id=12)
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass(frozen=True)
class Blip2RerankConfig:
    """``yes/no_token_id`` come from the BLIP-2 processor's tokenizer (for
    the T5 tokenizer: yes = 4273, no = 150)."""

    blip2: Optional[Blip2Config] = None
    yes_token_id: int = 4273
    no_token_id: int = 150
    loss_fn: str = "BCE"
    pos_weight: Optional[float] = None

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(blip2=Blip2Config.tiny(), yes_token_id=10, no_token_id=11)
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass
class DecoderRerankOutput:
    loss: torch.Tensor
    logits: torch.Tensor  # [expanded, 1]: p(yes) for Model A, head logits for B


class _DecoderLayer(nn.Module):
    """Causal self-attention + cross-attention + FFN (post-LN residuals)."""

    def __init__(self, cfg: BertConfig, lora_r: int, lora_alpha: float):
        super().__init__()
        self.self_attention = BertAttention(cfg)
        self.cross_attention = BertAttention(cfg)
        self.intermediate = linear(cfg.hidden_size, cfg.intermediate_size, r=lora_r,
                                   alpha=lora_alpha)
        self.output = linear(cfg.intermediate_size, cfg.hidden_size, r=lora_r,
                             alpha=lora_alpha)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, causal_bias, enc_states, enc_bias):
        x = self.self_attention(x, mask_bias=causal_bias)
        x = self.cross_attention(x, kv_states=enc_states, mask_bias=enc_bias)
        h = self.output(F.gelu(self.intermediate(x)))
        return self.layernorm(h + x)


class VisionSeq2SeqLM(nn.Module):
    """Compact vision-conditioned encoder-decoder LM with LoRA adapters.
    Built on ``device`` (CUDA by default) with weights drawn from
    ``generator``; ``device="meta"`` builds it for a parent that
    materialises it."""

    def __init__(self, config: DecoderRerankConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        tc = cfg.text_config
        with torch.device("meta"):
            self.vision_encoder = CLIPVisionModel(cfg.vision_config, device="meta")
            self.vision_projection = nn.Linear(cfg.vision_config.hidden_size,
                                               tc.hidden_size * cfg.vision_prefix_length)
            self.embed = nn.Embedding(tc.vocab_size, tc.hidden_size)
            self.pos_embed = nn.Embedding(tc.max_position_embeddings, tc.hidden_size)
            self.encoder_layers = nn.ModuleList(
                BertLayer(tc) for _ in range(tc.num_hidden_layers))
            self.decoder_layers = nn.ModuleList(
                _DecoderLayer(tc, cfg.lora_r, cfg.lora_alpha)
                for _ in range(cfg.num_decoder_layers))
            self.final_norm = nn.LayerNorm(tc.hidden_size, eps=tc.layer_norm_eps)
            self.lm_head = nn.Linear(tc.hidden_size, tc.vocab_size, bias=False)
        materialize_(self, device, dtype, generator, tc.initializer_range)

    def vision_prefix(self, pixel_values):
        """[B, vision_prefix_length, H] projected vision tokens."""
        vis = self.vision_encoder(pixel_values)["last_hidden_state"][:, 0]
        return self.vision_projection(vis).reshape(
            pixel_values.shape[0], self.config.vision_prefix_length, -1)

    def _embed(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.embed(ids) + self.pos_embed(pos)[None]

    def encode(self, input_ids, attention_mask, pixel_values=None, vision_prefix=None):
        x = self._embed(input_ids)
        if vision_prefix is None and pixel_values is not None:
            vision_prefix = self.vision_prefix(pixel_values)
        if vision_prefix is not None:
            x = torch.cat([vision_prefix.to(x.dtype), x], dim=1)
            ones = torch.ones(x.shape[0], self.config.vision_prefix_length,
                              dtype=attention_mask.dtype, device=attention_mask.device)
            attention_mask = torch.cat([ones, attention_mask], dim=1)
        bias = additive_mask(attention_mask)
        for layer in self.encoder_layers:
            x = layer(x, mask_bias=bias)
        return x, attention_mask

    def decode(self, decoder_input_ids, enc_states, enc_attention_mask):
        L = decoder_input_ids.shape[1]
        x = self._embed(decoder_input_ids)
        causal = torch.tril(torch.ones(L, L, device=x.device))
        causal_bias = (1.0 - causal)[None, None] * ATTN_MASK_BIAS
        enc_bias = additive_mask(enc_attention_mask)
        for layer in self.decoder_layers:
            x = layer(x, causal_bias, enc_states, enc_bias)
        x = self.final_norm(x)
        return self.lm_head(x), x  # (logits, hidden)

    def forward(self, input_ids, attention_mask, decoder_input_ids, pixel_values=None):
        enc_states, enc_mask = self.encode(input_ids, attention_mask, pixel_values)
        return self.decode(decoder_input_ids, enc_states, enc_mask)


def _group_labels(labels, expanded: int, nway: int, device) -> torch.Tensor:
    if labels is None:
        group = torch.zeros(nway, dtype=torch.long, device=device)
        group[0] = 1
        return group.repeat(expanded // nway)
    return torch.as_tensor(labels, device=device).long().reshape(-1)


def yes_no_scores(first: torch.Tensor, labels: torch.Tensor, yes: int, no: int,
                  nway: int) -> DecoderRerankOutput:
    """CE of the yes/no target over the full vocabulary row ``first``
    ([rows, V] fp32), and p(yes) = softmax(yes, no)[yes] as ``[rows, 1]``."""
    lbl = _group_labels(labels, first.shape[0], nway, first.device)
    target = torch.where(lbl == 1, yes, no)
    loss = (torch.logsumexp(first, dim=-1) - first.gather(1, target[:, None])[:, 0]).mean()
    p_yes = torch.softmax(torch.stack([first[:, yes], first[:, no]], dim=-1), dim=-1)[:, 0:1]
    return DecoderRerankOutput(loss=loss, logits=p_yes)


class DecoderRerankModel(nn.Module):
    """Model A: yes/no probability scoring (reference
    `decoder_rerank_model.py:121-159`). Built on ``device`` (CUDA by
    default) with weights drawn from ``generator``."""

    def __init__(self, config: DecoderRerankConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self._build()
        materialize_(self, device, dtype, generator, config.text_config.initializer_range)

    def _build(self):
        self.model = VisionSeq2SeqLM(self.config, device="meta")

    def _hidden_and_logits(self, input_ids, attention_mask, pixel_values, nway):
        cfg = self.config
        pix = (torch.repeat_interleave(pixel_values, nway, dim=0)
               if pixel_values is not None else None)
        dec_in = torch.full((input_ids.shape[0], 1), cfg.decoder_start_token_id,
                            dtype=torch.long, device=input_ids.device)
        return self.model(input_ids, attention_mask, dec_in, pixel_values=pix)

    def forward(self, input_ids, attention_mask, pixel_values, num_negative_examples: int,
                labels=None):
        """``input_ids``: tokenised prompts, one row per (query, candidate);
        ``labels``: optional [B*(N+1)] binary relevance (default: the first
        doc of each group is the positive)."""
        cfg = self.config
        nway = num_negative_examples + 1
        logits, _ = self._hidden_and_logits(input_ids, attention_mask, pixel_values, nway)
        return yes_no_scores(logits[:, 0, :].float(), labels, cfg.yes_token_id,
                             cfg.no_token_id, nway)


def _two_heads(model, rel, cfg, batch_size, num_negative_examples, labels):
    logits, lbl = prepare_logits_labels(cfg.loss_fn, model.classifier1(rel),
                                        model.classifier2(rel), batch_size,
                                        num_negative_examples, labels)
    loss = rerank_loss(cfg.loss_fn, logits, lbl, cfg.pos_weight)
    return DecoderRerankOutput(loss=loss, logits=primary_logits(cfg.loss_fn, logits))


class DecoderHeadRerankModel(DecoderRerankModel):
    """Model B: two heads over the first decoder step's hidden state
    (reference `:208-247`)."""

    def _build(self):
        super()._build()
        H = self.config.text_config.hidden_size
        self.classifier1 = nn.Linear(H, 1, bias=False)
        self.classifier2 = nn.Linear(H, 1, bias=False)

    def forward(self, input_ids, attention_mask, pixel_values, num_negative_examples: int,
                labels=None):
        nway = num_negative_examples + 1
        _, hidden = self._hidden_and_logits(input_ids, attention_mask, pixel_values, nway)
        return _two_heads(self, hidden[:, 0], self.config, input_ids.shape[0] // nway,
                          num_negative_examples, labels)


class Blip2DecoderRerankModel(nn.Module):
    """Model A on the BLIP-2 backbone (vision + Q-Former + Flan-T5 or OPT,
    LoRA through ``text_config.lora_r``), the reference's best reranker.

    The vision prefix is computed once per image (``encode_vision``) and
    passed as ``vision_feats``, broadcast over the candidates, instead of
    repeating the pixels per candidate."""

    def __init__(self, config: Blip2RerankConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self._build()
        materialize_(self, device, dtype, generator, 0.02)

    def _build(self):
        self.model = Blip2ForConditionalGeneration(self.config.blip2, device="meta")

    def encode_vision(self, pixel_values):
        """[B, num_query_tokens, LM width] projected Q-Former prefix."""
        return self.model.vision_prefix(pixel_values)

    def _prefix(self, pixel_values, vision_feats, nway):
        if vision_feats is not None:
            return vision_feats
        if pixel_values is not None:
            return torch.repeat_interleave(self.model.vision_prefix(pixel_values), nway, dim=0)
        return None

    def decoder_start(self, rows: int, device) -> torch.Tensor:
        """[rows, 1] T5 decoder input: the start token."""
        return torch.full((rows, 1), self.config.blip2.text_config.decoder_start_token_id,
                          dtype=torch.long, device=device)

    def first_logits(self, input_ids, attention_mask, vision_prefix=None):
        """[rows, V] fp32 logits of the position that predicts yes/no: the
        first decoder step (T5), or each row's last real prompt position
        (OPT), whose hidden state alone is projected through the vocabulary."""
        m = self.model
        if self.config.blip2.use_decoder_only_language_model:
            rel = m.causal_last_hidden(input_ids, attention_mask, vision_prefix=vision_prefix)
            return m.language_model.lm_logits(rel[:, None, :])[:, 0, :].float()
        enc, enc_mask = m.encode_for_generation(input_ids, attention_mask,
                                                vision_prefix=vision_prefix)
        return self.first_decode_logits(enc, enc_mask)

    def first_decode_logits(self, enc_states, enc_attention_mask):
        """T5: [rows, V] fp32 logits of the first decoder step over encoder
        states (which may come from several encoder calls)."""
        dec_in = self.decoder_start(enc_states.shape[0], enc_states.device)
        return self.model.decode_logits(dec_in, enc_states, enc_attention_mask)[:, 0, :].float()

    def forward(self, input_ids, attention_mask, pixel_values, num_negative_examples: int,
                labels=None, vision_feats=None):
        cfg = self.config
        nway = num_negative_examples + 1
        prefix = self._prefix(pixel_values, vision_feats, nway)
        return yes_no_scores(self.first_logits(input_ids, attention_mask, prefix), labels,
                             cfg.yes_token_id, cfg.no_token_id, nway)


class Blip2DecoderHeadRerankModel(Blip2DecoderRerankModel):
    """Model B on the BLIP-2 backbone (the monoBLIP2-*_pointwise configs):
    two heads over the hidden state at the last real prompt position (OPT)
    or the first decoder step (T5)."""

    def _build(self):
        super()._build()
        tc = self.config.blip2.text_config
        H = tc.hidden_size if self.config.blip2.use_decoder_only_language_model else tc.d_model
        self.classifier1 = nn.Linear(H, 1, bias=False)
        self.classifier2 = nn.Linear(H, 1, bias=False)

    def forward(self, input_ids, attention_mask, pixel_values, num_negative_examples: int,
                labels=None, vision_feats=None):
        cfg = self.config
        nway = num_negative_examples + 1
        prefix = self._prefix(pixel_values, vision_feats, nway)
        m = self.model
        if cfg.blip2.use_decoder_only_language_model:
            rel = m.causal_last_hidden(input_ids, attention_mask, vision_prefix=prefix)
        else:
            dec_in = self.decoder_start(input_ids.shape[0], input_ids.device)
            _, hidden = m(input_ids, attention_mask, dec_in, vision_prefix=prefix)
            rel = hidden[:, 0]
        return _two_heads(self, rel, cfg, input_ids.shape[0] // nway, num_negative_examples,
                          labels)


def prepare_decoder_rerank_inputs(query_text_sequences, context_text_sequences, tokenizer,
                                  max_query_length: int, max_context_length: int,
                                  max_decoder_source_length: int, docs_per_query: int,
                                  generation_token: bool = False):
    """Host-side prompt construction (reference ``prepare_decoder_inputs``,
    `utils.py:169-205`): ``"Query: {q}"`` and ``"Document: {d}"`` truncated to
    their budgets, joined with ``" Relevant:"`` (Model A) or the ``<GEN>``
    token (Model B). ``tokenizer`` is any object with the HF tokenizer's
    ``encode``, ``decode`` and ``__call__``."""
    tq = [tokenizer.decode(tokenizer.encode(f"Query: {t}", add_special_tokens=False)
                           [:max_query_length]) for t in query_text_sequences]
    tc = [tokenizer.decode(tokenizer.encode(f"Document: {t}", add_special_tokens=False)
                           [:max_context_length]) for t in context_text_sequences]
    suffix = f" {GENERATION_TOKEN}" if generation_token else " Relevant:"
    prompts = [f"{tq[i]} {tc[i * docs_per_query + j]}{suffix}"
               for i in range(len(tq)) for j in range(docs_per_query)]
    enc = tokenizer(prompts, padding="max_length", truncation=True,
                    max_length=max_decoder_source_length, return_tensors="np")
    return {"input_ids": enc["input_ids"].astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32)}
