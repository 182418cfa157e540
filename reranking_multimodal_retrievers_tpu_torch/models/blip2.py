"""BLIP-2 (vision encoder + Q-Former + T5 or OPT LM) in PyTorch (port of
``models/blip2.py``).

HuggingFace ``Blip2ForConditionalGeneration`` structure and parameter names
(``vision_model.encoder.layers.{i}.self_attn.qkv``,
``qformer.encoder.layer.{i}.crossattention``, ``query_tokens``,
``language_projection``, ``language_model``) with the JAX package's
semantics:

- vision: a ViT with no pre-layernorm, fused-qkv attention (plain PyTorch,
  as the JAX package never calls its kernel here: ViT-g's head_dim is 88),
  pre-LN blocks with exact GELU and a post-layernorm over the sequence;
- Q-Former: learned query tokens with BERT-style post-LN self-attention,
  cross-attention to the image features every ``cross_attention_frequency``
  layers and the ``*_query`` FFN (the text branch is not used);
- ``language_projection`` maps the query outputs into the LM's embedding
  space, and they are prepended to the prompt's embeddings.

The LM is the port's :class:`~.t5.T5ForConditionalGeneration` or
:class:`~.opt.OPTForCausalLM`, chosen by the type of ``text_config``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from .init import materialize_
from .opt import OPTConfig, OPTForCausalLM
from .t5 import T5Config, T5ForConditionalGeneration

INIT_STD = 0.02


@dataclasses.dataclass(frozen=True)
class Blip2VisionConfig:
    hidden_size: int = 1408
    intermediate_size: int = 6144
    num_hidden_layers: int = 39
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                        num_attention_heads=4, image_size=32, patch_size=8)
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass(frozen=True)
class Blip2QFormerConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    encoder_hidden_size: int = 1408  # vision hidden size
    cross_attention_frequency: int = 2
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=32, encoder_hidden_size=16)
        defaults.update(kw)
        return cls(**defaults)


@dataclasses.dataclass(frozen=True)
class Blip2Config:
    """``text_config`` selects the LM: a :class:`~.t5.T5Config`
    (``blip2-flan-t5-*``) or an :class:`~.opt.OPTConfig` (``blip2-opt-*``)."""

    vision_config: Blip2VisionConfig = dataclasses.field(default_factory=Blip2VisionConfig)
    qformer_config: Blip2QFormerConfig = dataclasses.field(default_factory=Blip2QFormerConfig)
    text_config: object = dataclasses.field(default_factory=T5Config)
    num_query_tokens: int = 32

    @property
    def use_decoder_only_language_model(self) -> bool:
        return isinstance(self.text_config, OPTConfig)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vision_config=Blip2VisionConfig.tiny(),
                        qformer_config=Blip2QFormerConfig.tiny(),
                        text_config=T5Config.tiny(), num_query_tokens=4)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny_opt(cls, **kw):
        return cls.tiny(**{"text_config": OPTConfig.tiny(), **kw})


class Blip2VisionEmbeddings(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        H = cfg.hidden_size
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.empty(1, 1, H))
        self.patch_embedding = nn.Conv2d(3, H, cfg.patch_size, stride=cfg.patch_size)
        self.position_embedding = nn.Parameter(torch.empty(1, n_patches + 1, H))

    def forward(self, pixel_values):
        B = pixel_values.shape[0]
        w = self.patch_embedding.weight
        patches = self.patch_embedding(pixel_values.to(w.dtype)).flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(B, -1, -1).to(patches.dtype), patches], dim=1)
        return x + self.position_embedding[:, : x.shape[1]].to(x.dtype)


class Blip2Attention(nn.Module):
    """Fused-qkv ViT attention (HF ``Blip2Attention``), plain PyTorch."""

    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        self.config = cfg
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.projection = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        cfg = self.config
        B, L, H = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        qkv = self.qkv(x).view(B, L, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * (hd ** -0.5)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(x.dtype)
        return self.projection(ctx.reshape(B, L, H))


class Blip2MLP(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Blip2EncoderLayer(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        self.self_attn = Blip2Attention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = Blip2MLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class Blip2Encoder(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(Blip2EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))


class Blip2VisionModel(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        self.embeddings = Blip2VisionEmbeddings(cfg)
        self.encoder = Blip2Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values):
        x = self.embeddings(pixel_values)
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x)


class Blip2QFormerMultiHeadAttention(nn.Module):
    def __init__(self, cfg: Blip2QFormerConfig, kv_size: int):
        super().__init__()
        H = cfg.hidden_size
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(kv_size, H)
        self.value = nn.Linear(kv_size, H)


class Blip2QFormerSelfOutput(nn.Module):
    def __init__(self, cfg: Blip2QFormerConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class Blip2QFormerAttention(nn.Module):
    """BERT-style post-LN attention over the queries or external states."""

    def __init__(self, cfg: Blip2QFormerConfig, kv_size: Optional[int] = None):
        super().__init__()
        self.config = cfg
        self.attention = Blip2QFormerMultiHeadAttention(cfg, kv_size or cfg.hidden_size)
        self.output = Blip2QFormerSelfOutput(cfg)

    def forward(self, x, kv=None):
        cfg = self.config
        B, Lq, H = x.shape
        kv_in = x if kv is None else kv
        Lk = kv_in.shape[1]
        hd = cfg.head_dim
        a = self.attention
        q = a.query(x)
        nh = q.shape[-1] // hd  # this device's heads (all, or its tensor-parallel share)
        q = q.view(B, Lq, nh, hd)
        k = a.key(kv_in).view(B, Lk, nh, hd)
        v = a.value(kv_in).view(B, Lk, nh, hd)
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(x.dtype)
        return self.output.LayerNorm(self.output.dense(ctx.reshape(B, Lq, nh * hd)) + x)


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)


class _DenseNorm(_Dense):
    def __init__(self, n_in: int, n_out: int, eps: float):
        super().__init__(n_in, n_out)
        self.LayerNorm = nn.LayerNorm(n_out, eps=eps)


class Blip2QFormerLayer(nn.Module):
    def __init__(self, cfg: Blip2QFormerConfig, has_cross_attention: bool):
        super().__init__()
        self.attention = Blip2QFormerAttention(cfg)
        self.crossattention = (Blip2QFormerAttention(cfg, cfg.encoder_hidden_size)
                               if has_cross_attention else None)
        self.intermediate_query = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output_query = _DenseNorm(cfg.intermediate_size, cfg.hidden_size,
                                       cfg.layer_norm_eps)

    def forward(self, x, image_embeds):
        x = self.attention(x)
        if self.crossattention is not None:
            x = self.crossattention(x, kv=image_embeds)
        h = F.gelu(self.intermediate_query.dense(x))
        out = self.output_query
        return out.LayerNorm(out.dense(h) + x)


class Blip2QFormerEncoder(nn.Module):
    def __init__(self, cfg: Blip2QFormerConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            Blip2QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0)
            for i in range(cfg.num_hidden_layers))


class Blip2QFormerModel(nn.Module):
    """Query-token branch of the HF ``Blip2QFormerModel``."""

    def __init__(self, cfg: Blip2QFormerConfig):
        super().__init__()
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = Blip2QFormerEncoder(cfg)

    def forward(self, query_tokens, image_embeds):
        x = self.layernorm(query_tokens.expand(image_embeds.shape[0], -1, -1))
        for layer in self.encoder.layer:
            x = layer(x, image_embeds)
        return x


class Blip2ForConditionalGeneration(nn.Module):
    """Vision -> Q-Former -> language_projection -> T5 or OPT. Built on
    ``device`` (CUDA by default) with weights drawn from ``generator``;
    ``device="meta"`` builds it for a parent that materialises it."""

    def __init__(self, config: Blip2Config, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        tc = cfg.text_config
        with torch.device("meta"):
            self.vision_model = Blip2VisionModel(cfg.vision_config)
            self.query_tokens = nn.Parameter(
                torch.empty(1, cfg.num_query_tokens, cfg.qformer_config.hidden_size))
            self.qformer = Blip2QFormerModel(cfg.qformer_config)
            if cfg.use_decoder_only_language_model:
                # the prefix is added to inputs_embeds, which OPT's project_in
                # would map: the BLIP-2 + OPT path needs embed_dim == hidden_size
                if tc.embed_dim != tc.hidden_size:
                    raise ValueError("Blip2+OPT requires word_embed_proj_dim == hidden_size")
                self.language_projection = nn.Linear(cfg.qformer_config.hidden_size,
                                                     tc.hidden_size)
                self.language_model = OPTForCausalLM(tc, device="meta")
            else:
                self.language_projection = nn.Linear(cfg.qformer_config.hidden_size,
                                                     tc.d_model)
                self.language_model = T5ForConditionalGeneration(tc, device="meta")
        materialize_(self, device, dtype, generator, INIT_STD)

    def _text_embeds(self, input_ids):
        lm = self.language_model
        return (lm.embed_tokens if self.config.use_decoder_only_language_model
                else lm.shared)(input_ids)

    def vision_prefix(self, pixel_values):
        """[B, num_query_tokens, LM width] projected Q-Former outputs."""
        image_embeds = self.vision_model(pixel_values)
        return self.language_projection(self.qformer(self.query_tokens, image_embeds))

    def _prepend_vision_prefix(self, text_embeds, attention_mask, pixel_values,
                               vision_prefix):
        """[vision prefix ; text] embeddings and the combined mask.
        ``vision_prefix`` (computed once per image) skips the vision model
        and Q-Former."""
        if vision_prefix is None and pixel_values is not None:
            vision_prefix = self.vision_prefix(pixel_values)
        if vision_prefix is None:
            return text_embeds, attention_mask
        inputs_embeds = torch.cat([vision_prefix.to(text_embeds.dtype), text_embeds], dim=1)
        prefix_mask = torch.ones(vision_prefix.shape[:2], dtype=attention_mask.dtype,
                                 device=attention_mask.device)
        return inputs_embeds, torch.cat([prefix_mask, attention_mask], dim=1)

    def encode_for_generation(self, input_ids, attention_mask, pixel_values=None,
                              vision_prefix=None):
        """T5 encoder states and mask with the vision prefix prepended."""
        inputs_embeds, attention_mask = self._prepend_vision_prefix(
            self._text_embeds(input_ids), attention_mask, pixel_values, vision_prefix)
        enc = self.language_model.encode(inputs_embeds=inputs_embeds,
                                         attention_mask=attention_mask)
        return enc, attention_mask

    def causal_lm_logits(self, input_ids, attention_mask, pixel_values=None,
                         vision_prefix=None):
        """Decoder-only (OPT): ``(logits, hidden, full_mask)`` over
        [vision prefix ; prompt]."""
        _, hidden, attention_mask = self.causal_lm_hidden(
            input_ids, attention_mask, pixel_values, vision_prefix)
        return self.language_model.lm_logits(hidden), hidden, attention_mask

    def causal_lm_hidden(self, input_ids, attention_mask, pixel_values=None,
                         vision_prefix=None):
        """Decoder-only hidden states without the vocabulary projection:
        ``(None, hidden, full_mask)``."""
        if not self.config.use_decoder_only_language_model:
            raise ValueError("causal_lm_hidden needs an OPT language model")
        inputs_embeds, attention_mask = self._prepend_vision_prefix(
            self._text_embeds(input_ids), attention_mask, pixel_values, vision_prefix)
        hidden = self.language_model.hidden_states(inputs_embeds=inputs_embeds,
                                                   attention_mask=attention_mask)
        return None, hidden, attention_mask

    def causal_last_hidden(self, input_ids, attention_mask, pixel_values=None,
                           vision_prefix=None):
        """[B, H]: the hidden state at each row's last real prompt position,
        ``prefix_len + sum(mask) - 1`` (right-padded rows score at their own
        final token)."""
        _, hidden, _ = self.causal_lm_hidden(input_ids, attention_mask, pixel_values,
                                             vision_prefix)
        prefix_len = hidden.shape[1] - input_ids.shape[1]
        last = prefix_len + attention_mask.long().sum(dim=1) - 1
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]

    def decode_logits(self, decoder_input_ids, enc_states, enc_attention_mask):
        """Per-position T5 decoder logits over a fixed-length token buffer."""
        logits, _ = self.language_model.decode(decoder_input_ids, enc_states,
                                               enc_attention_mask)
        return logits

    def forward(self, input_ids, attention_mask, decoder_input_ids, pixel_values=None,
                vision_prefix=None):
        enc, attention_mask = self.encode_for_generation(
            input_ids, attention_mask, pixel_values, vision_prefix)
        return self.language_model.decode(decoder_input_ids, enc, attention_mask)
