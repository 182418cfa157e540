"""OPT decoder-only causal LM in PyTorch (port of ``models/opt.py``).

HuggingFace ``OPTForCausalLM`` structure and parameter names
(``model.decoder.layers.{i}.self_attn.q_proj``, ``...fc1``, the head tied
to ``model.decoder.embed_tokens``) with the JAX package's semantics:

- learned positions with OPT's offset of 2, derived from the attention mask
  (``cumsum(mask) * mask - 1``), so padded rows use embedding row 1;
- pre-LN blocks (``do_layer_norm_before``, opt-2.7b) or post-LN (opt-350m);
  biased projections; q scaled by ``head_dim ** -0.5``; optional
  ``project_in``/``project_out`` when ``word_embed_proj_dim`` differs;
- LoRA (``lora_r``) on q_proj and v_proj;
- ``use_pallas_attention``: on the card, self-attention goes through kernel
  K2 (``ops/attention_cuda.py``) with its in-kernel causal mask, the padding
  mask as its [B, L] key bias and ``sm_scale = head_dim ** -0.5``, whenever
  a key mask is given (the JAX package's TPU gate also asks for L % 8 == 0
  and a packable head geometry, limits of its kernel that K2 does not
  have). On the CPU the unfused path runs, as the JAX package's does off a
  TPU;
- ``quantize_int8``: every projection, FFN and the tied head W8A8
  (``ops/quant.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from ..ops.attention_cuda import fused_self_attention
from ..ops.quant import Int8Linear, int8_dot
from .bert import ATTN_MASK_BIAS
from .init import materialize_
from .lora import linear


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 2560           # opt-2.7b
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    ffn_dim: int = 10240
    max_position_embeddings: int = 2048
    word_embed_proj_dim: Optional[int] = None  # None -> hidden_size
    do_layer_norm_before: bool = True
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    init_std: float = 0.02
    lora_r: int = 0
    lora_alpha: float = 32.0
    # self-attention through kernel K2 with its in-kernel causal mask
    use_pallas_attention: bool = False
    # projections, FFN and the tied head W8A8 (ops/quant.py); needs lora_r == 0
    quantize_int8: bool = False

    def __post_init__(self):
        if self.quantize_int8 and self.lora_r:
            raise ValueError(
                "quantize_int8 requires lora_r == 0 — merge the LoRA "
                "adapters into the base weights before quantized serving")

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2,
                        num_attention_heads=4, ffn_dim=32, max_position_embeddings=64)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def opt_2_7b(cls, **kw):
        """``facebook/opt-2.7b``, the LM inside ``Salesforce/blip2-opt-2.7b``."""
        return cls(**kw)


def opt_positions(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF ``OPTLearnedPositionalEmbedding``: positions count real tokens only;
    padded rows stay at -1, which the +2 offset maps to embedding row 1."""
    mask = attention_mask.long()
    return torch.cumsum(mask, dim=1) * mask - 1


def _dense(cfg: OPTConfig):
    return Int8Linear if cfg.quantize_int8 else nn.Linear


class OPTAttention(nn.Module):
    """HF ``OPTAttention``: scaled q, biased projections, LoRA on q/v."""

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.config = cfg
        H, dense = cfg.hidden_size, _dense(cfg)
        self.q_proj = linear(H, H, r=cfg.lora_r, alpha=cfg.lora_alpha, dense=dense)
        self.k_proj = dense(H, H)
        self.v_proj = linear(H, H, r=cfg.lora_r, alpha=cfg.lora_alpha, dense=dense)
        self.out_proj = dense(H, H)

    def forward(self, x, mask_bias, key_mask=None):
        cfg = self.config
        B, L, H = x.shape
        hd = cfg.head_dim
        q = self.q_proj(x)
        k = self.k_proj(x)
        v = self.v_proj(x)
        nh = q.shape[-1] // hd  # this device's heads (all, or its tensor-parallel share)
        # the JAX package fuses only on a TPU and, there, only where its
        # kernel's sublane and lane packing allow (L % 8, 128-lane head
        # groups); K2 takes any L and head grouping, so on the card every
        # masked call fuses and the CPU keeps JAX's unfused CPU path
        if cfg.use_pallas_attention and key_mask is not None and x.device.type == "cuda":
            key_bias = (1.0 - key_mask.float()) * ATTN_MASK_BIAS
            ctx = fused_self_attention(q, k, v, key_bias, causal=True, num_heads=nh,
                                       sm_scale=hd ** -0.5)
            return self.out_proj(ctx)
        q = (q * (hd ** -0.5)).view(B, L, nh, hd)
        k = k.view(B, L, nh, hd)
        v = v.view(B, L, nh, hd)
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) + mask_bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(x.dtype)
        return self.out_proj(ctx.reshape(B, L, nh * hd))


class OPTDecoderLayer(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.config = cfg
        H, dense = cfg.hidden_size, _dense(cfg)
        self.self_attn = OPTAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.fc1 = dense(H, cfg.ffn_dim)
        self.fc2 = dense(cfg.ffn_dim, H)
        self.final_layer_norm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, x, mask_bias, key_mask=None):
        pre = self.config.do_layer_norm_before
        h = self.self_attn_layer_norm(x) if pre else x
        x = x + self.self_attn(h, mask_bias, key_mask=key_mask)
        if not pre:  # opt-350m's post-LN variant
            x = self.self_attn_layer_norm(x)
        h = self.final_layer_norm(x) if pre else x
        x = x + self.fc2(F.relu(self.fc1(h)))
        if not pre:
            x = self.final_layer_norm(x)
        return x


class OPTDecoder(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        # HF allocates max_position_embeddings + 2 rows (offset 2)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + 2, cfg.hidden_size)
        if cfg.embed_dim != cfg.hidden_size:
            self.project_in = _dense(cfg)(cfg.embed_dim, cfg.hidden_size, bias=False)
            self.project_out = _dense(cfg)(cfg.hidden_size, cfg.embed_dim, bias=False)
        else:
            self.project_in = self.project_out = None
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = (nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
                                 if cfg.do_layer_norm_before else None)


class OPTModel(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.decoder = OPTDecoder(cfg)


class OPTForCausalLM(nn.Module):
    """Decoder-only LM; ``forward`` returns ``(full-sequence logits, hidden)``.
    Built on ``device`` (CUDA by default) with weights drawn from
    ``generator``; ``device="meta"`` builds it for a parent that
    materialises it."""

    def __init__(self, config: OPTConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.model = OPTModel(config)
        materialize_(self, device, dtype, generator, config.init_std)

    @property
    def embed_tokens(self) -> nn.Embedding:
        return self.model.decoder.embed_tokens

    @staticmethod
    def causal_bias(attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, 1, L, L] additive bias: causal and key not padded."""
        L = attention_mask.shape[1]
        causal = torch.tril(torch.ones(L, L, device=attention_mask.device))
        allowed = causal[None, None] * attention_mask.float()[:, None, None, :]
        return (1.0 - allowed) * ATTN_MASK_BIAS

    def hidden_states(self, input_ids=None, attention_mask=None, inputs_embeds=None):
        dec = self.model.decoder
        if inputs_embeds is None:
            inputs_embeds = dec.embed_tokens(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones(inputs_embeds.shape[:2], dtype=torch.long,
                                        device=inputs_embeds.device)
        x = inputs_embeds
        if dec.project_in is not None:
            x = dec.project_in(x)
        x = x + dec.embed_positions(opt_positions(attention_mask) + 2).to(x.dtype)
        bias = self.causal_bias(attention_mask)
        for layer in dec.layers:
            x = layer(x, bias, key_mask=attention_mask)
        if dec.final_layer_norm is not None:
            x = dec.final_layer_norm(x)
        if dec.project_out is not None:
            x = dec.project_out(x)
        return x

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The tied head, ``hidden @ embed_tokens.T``, in fp32."""
        emb = self.embed_tokens.weight
        if self.config.quantize_int8:
            return int8_dot(hidden, emb.t())
        return torch.einsum("bld,vd->blv", hidden.float(), emb.to(hidden.dtype).float())

    def forward(self, input_ids=None, attention_mask=None, inputs_embeds=None):
        hidden = self.hidden_states(input_ids, attention_mask, inputs_embeds)
        return self.lm_logits(hidden), hidden
