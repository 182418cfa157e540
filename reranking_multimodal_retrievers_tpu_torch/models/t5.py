"""T5 / Flan-T5 encoder-decoder LM in PyTorch (port of ``models/t5.py``).

HuggingFace ``T5ForConditionalGeneration`` structure and parameter names
(``encoder.block.{i}.layer.0.SelfAttention.q``, ``...layer.1.DenseReluDense``,
``shared``, ``lm_head``) with the JAX package's semantics and serving knobs:

- RMS norm with fp32 statistics; pre-LN blocks; no attention-score scaling;
  the relative-position bias is computed in block 0 of each stack and
  carried to the later blocks; gated ``gelu_new`` FFN for Flan-T5, ReLU
  ``wi`` otherwise; a tied head scales the decoder output by
  ``d_model ** -0.5``.
- LoRA (``lora_r``) on the q and v projections of self- and
  cross-attention, never on k.
- ``use_pallas_attention``: the encoder's self-attention goes through kernel
  K2 (``ops/attention_cuda.py``), with the relative-position bias as K2's
  per-head bias and the
  padding mask as its [B, L] key bias. The unfused path folds the mask into
  the position bias once, in block 0, and carries it along.
  ``position_bias_bf16`` hands K2 the bias in bf16. On the card every
  encoder self-attention fuses; off it the port fuses where the JAX package
  does (a head geometry its kernel packs into 128 lanes) and otherwise
  takes the unfused path, as JAX does.
- The single-query cross-attention reorder (one decoder position, as the
  rerankers score): the encoder states are pooled by the attention
  probabilities before the V projection, and q is pulled back through the K
  projection, so no layer projects all encoder positions.
- ``quantize_int8``: every projection, FFN and the head run W8A8
  (``ops/quant.py``) with the same parameters; the reorder keeps its small
  products in the activation dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from ..ops.attention_cuda import fused_self_attention, head_pack_feasible
from ..ops.quant import Int8Linear, int8_dot
from .bert import ATTN_MASK_BIAS
from .init import materialize_
from .lora import linear


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    is_gated_act: bool = True  # Flan-T5 / v1.1
    dense_act_fn: str = "gelu_new"
    tie_word_embeddings: bool = False  # Flan-T5 / v1.1
    decoder_start_token_id: int = 0
    lora_r: int = 0
    lora_alpha: float = 32.0
    # the encoder's self-attention through kernel K2, where the JAX package
    # fuses it (head geometry that packs 128 lanes)
    use_pallas_attention: bool = False
    # hand K2 the relative-position bias in bf16
    position_bias_bf16: bool = False
    # projections, FFN and head W8A8 (ops/quant.py); needs lora_r == 0
    quantize_int8: bool = False

    def __post_init__(self):
        if self.quantize_int8 and self.lora_r:
            raise ValueError(
                "quantize_int8 requires lora_r == 0 — merge the LoRA "
                "adapters into the base weights before quantized serving")

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32,
                        num_layers=2, num_decoder_layers=2, num_heads=4)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def flan_t5_xl(cls, **kw):
        """``google/flan-t5-xl``, the LM inside ``Salesforce/blip2-flan-t5-xl``."""
        defaults = dict(d_model=2048, d_kv=64, d_ff=5120, num_layers=24,
                        num_decoder_layers=24, num_heads=32)
        defaults.update(kw)
        return cls(**defaults)


class T5LayerNorm(nn.Module):
    """RMS norm (HF ``T5LayerNorm``): fp32 variance, no mean, no bias."""

    weight_init_ones = True  # models/init.py

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (self.weight * y.to(x.dtype)).to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF ``T5Attention._relative_position_bucket``."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-20)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(ret.dtype)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def _dense(cfg: T5Config):
    return Int8Linear if cfg.quantize_int8 else nn.Linear


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False,
                 bidirectional: bool = True, lora: bool = False):
        super().__init__()
        self.config = cfg
        self.has_relative_bias = has_relative_bias
        self.bidirectional = bidirectional
        dense, r = _dense(cfg), (cfg.lora_r if lora else 0)
        D, inner = cfg.d_model, cfg.inner_dim
        self.q = linear(D, inner, r=r, alpha=cfg.lora_alpha, bias=False, dense=dense)
        self.k = dense(D, inner, bias=False)
        self.v = linear(D, inner, r=r, alpha=cfg.lora_alpha, bias=False, dense=dense)
        self.o = dense(inner, D, bias=False)
        # HF T5's initialisation: the 1/sqrt(d_kv) score scaling T5 leaves
        # out is folded into q's
        self.q.init_std = (D * cfg.d_kv) ** -0.5
        self.k.init_std = self.v.init_std = D ** -0.5
        self.o.init_std = inner ** -0.5
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)
            self.relative_attention_bias.init_std = D ** -0.5

    def _can_fuse(self, kv) -> bool:
        """Encoder self-attention fuses where the JAX package's gate
        (``head_pack_feasible``) admits the configuration's head geometry, on
        the card as off it."""
        cfg = self.config
        if not (cfg.use_pallas_attention and kv is None and self.bidirectional):
            return False
        return head_pack_feasible(cfg.num_heads, cfg.d_kv)

    def compute_bias(self, Lq: int, Lk: int) -> torch.Tensor:
        """[1, heads, Lq, Lk] relative-position bias in the table's dtype."""
        cfg = self.config
        dev = self.relative_attention_bias.weight.device
        rel = torch.arange(Lk, device=dev)[None, :] - torch.arange(Lq, device=dev)[:, None]
        buckets = relative_position_bucket(rel, self.bidirectional,
                                           cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        table = self.relative_attention_bias(buckets)  # [Lq, Lk, heads]
        return table.permute(2, 0, 1).contiguous()[None]

    def forward(self, x, kv=None, mask_bias=None, position_bias=None, key_mask=None):
        cfg = self.config
        kv_in = x if kv is None else kv
        B, Lq, _ = x.shape
        Lk = kv_in.shape[1]
        dk = cfg.d_kv
        fuse = self._can_fuse(kv)
        q2 = self.q(x)
        nh = q2.shape[-1] // dk  # this device's heads (all, or its tensor-parallel share)

        if kv is not None and Lq == 1:
            return self._single_query(x, q2, kv_in, position_bias), position_bias

        k2 = self.k(kv_in)
        v2 = self.v(kv_in)
        if position_bias is None:
            if self.has_relative_bias:
                position_bias = self.compute_bias(Lq, Lk)
            else:
                position_bias = torch.zeros(1, nh, Lq, Lk, device=x.device)
            # unfused: the padding mask folds into the bias once (block 0)
            # and rides along; fused: the bias stays mask-free and the [B, L]
            # key mask goes to the kernel in every layer, the bias cast to
            # bf16 here once under position_bias_bf16 and carried as such
            if mask_bias is not None and not fuse:
                position_bias = position_bias + mask_bias
            if fuse and cfg.position_bias_bf16:
                position_bias = position_bias.to(torch.bfloat16)

        if fuse:
            ctx2 = fused_self_attention(q2, k2, v2, key_mask, position_bias[0],
                                        num_heads=nh, sm_scale=1.0)  # T5: no scaling
            return self.o(ctx2), position_bias

        q = q2.view(B, Lq, nh, dk)
        k = k2.view(B, Lk, nh, dk)
        v = v2.view(B, Lk, nh, dk)
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) + position_bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float()).to(x.dtype)
        return self.o(ctx.reshape(B, Lq, nh * dk)), position_bias

    def _single_query(self, x, q2, kv, position_bias):
        """Cross-attention for one query row, reordered:
        ``(q Wq)(enc Wk)^T = ((q Wq) Wk^T) enc^T`` and the encoder states
        pooled by the probabilities before the V projection (pooling
        commutes with the linear V map, LoRA term included), so the cost per
        layer is O(heads * d_model * Lk) instead of O(inner * d_model * Lk).

        Under a tensor-parallel split the K and V weights hold this rank's
        heads and are read here without their layers, so the encoder states
        and V's (whole) ``lora_a`` enter through the identity whose backward
        all-reduces over the model group, as a column-parallel layer's input
        does: each rank's heads give only part of their gradients.
        """
        cfg = self.config
        B, dk = x.shape[0], cfg.d_kv
        nh = q2.shape[-1] // dk
        D, Lk = kv.shape[-1], kv.shape[1]
        if position_bias is None:
            position_bias = torch.zeros(1, nh, 1, Lk, device=x.device)
        group = getattr(self.k, "tp_group", None)
        lora_a = getattr(self.v, "lora_a", None)
        if group is not None:
            from ..parallel.mesh import copy_to_group

            kv = copy_to_group(kv, group)
            lora_a = None if lora_a is None else copy_to_group(lora_a, group)
        kvf = kv.float()
        Wk = self.k.weight.float().view(nh, dk, D)
        qk = torch.einsum("bnd,ndD->bnD", q2.view(B, nh, dk).float(), Wk).to(q2.dtype)
        scores = torch.einsum("bnD,bkD->bnk", qk.float(), kvf) + position_bias[:, :, 0, :]
        probs = torch.softmax(scores, dim=-1).to(kv.dtype)
        pooled = torch.einsum("bnk,bkD->bnD", probs.float(), kvf).to(kv.dtype)
        Wv = self.v.weight.float().view(nh, dk, D)
        ctx = torch.einsum("bnD,ndD->bnd", pooled.float(), Wv)
        if lora_a is not None:
            lo = torch.einsum("bnD,rD->bnr", pooled, lora_a.to(pooled.dtype))
            Bv = self.v.lora_b.to(pooled.dtype).float().view(nh, dk, -1)
            ctx = ctx + self.v.scaling * torch.einsum("bnr,ndr->bnd", lo.float(), Bv)
        return self.o(ctx.to(x.dtype).reshape(B, 1, nh * dk))


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.config = cfg
        dense = _dense(cfg)
        if cfg.is_gated_act:
            self.wi_0 = dense(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = dense(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = dense(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = dense(cfg.d_ff, cfg.d_model, bias=False)
        for name, m in self.named_children():  # HF T5's initialisation
            m.init_std = (cfg.d_ff if name == "wo" else cfg.d_model) ** -0.5

    def forward(self, x):
        cfg = self.config
        if cfg.is_gated_act:
            gate = self.wi_0(x)
            if cfg.dense_act_fn in ("gelu_new", "gelu"):
                gate = F.gelu(gate, approximate="tanh")
            else:
                gate = F.relu(gate)
            h = gate * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool, bidirectional: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias, bidirectional, lora=True)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5LayerCrossAttention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.EncDecAttention = T5Attention(cfg, lora=True)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5FF(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool = False,
                 has_relative_bias: bool = False):
        super().__init__()
        self.config = cfg
        self.is_decoder = is_decoder
        layers = [T5LayerSelfAttention(cfg, has_relative_bias, bidirectional=not is_decoder)]
        if is_decoder:
            layers.append(T5LayerCrossAttention(cfg))
        layers.append(T5LayerFF(cfg))
        self.layer = nn.ModuleList(layers)

    def forward(self, x, mask_bias=None, position_bias=None, enc_states=None,
                enc_mask_bias=None, key_mask=None):
        cfg = self.config
        sa = self.layer[0]
        attn, position_bias = sa.SelfAttention(
            sa.layer_norm(x), mask_bias=mask_bias, position_bias=position_bias,
            key_mask=key_mask)
        x = x + attn
        if self.is_decoder and enc_states is not None:
            ca = self.layer[1]
            if enc_mask_bias is None:
                enc_mask_bias = torch.zeros(1, 1, x.shape[1], enc_states.shape[1],
                                            device=x.device)
            cross, _ = ca.EncDecAttention(ca.layer_norm(x), kv=enc_states,
                                          position_bias=enc_mask_bias)
            x = x + cross
        ff = self.layer[-1]
        return x + ff.DenseReluDense(ff.layer_norm(x)), position_bias


def _additive(attention_mask: torch.Tensor) -> torch.Tensor:
    return ((1.0 - attention_mask.float()) * ATTN_MASK_BIAS)[:, None, None, :]


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool = False, num_layers: int = 12):
        super().__init__()
        self.config = cfg
        self.is_decoder = is_decoder
        self.block = nn.ModuleList(
            T5Block(cfg, is_decoder, has_relative_bias=(i == 0)) for i in range(num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, inputs_embeds, attention_mask=None, enc_states=None,
                enc_attention_mask=None):
        cfg = self.config
        x = inputs_embeds
        L = x.shape[1]
        mask_bias = _additive(attention_mask) if attention_mask is not None else None
        key_mask = None
        if cfg.use_pallas_attention and not self.is_decoder and attention_mask is not None:
            key_mask = (1.0 - attention_mask.float()) * ATTN_MASK_BIAS  # [B, L] for K2
        if self.is_decoder:
            causal = torch.tril(torch.ones(L, L, device=x.device))
            causal_bias = (1.0 - causal)[None, None] * ATTN_MASK_BIAS
            mask_bias = causal_bias if mask_bias is None else mask_bias + causal_bias
        enc_bias = None
        if enc_states is not None and enc_attention_mask is not None:
            enc_bias = _additive(enc_attention_mask)
        position_bias = None
        for blk in self.block:
            x, position_bias = blk(x, mask_bias=mask_bias, position_bias=position_bias,
                                   enc_states=enc_states, enc_mask_bias=enc_bias,
                                   key_mask=key_mask)
        return self.final_layer_norm(x)


class T5ForConditionalGeneration(nn.Module):
    """Encoder-decoder LM (HF-compatible forward). Built on ``device`` (CUDA
    by default) with weights drawn from ``generator`` at HF T5's scales
    (the head at ``d_model ** -0.5``, so that random logits stay of order
    1); ``device="meta"`` builds it for a parent that materialises it."""

    def __init__(self, config: T5Config, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        with torch.device("meta"):
            self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
            self.encoder = T5Stack(cfg, is_decoder=False, num_layers=cfg.num_layers)
            self.decoder = T5Stack(cfg, is_decoder=True, num_layers=cfg.num_decoder_layers)
            self.lm_head = (None if cfg.tie_word_embeddings
                            else _dense(cfg)(cfg.d_model, cfg.vocab_size, bias=False))
        self.shared.init_std = 1.0
        if self.lm_head is not None:
            self.lm_head.init_std = cfg.d_model ** -0.5
        materialize_(self, device, dtype, generator, cfg.d_model ** -0.5)

    def encode(self, input_ids=None, attention_mask=None, inputs_embeds=None):
        if inputs_embeds is None:
            inputs_embeds = self.shared(input_ids)
        return self.encoder(inputs_embeds, attention_mask=attention_mask)

    def decode(self, decoder_input_ids, enc_states, enc_attention_mask=None):
        """``(logits, hidden)``; under a tied head the logits (not the
        returned hidden states) are scaled by ``d_model ** -0.5``, as HF."""
        cfg = self.config
        hidden = self.decoder(self.shared(decoder_input_ids), enc_states=enc_states,
                              enc_attention_mask=enc_attention_mask)
        if cfg.tie_word_embeddings:
            scaled = hidden * (cfg.d_model ** -0.5)
            if cfg.quantize_int8:
                logits = int8_dot(scaled, self.shared.weight.t())
            else:
                logits = scaled @ self.shared.weight.t().to(scaled.dtype)
        else:
            logits = self.lm_head(hidden)
        return logits, hidden

    def forward(self, input_ids=None, attention_mask=None, decoder_input_ids=None,
                inputs_embeds=None):
        enc = self.encode(input_ids, attention_mask, inputs_embeds)
        return self.decode(decoder_input_ids, enc, attention_mask)
