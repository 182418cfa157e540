"""BERT text encoder in PyTorch (port of ``models/bert.py``).

HuggingFace ``BertModel`` structure and parameter names (post-LayerNorm
residual blocks, learned absolute positions, optional cross-attention), with
the JAX package's serving knobs: ``attention_scores_bf16``,
``gelu_approximate``, ``use_pallas_attention``, ``use_flash_attention`` and
``quantize_int8``. Under ``use_pallas_attention``, the self-attention core of
a layer that sees only a padding mask goes through kernel K2
(``ops/attention_cuda.py``) on CUDA tensors, at any length (the JAX package
falls back to its unfused path where ``L % 8 != 0`` or its head packing is
infeasible; both compute the same function). Under ``use_flash_attention``
(and not ``use_pallas_attention``, which takes precedence), the same core at
``L >= 256`` is attention with segment ids, as the JAX package's library
flash kernel computes it: ``scaled_dot_product_attention`` on CUDA, its plain
version on the CPU (:func:`segment_attention`). Under ``quantize_int8`` every
dense layer (query/key/value, attention output, intermediate, output,
pooler) is an ``Int8Linear`` (``ops/quant.py``): W8A8 with the same
parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike
from ..ops.attention_cuda import fused_self_attention
from ..ops.quant import Int8Linear
from .init import materialize_

ATTN_MASK_BIAS = -1e9


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    add_cross_attention: bool = False
    # self-attention with a padding-style mask at L >= 256 as attention with
    # segment ids (pad rows attend only pad rows): PyTorch's
    # scaled_dot_product_attention on CUDA, where the JAX package calls
    # JAX's library flash kernel
    use_flash_attention: bool = False
    # self-attention with a padding-style mask goes through kernel K2
    use_pallas_attention: bool = False
    # attention logits stored in bf16 when the activations are bf16; the
    # softmax itself runs in fp32
    attention_scores_bf16: bool = False
    # tanh-approximate GELU instead of the exact erf GELU
    gelu_approximate: bool = False
    # every dense layer W8A8 (ops/quant.py); embeddings, LayerNorm and the
    # attention core stay in the activation dtype
    quantize_int8: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        """A small config for tests."""
        defaults = dict(
            vocab_size=1024,
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=64,
            max_position_embeddings=128,
        )
        defaults.update(kw)
        return cls(**defaults)


def additive_mask(attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, L] 0/1 mask -> [B, 1, 1, L] additive bias (0 keep / -1e9 drop)."""
    return ((1.0 - attention_mask.to(dtype)) * ATTN_MASK_BIAS)[:, None, None, :]


# a table of at most this many rows (the token types) is looked up by masks
# when a gradient is needed
_MASKED_LOOKUP_ROWS = 4


class _EmbeddingLookup(torch.autograd.Function):
    """``F.embedding`` whose backward is ``index_put_`` with accumulation,
    which on CUDA sorts the ids and adds each id's rows in a fixed order.
    CUDA's embedding backward adds a long run of one id (a padding id over
    thousands of tokens) in an order that changes from run to run, so that
    one training step taken twice would differ in the last bits."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        grad = g.new_zeros(ctx.num_rows, g.shape[-1])
        return None, grad.index_put_((ids.reshape(-1),), g, accumulate=True)


def embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, with a backward whose sums run in a fixed order. A
    table of a few rows (the token types, one id repeated over every token)
    takes one mask a row when a gradient is needed: the forward adds only
    zeros to the row it picks, and each row's gradient is a plain
    reduction."""
    if (table.shape[0] <= _MASKED_LOOKUP_ROWS and torch.is_grad_enabled()
            and table.requires_grad):
        zero = table.new_zeros(())
        return sum(torch.where((ids == t)[..., None], table[t], zero)
                   for t in range(table.shape[0]))
    return _EmbeddingLookup.apply(ids, table)


def flash_block_q(L: int) -> Optional[int]:
    """The JAX package's tile for its flash path (``models/bert.py:157-158``):
    the largest of 512, 256 and 128 that divides ``L`` padded up to a
    multiple of 128, or None."""
    L_pad = -(-L // 128) * 128
    return next((b for b in (512, 256, 128) if L_pad % b == 0), None)


def attention_route(cfg: BertConfig, L: int, can_flash: bool, cross: bool) -> str:
    """Which core a layer's attention takes: ``"k2"`` under
    ``use_pallas_attention`` (self-attention only; K2 takes any L, where the
    JAX package's gate at ``models/bert.py:149-152`` also wants ``L % 8 == 0``
    and falls back to the unfused path, which computes the same function);
    else ``"flash"`` by the JAX package's gate (``models/bert.py:159-163``:
    self-attention, ``L >= 256`` and a tile from ``flash_block_q``); else
    ``"unfused"``."""
    if not can_flash or cross:
        return "unfused"
    if cfg.use_pallas_attention:
        return "k2"
    if cfg.use_flash_attention and L >= 256 and flash_block_q(L) is not None:
        return "flash"
    return "unfused"


def segment_attention(q, k, v, segment_mask=None, *, sm_scale: float) -> torch.Tensor:
    """Attention with segment ids over ``q/k/v [B, heads, L, hd]``: a query
    attends the keys of its own segment, real tokens (``segment_mask`` 1) to
    real tokens and pad rows to pad rows, as the JAX package's flash kernel
    computes it with ``SegmentIds``; no mask attends everything. On CUDA
    tensors it is ``scaled_dot_product_attention`` with the boolean mask; on
    the CPU the plain version: fp32 scores and softmax, the probabilities in
    V's dtype, fp32 P.V, the output in Q's dtype."""
    same = None
    if segment_mask is not None:
        seg = segment_mask.bool()
        same = seg[:, None, :, None] == seg[:, None, None, :]
    if q.device.type == "cuda":
        return F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=sm_scale)
    s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * sm_scale
    if same is not None:
        s = s.masked_fill(~same, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bnkd->bnqd", p.float(), v.float()).to(q.dtype)


def _linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)``, or, for a plain ``nn.Linear`` whose weights have another
    dtype than ``x``, the product in their promoted dtype, as a flax
    ``Dense(dtype=None)`` computes it (MORES's fp32 docs through bf16
    weights)."""
    if type(layer) is not nn.Linear or x.dtype == layer.weight.dtype:
        return layer(x)
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def _dense(cfg: BertConfig, in_features: int, out_features: int) -> nn.Linear:
    """The layers the JAX package builds with its ``_dense``: W8A8 under
    ``quantize_int8``, else a plain ``nn.Linear``."""
    return (Int8Linear if cfg.quantize_int8 else nn.Linear)(in_features, out_features)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        H = cfg.hidden_size
        self.query = _dense(cfg, H, H)
        self.key = _dense(cfg, H, H)
        self.value = _dense(cfg, H, H)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = _dense(cfg, cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class BertAttention(nn.Module):
    """Multi-head attention + output projection + post-LN residual."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden_states, kv_states=None, mask_bias=None,
                segment_mask=None, can_flash=False):
        cfg = self.config
        kv = hidden_states if kv_states is None else kv_states
        B, Lq, H = hidden_states.shape
        Lk = kv.shape[1]
        hd = cfg.head_dim

        q3 = self.self.query(hidden_states)
        k3 = _linear(self.self.key, kv)
        v3 = _linear(self.self.value, kv)
        # the heads this device holds: all of them, or its share under a
        # tensor-parallel split (parallel/tensor_parallel.py)
        nh = q3.shape[-1] // hd
        route = attention_route(cfg, Lq, can_flash, kv_states is not None)
        if route == "k2":
            bias = None
            if segment_mask is not None:
                bias = (1.0 - segment_mask.float()) * ATTN_MASK_BIAS
            ctx = fused_self_attention(
                q3, k3, v3, bias, num_heads=nh, sm_scale=float(hd) ** -0.5,
            ).to(hidden_states.dtype)
        elif route == "flash":
            qh, kh, vh = (x.view(B, Lq, nh, hd).transpose(1, 2) for x in (q3, k3, v3))
            ctx = segment_attention(qh, kh, vh, segment_mask, sm_scale=float(hd) ** -0.5)
            ctx = ctx.transpose(1, 2).reshape(B, Lq, nh * hd).to(hidden_states.dtype)
        else:
            if mask_bias is None and segment_mask is not None:
                mask_bias = additive_mask(segment_mask)
            q = q3.view(B, Lq, nh, hd)
            k = k3.view(B, Lk, nh, hd)
            v = v3.view(B, Lk, nh, hd)
            if cfg.attention_scores_bf16 and q.dtype == torch.bfloat16:
                # fp32 keys (MORES's docs) are rounded to bf16 first, as XLA
                # does for a bf16 product of mixed operands
                scores = torch.einsum("bqnd,bknd->bnqk", q, k.to(q.dtype))
            else:
                scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
            scores = scores / torch.tensor(math.sqrt(hd), dtype=scores.dtype)
            if mask_bias is not None:
                scores = scores + mask_bias.to(scores.dtype)
            probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
            ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float())
            ctx = ctx.to(hidden_states.dtype).reshape(B, Lq, nh * hd)
        out = self.output.dense(ctx)
        return self.output.LayerNorm(out + hidden_states)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = _dense(cfg, cfg.hidden_size, cfg.intermediate_size)


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = _dense(cfg, cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.attention = BertAttention(cfg)
        if cfg.add_cross_attention:
            self.crossattention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden_states, mask_bias=None, encoder_hidden_states=None,
                encoder_mask_bias=None, segment_mask=None, can_flash=False):
        cfg = self.config
        hidden_states = self.attention(
            hidden_states, mask_bias=mask_bias, segment_mask=segment_mask,
            can_flash=can_flash)
        if cfg.add_cross_attention and encoder_hidden_states is not None:
            hidden_states = self.crossattention(
                hidden_states, kv_states=encoder_hidden_states,
                mask_bias=encoder_mask_bias)
        inter = self.intermediate.dense(hidden_states)
        inter = F.gelu(inter, approximate="tanh" if cfg.gelu_approximate else "none")
        out = self.output.dense(inter)
        return self.output.LayerNorm(out + hidden_states)


class BertEncoder(nn.Module):
    """Stack of BERT layers. Standalone use is FLMR's transformer mapping
    network: bidirectional self-attention plus cross-attention to text
    states. Returns ``(last_hidden, all_hidden_states)``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden_states, mask_bias=None, encoder_hidden_states=None,
                encoder_mask_bias=None, segment_mask=None, can_flash=False):
        all_hidden = [hidden_states]
        for layer in self.layer:
            hidden_states = layer(
                hidden_states, mask_bias=mask_bias,
                encoder_hidden_states=encoder_hidden_states,
                encoder_mask_bias=encoder_mask_bias,
                segment_mask=segment_mask, can_flash=can_flash)
            all_hidden.append(hidden_states)
        return hidden_states, tuple(all_hidden)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, with_word_embeddings: bool = True):
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        # cross-encoders feed inputs_embeds only and carry no word table
        if with_word_embeddings:
            self.word_embeddings = nn.Embedding(cfg.vocab_size, H)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, H)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, H)
        self.LayerNorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, input_ids=None, token_type_ids=None, inputs_embeds=None):
        cfg = self.config
        ref = inputs_embeds if inputs_embeds is not None else input_ids
        B, L = ref.shape[:2]
        if L > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {L} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}; for rerankers remember the "
                "appended vision tokens (mapping prefix + ViT patches) count "
                "toward the cross-encoder's position budget")
        device = self.position_embeddings.weight.device
        if token_type_ids is None:
            token_type_ids = torch.zeros(B, L, dtype=torch.long, device=device)
        if inputs_embeds is None:
            inputs_embeds = embedding(input_ids, self.word_embeddings.weight)
        pe = embedding(torch.arange(L, device=device), self.position_embeddings.weight)[None]
        te = embedding(token_type_ids, self.token_type_embeddings.weight)
        return self.LayerNorm(inputs_embeds + pe + te)


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = _dense(cfg, cfg.hidden_size, cfg.hidden_size)


class BertModel(nn.Module):
    """Embeddings + encoder (+ tanh pooler), as HF ``BertModel``.

    ``inputs_embeds`` bypasses the word embeddings (the cross-encoder
    rerankers) and ``attention_adj`` is an additive [B, L, L] attention bias
    (PreFLMR attention fusion), which keeps the layer on the plain path.

    Built on ``device`` (CUDA by default) with weights drawn from
    ``generator``; ``device="meta"`` builds an uninitialised submodule for a
    parent that materialises it.
    """

    def __init__(self, config: BertConfig, add_pooling_layer: bool = True,
                 with_word_embeddings: bool = True, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.embeddings = BertEmbeddings(config, with_word_embeddings)
            self.encoder = BertEncoder(config)
            self.pooler = BertPooler(config) if add_pooling_layer else None
        materialize_(self, device, dtype, generator, config.initializer_range)

    def forward(self, input_ids=None, attention_mask=None, token_type_ids=None,
                inputs_embeds=None, attention_adj=None):
        cfg = self.config
        x = self.embeddings(input_ids, token_type_ids, inputs_embeds=inputs_embeds)
        can_flash = (cfg.use_flash_attention or cfg.use_pallas_attention) and attention_adj is None
        mask_bias = None
        if attention_mask is not None and not can_flash:
            mask_bias = additive_mask(attention_mask)
        if attention_adj is not None:
            adj = attention_adj[:, None, :, :]
            mask_bias = adj if mask_bias is None else mask_bias + adj
        last_hidden, all_hidden = self.encoder(
            x, mask_bias=mask_bias,
            segment_mask=attention_mask if can_flash else None,
            can_flash=can_flash)
        pooled = None
        if self.pooler is not None:
            pooled = torch.tanh(self.pooler.dense(last_hidden[:, 0]))
        return {
            "last_hidden_state": last_hidden,
            "pooler_output": pooled,
            "hidden_states": all_hidden,
        }
