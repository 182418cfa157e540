"""BERT text encoder in PyTorch (port of ``models/bert.py``).

HuggingFace ``BertModel`` structure and parameter names (post-LayerNorm
residual blocks, learned absolute positions, optional cross-attention), with
the JAX package's serving knobs: ``attention_scores_bf16``,
``gelu_approximate``, ``use_pallas_attention`` and ``quantize_int8``. Under
``use_pallas_attention``, the self-attention core of a layer that sees only a
padding mask goes through kernel K2 (``ops/attention_cuda.py``) on CUDA
tensors. Under ``quantize_int8`` every dense layer (query/key/value,
attention output, intermediate, output, pooler) is an ``Int8Linear``
(``ops/quant.py``): W8A8 with the same parameters.
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
    # a JAX library kernel in the reference; not ported yet
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


def _check_supported(cfg: BertConfig) -> None:
    if cfg.use_flash_attention:
        raise NotImplementedError("use_flash_attention is not ported yet")


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
        nh, hd = cfg.num_attention_heads, cfg.head_dim

        q3 = self.self.query(hidden_states)
        k3 = self.self.key(kv)
        v3 = self.self.value(kv)
        if cfg.use_pallas_attention and can_flash and kv_states is None:
            bias = None
            if segment_mask is not None:
                bias = (1.0 - segment_mask.float()) * ATTN_MASK_BIAS
            ctx = fused_self_attention(
                q3, k3, v3, bias, num_heads=nh, sm_scale=float(hd) ** -0.5,
            ).to(hidden_states.dtype)
        else:
            if mask_bias is None and segment_mask is not None:
                mask_bias = additive_mask(segment_mask)
            q = q3.view(B, Lq, nh, hd)
            k = k3.view(B, Lk, nh, hd)
            v = v3.view(B, Lk, nh, hd)
            if cfg.attention_scores_bf16 and q.dtype == torch.bfloat16:
                scores = torch.einsum("bqnd,bknd->bnqk", q, k)
            else:
                scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
            scores = scores / torch.tensor(math.sqrt(hd), dtype=scores.dtype)
            if mask_bias is not None:
                scores = scores + mask_bias.to(scores.dtype)
            probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
            ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float())
            ctx = ctx.to(hidden_states.dtype).reshape(B, Lq, H)
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
        _check_supported(cfg)
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
        can_flash = cfg.use_pallas_attention and attention_adj is None
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
