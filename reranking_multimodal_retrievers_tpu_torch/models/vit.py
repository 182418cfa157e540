"""CLIP vision transformer in PyTorch (port of ``models/vit.py``).

HuggingFace ``CLIPVisionModel`` structure and parameter names: patch conv
embedding with a class token and learned positions, pre-LayerNorm residual
blocks with quick-GELU, and ``post_layernorm`` applied only to the pooled CLS
token. Its attention stays plain PyTorch, as the JAX side computes it outside
Pallas.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike
from .init import materialize_


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            image_size=32,
            patch_size=16,
        )
        defaults.update(kw)
        return cls(**defaults)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.q_proj = nn.Linear(H, H)
        self.k_proj = nn.Linear(H, H)
        self.v_proj = nn.Linear(H, H)
        self.out_proj = nn.Linear(H, H)

    def forward(self, x):
        cfg = self.config
        B, L, H = x.shape
        hd = cfg.head_dim
        q = self.q_proj(x)
        nh = q.shape[-1] // hd  # this device's heads (all, or its tensor-parallel share)
        q = q.view(B, L, nh, hd)
        k = self.k_proj(x).view(B, L, nh, hd)
        v = self.v_proj(x).view(B, L, nh, hd)
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float())
        return self.out_proj(ctx.to(x.dtype).reshape(B, L, nh * hd))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(
            cfg.num_channels, cfg.hidden_size, kernel_size=cfg.patch_size,
            stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, cfg.hidden_size)

    def forward(self, pixel_values):
        """pixel_values: [B, C, H, W] (NCHW)."""
        B = pixel_values.shape[0]
        w = self.patch_embedding.weight
        patches = self.patch_embedding(pixel_values.to(w.dtype))
        patches = patches.flatten(2).transpose(1, 2)  # [B, n_patches, hidden]
        cls = self.class_embedding.to(patches.dtype).expand(B, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding.weight[None, : x.shape[1]].to(x.dtype)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values):
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        all_hidden = [x]
        for layer in self.encoder.layers:
            x = layer(x)
            all_hidden.append(x)
        return {
            "last_hidden_state": x,
            "pooler_output": self.post_layernorm(x[:, 0]),
            "hidden_states": tuple(all_hidden),
        }


class CLIPVisionModel(nn.Module):
    """Returns last_hidden_state (no post-LN), the pooled CLS (post-LN) and
    the per-layer hidden states (index -2 is the input to the last layer)."""

    def __init__(self, config: CLIPVisionConfig, *, device: DeviceLike = "cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.vision_model = CLIPVisionTransformer(config)
        materialize_(self, device, dtype, generator, 0.02)

    def forward(self, pixel_values):
        return self.vision_model(pixel_values)
