"""Residual token codec: centroid id + int8 residual (port of
``engine/codec.py``).

Each doc token stores its nearest-centroid id plus a symmetric int8 residual
with one scale per dimension, about 1.94x less memory than a bf16 index at
dim 128 (132 bytes a token for 256). Decompression is a gather, an int8 to
fp32 cast, a multiply and an add.

Scales are ``max(run_max, 1e-8) / 127`` divided by a 0-d tensor
(``ops/quant.py::symmetric_scale``): on CUDA a division by a Python number
is a multiplication by its reciprocal, which moves the last bit of a scale
and so flips residuals that sit on a .5 boundary. Residuals round half to
even and clip to ±127, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DeviceLike, fp32_matmul, is_on, resolve_device
from ..ops.quant import symmetric_scale
from .kmeans import train_centroids


@dataclass
class CompressedTokenIndex:
    centroids: torch.Tensor  # [K, dim] fp32
    codes: torch.Tensor  # [N, L_d] int32 — centroid id per token
    residuals: torch.Tensor  # [N, L_d, dim] int8
    scales: torch.Tensor  # [dim] fp32 per-dimension residual scale
    mask: torch.Tensor  # [N, L_d] bool
    doc_ids: list

    @property
    def bytes_per_token(self) -> float:
        dim = self.residuals.shape[-1]
        return dim + 4  # int8 residual + int32 code

    def nbytes(self) -> int:
        return int(
            self.residuals.numel()
            + self.codes.numel() * 4
            + self.centroids.numel() * 4
            + self.scales.numel() * 4
        )


def compress(
    embeddings,
    mask,
    doc_ids,
    num_centroids: int = 256,
    sample_size: int = 65536,
    seed: int = 0,
    token_chunk: int = 1 << 21,
    device: DeviceLike = "cuda",
) -> CompressedTokenIndex:
    """Train centroids on a token sample, assign all tokens, quantize
    residuals (the reference's ``train`` + ``compress`` phases).

    ``embeddings [N, L_d, dim]`` is a tensor on ``device`` (sampled and
    sliced there) or a host array or tensor, which is sampled before any
    fp32 copy is made and shipped one slab at a time (a 100k x 256 x 128
    fp32 host copy would be 13 GB). Assignment and quantization run in
    ``token_chunk``-token slabs, two passes (codes and the running
    per-dimension max of the valid residuals, then quantize), so that the
    [tokens, num_centroids] score block never exceeds one slab.
    """
    dev = resolve_device(device)
    if isinstance(embeddings, torch.Tensor) and not is_on(embeddings, dev):
        embeddings = embeddings.cpu()  # a tensor elsewhere is host input
    msk = (mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)).astype(bool)
    N, L, D = embeddings.shape
    NT = N * L
    flat = embeddings.reshape(-1, D)  # a view on either side
    valid = msk.reshape(-1)
    rng = np.random.default_rng(seed)
    pool = np.flatnonzero(valid)
    take = rng.choice(pool, size=min(sample_size, len(pool)), replace=False)
    if isinstance(flat, torch.Tensor):
        sample = flat[torch.as_tensor(take, device=flat.device)].float()
    else:
        # np advanced indexing copies only the sampled rows
        sample = flat[take].astype(np.float32)
    centroids, _ = train_centroids(sample, k=num_centroids, seed=seed, device=dev)
    cent = torch.as_tensor(centroids, device=dev)
    valid_d = torch.as_tensor(valid, device=dev)

    def chunk(s, e):
        # device input slices on the device; host input ships one slab
        x = flat[s:e]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return x.to(dev).float()

    bounds = [(s, min(s + token_chunk, NT)) for s in range(0, NT, token_chunk)]
    codes = torch.empty(NT, dtype=torch.int32, device=dev)
    run_max = torch.zeros(D, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        for s, e in bounds:
            codes[s:e], m = _assign_chunk(chunk(s, e), cent, valid_d[s:e])
            run_max = torch.maximum(run_max, m)
        scales = symmetric_scale(run_max)
        residuals = torch.empty(NT, D, dtype=torch.int8, device=dev)
        for s, e in bounds:
            residuals[s:e] = _quantize_chunk(chunk(s, e), cent, codes[s:e], scales)
    return CompressedTokenIndex(
        centroids=cent,
        codes=codes.reshape(N, L),
        residuals=residuals.reshape(N, L, D),
        scales=scales,
        mask=torch.as_tensor(msk, device=dev),
        doc_ids=list(doc_ids),
    )


def _assign_chunk(flat, centroids, valid):
    """(codes, per-dim max |residual| over valid tokens) for one slab."""
    flat = flat.float()
    with fp32_matmul():
        codes = (flat @ centroids.T).argmax(dim=1)
    resid = flat - centroids[codes]
    resid_for_scale = torch.where(valid[:, None], resid.abs(), 0.0)
    return codes.int(), resid_for_scale.amax(dim=0)


def _quantize_chunk(flat, centroids, codes, scales):
    resid = flat.float() - centroids[codes.long()]
    return torch.round(resid / scales[None, :]).clamp_(-127, 127).to(torch.int8)


def decompress(index_codes, index_residuals, centroids, scales):
    """codes [...] + residuals [..., dim] -> fp32 embeddings (the CUDA
    ``decompress_residuals`` role)."""
    return centroids[index_codes.long()] + index_residuals.float() * scales
