"""K-means on L2-normalised vectors (port of ``engine/kmeans.py``).

Lloyd iterations on the vectors' device: cosine assignment by one fp32
product and ``argmax`` (the first maximum wins, in both libraries), centroid
sums as a one-hot product in fp32 with TF32 off, empty clusters re-seeded
from the data. The JAX package sums with ``segment_sum``; its counterpart
``index_add_`` sums on CUDA in an order that changes from run to run, where
the one-hot product (``[k, n] @ [n, d]``, 4.3 GFLOP a round at n = 65,536,
k = 256, d = 128) gives the same bits every run. Also the reference's
partition-count heuristic.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, fp32_matmul, resolve_device


def num_partitions_heuristic(num_embeddings_estimate: int) -> int:
    """2^⌊log2(16·√E)⌋ (reference `collection_indexer.py:105-124`)."""
    return 2 ** int(math.floor(math.log2(16 * math.sqrt(max(num_embeddings_estimate, 1)))))


def kmeans(x: torch.Tensor, init: torch.Tensor, k: int, n_iters: int = 20):
    """Lloyd's algorithm on L2-normalised rows (cosine distance).

    Args:
      x: [n, d] rows (L2-normalised, as late-interaction embeddings are).
      init: [k, d] initial centroids (e.g. a random sample of x).

    Returns:
      (centroids [k, d] fp32 L2-normalised, assignments [n] int32), on x's
      device.
    """
    x = x.float()
    n = x.shape[0]
    centroids = init.float()
    # empty clusters are re-seeded from the data (rotated rows)
    reseed = x[torch.arange(k, device=x.device) % n]
    with fp32_matmul():
        for _ in range(n_iters):
            onehot = F.one_hot((x @ centroids.T).argmax(dim=1), k).float()  # [n, k]
            sums = onehot.T @ x
            counts = onehot.sum(dim=0)[:, None]
            new_c = torch.where(counts > 0, sums / counts.clamp_min(1.0), reseed)
            norms = torch.linalg.vector_norm(new_c, dim=1, keepdim=True)
            centroids = new_c / norms.clamp_min(1e-12)
        assign = (x @ centroids.T).argmax(dim=1).int()
    return centroids, assign


def train_centroids(sample, k: int, n_iters: int = 20, seed: int = 0,
                    device: DeviceLike = "cuda"):
    """Host wrapper: pick the init rows with numpy (the JAX package's draw),
    run the Lloyd iterations on ``device``. ``sample`` is a numpy array or a
    tensor; returns numpy ``(centroids [k, d], assignments [n])``."""
    if len(sample) == 0:
        raise ValueError("train_centroids: empty sample")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(sample), size=min(k, len(sample)), replace=False)
    if len(idx) < k:  # degenerate case: tile until the [k, d] carry is full
        idx = np.tile(idx, -(-k // len(idx)))[:k]
    x = torch.as_tensor(sample).to(device=dev, dtype=torch.float32)
    c, a = kmeans(x, x[torch.as_tensor(idx, device=dev)], k=k, n_iters=n_iters)
    return c.cpu().numpy(), a.cpu().numpy()
