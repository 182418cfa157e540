"""Chunked rerank forward, the throughput path (port of
``engine/rerank_eval.py::make_chunked_rerank_fn`` on one device, and the
decoder rerankers' program of the JAX package's ``bench.py``).

One ``[B*K, L]`` cross-encoder forward per batch of B queries x K candidates:
the query image is ViT-encoded once per image and its features broadcast over
the K candidates, and the expanded batch runs as a loop over fixed-size row
chunks, so live memory is bounded by one chunk's activations.

Over a mesh (``parallel/``) each chunk's rows are split over the data ranks
(a chunk is a multiple of the data size; the batch is padded up to whole
chunks where no divisor fits), and the ranks' logits are all-gathered at the
end: every rank returns the whole ``[B, K]``. The decoder program splits the
K prompts over the data ranks the same way and runs a model split over the
model axis (``parallel/tensor_parallel.py``) as it is.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import all_gather


def _pick_chunk(expanded: int, chunk_size: Optional[int], n_shards: int = 1) -> tuple:
    """``(chunk, pad)``: the largest divisor of ``expanded`` that is at most
    ``chunk_size`` (64 by default) and a multiple of ``n_shards``, with no
    padding. Where none exists (300 rows on 8 ranks), the largest multiple
    of ``n_shards`` at most ``chunk_size``, and ``pad`` rows that fill the
    last chunk: never one whole-batch chunk, whose activations the chunking
    exists to bound."""
    chunk_size = max(min(chunk_size or 64, expanded), 1)
    for c in range(chunk_size, 0, -1):
        if expanded % c == 0 and c % n_shards == 0:
            return c, 0
    c = max(chunk_size // n_shards, 1) * n_shards
    return c, (-expanded) % c


def _pad_rows(x: torch.Tensor, pad: int, fill=0) -> torch.Tensor:
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def _gather_chunks(local: torch.Tensor, mesh) -> torch.Tensor:
    """``[n_chunks, c]`` logits of each rank's rows -> ``[n_chunks * W * c]``
    in row order (rank r held rows ``[r*c, (r+1)*c)`` of every chunk)."""
    gathered = all_gather(local[None], mesh.data_group)  # [W, n_chunks, c]
    return gathered.movedim(0, 1).reshape(-1)


def make_chunked_rerank_fn(reranker, nway: int, chunk_size: Optional[int] = None,
                           mesh=None):
    """``fn(input_ids, attention_mask, token_type_ids, query_pixel_values)
    -> logits [B, K]`` for a ``FullContextRerankModel``-style reranker.

    ``nway`` is K, the candidates per query. ``input_ids`` etc. are
    ``[B*K, L]``; ``query_pixel_values`` is ``[B, 3, H, W]`` or None. With
    ``mesh``, every rank passes the whole batch, runs its rows of each chunk
    and returns the whole result."""
    n_shards = mesh.n_data if mesh is not None else 1

    def fn(input_ids, attention_mask, token_type_ids, query_pixel_values):
        expanded = input_ids.shape[0]
        chunk, pad = _pick_chunk(expanded, chunk_size, n_shards)
        local = chunk // n_shards
        # padding rows attend to their [PAD] tokens (an all-ones mask), so
        # that their softmax is defined; their logits are cut off below
        input_ids = _pad_rows(input_ids, pad)
        attention_mask = _pad_rows(attention_mask, pad, fill=1)
        token_type_ids = _pad_rows(token_type_ids, pad)
        r = mesh.data_index if mesh is not None else 0
        with torch.inference_mode():
            vis = None
            if query_pixel_values is not None:
                vis_cls, second_last = reranker.encode_vision(query_pixel_values)
                vis = (_pad_rows(torch.repeat_interleave(vis_cls, nway, dim=0), pad),
                       _pad_rows(torch.repeat_interleave(second_last, nway, dim=0), pad))
            logits = []
            for r0 in range(r * local, expanded + pad, chunk):
                rows = slice(r0, r0 + local)
                out = reranker(
                    input_ids[rows], attention_mask[rows], token_type_ids[rows], None,
                    num_negative_examples=local - 1,
                    vision_feats=None if vis is None else (vis[0][rows], vis[1][rows]))
                logits.append(out.logits.reshape(local))
            logits = torch.stack(logits)
            if n_shards > 1:
                logits = _gather_chunks(logits, mesh)
        return logits.reshape(-1)[:expanded].reshape(-1, nway)

    return fn


def make_decoder_rerank_fn(reranker, chunk_size: Optional[int] = None, mesh=None):
    """``fn(input_ids, attention_mask, pixel_values) -> p_yes [K]`` for a
    ``Blip2DecoderRerankModel`` scoring the K prompts ``[K, L]`` of one query
    image ``[1, 3, H, W]``, the program of the JAX package's decoder rerank
    benchmark: the vision prefix is computed once and broadcast; the LM runs
    over ``chunk_size``-row chunks (10 by default). For T5 each chunk is
    encoded and the decoder then scores all K rows at once
    (``first_decode_logits``); for OPT each chunk's rows are scored at their
    last prompt position (``first_logits``).

    With ``mesh`` the K prompts are split over the data ranks (padded to a
    multiple of the data size with copies of the last prompt), ``reranker``
    may be split over the model axis, and every rank returns all K."""
    cfg = reranker.config
    m = reranker.model
    n_shards = mesh.n_data if mesh is not None else 1

    def fn(input_ids, attention_mask, pixel_values):
        if n_shards > 1:
            K_all = input_ids.shape[0]
            pad = (-K_all) % n_shards
            ids_p = torch.cat([input_ids, input_ids[-1:].expand(pad, -1)])
            am_p = torch.cat([attention_mask, attention_mask[-1:].expand(pad, -1)])
            n = ids_p.shape[0] // n_shards
            rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
            p_yes = local_fn(ids_p[rows], am_p[rows], pixel_values)
            return all_gather(p_yes, mesh.data_group)[:K_all]
        return local_fn(input_ids, attention_mask, pixel_values)

    def local_fn(input_ids, attention_mask, pixel_values):
        K = input_ids.shape[0]
        chunk, _ = _pick_chunk(K, chunk_size or 10)
        with torch.inference_mode():
            prefix = reranker.encode_vision(pixel_values).expand(chunk, -1, -1)
            rows = [slice(r0, r0 + chunk) for r0 in range(0, K, chunk)]
            if cfg.blip2.use_decoder_only_language_model:
                first = torch.cat([reranker.first_logits(input_ids[r], attention_mask[r], prefix)
                                   for r in rows])
            else:
                encs, masks = zip(*[m.encode_for_generation(input_ids[r], attention_mask[r],
                                                            vision_prefix=prefix) for r in rows])
                first = reranker.first_decode_logits(torch.cat(encs), torch.cat(masks))
            yes_no = first[:, [cfg.yes_token_id, cfg.no_token_id]]
            return torch.softmax(yes_no, dim=-1)[:, 0]

    return fn
