"""Chunked rerank forward, the throughput path (port of
``engine/rerank_eval.py::make_chunked_rerank_fn`` on one device, and the
decoder rerankers' program of the JAX package's ``bench.py``).

One ``[B*K, L]`` cross-encoder forward per batch of B queries x K candidates:
the query image is ViT-encoded once per image and its features broadcast over
the K candidates, and the expanded batch runs as a loop over fixed-size row
chunks, so live memory is bounded by one chunk's activations.
"""

from __future__ import annotations

from typing import Optional

import torch


def _pick_chunk(expanded: int, chunk_size: Optional[int]) -> int:
    """The largest divisor of ``expanded`` that is at most ``chunk_size``
    (64 by default): on one device no chunk needs padding."""
    chunk_size = max(min(chunk_size or 64, expanded), 1)
    return next(c for c in range(chunk_size, 0, -1) if expanded % c == 0)


def make_chunked_rerank_fn(reranker, nway: int, chunk_size: Optional[int] = None):
    """``fn(input_ids, attention_mask, token_type_ids, query_pixel_values)
    -> logits [B, K]`` for a ``FullContextRerankModel``-style reranker.

    ``nway`` is K, the candidates per query. ``input_ids`` etc. are
    ``[B*K, L]``; ``query_pixel_values`` is ``[B, 3, H, W]`` or None."""

    def fn(input_ids, attention_mask, token_type_ids, query_pixel_values):
        expanded = input_ids.shape[0]
        chunk = _pick_chunk(expanded, chunk_size)
        with torch.inference_mode():
            vis = None
            if query_pixel_values is not None:
                vis_cls, second_last = reranker.encode_vision(query_pixel_values)
                vis = (torch.repeat_interleave(vis_cls, nway, dim=0),
                       torch.repeat_interleave(second_last, nway, dim=0))
            logits = []
            for r0 in range(0, expanded, chunk):
                rows = slice(r0, r0 + chunk)
                out = reranker(
                    input_ids[rows], attention_mask[rows], token_type_ids[rows], None,
                    num_negative_examples=chunk - 1,
                    vision_feats=None if vis is None else (vis[0][rows], vis[1][rows]))
                logits.append(out.logits.reshape(chunk))
        return torch.cat(logits).reshape(-1, nway)

    return fn


def make_decoder_rerank_fn(reranker, chunk_size: Optional[int] = None):
    """``fn(input_ids, attention_mask, pixel_values) -> p_yes [K]`` for a
    ``Blip2DecoderRerankModel`` scoring the K prompts ``[K, L]`` of one query
    image ``[1, 3, H, W]``, the program of the JAX package's decoder rerank
    benchmark: the vision prefix is computed once and broadcast; the LM runs
    over ``chunk_size``-row chunks (10 by default). For T5 each chunk is
    encoded and the decoder then scores all K rows at once
    (``first_decode_logits``); for OPT each chunk's rows are scored at their
    last prompt position (``first_logits``)."""
    cfg = reranker.config
    m = reranker.model

    def fn(input_ids, attention_mask, pixel_values):
        K = input_ids.shape[0]
        chunk = _pick_chunk(K, chunk_size or 10)
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
