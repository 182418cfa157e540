#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's retrieve-then-rerank path on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. Needs one CUDA
card, ``nvcc`` and the port package beside this file; imports no JAX.

Phases, each printing one JSON line with its elapsed seconds:
  0. the card (name and power limit as ``nvidia-smi`` gives them);
  1. build the CUDA kernels (``nvcc`` -> shared library -> ``ctypes``);
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes in bf16, and time kernel, plain version and (for K2)
     ``scaled_dot_product_attention`` as a yardstick the port never calls;
  3. retrieve: full-width FLMR (BERT-base, ViT-B/32, dim 128, 32-token
     prefix, 1-layer mapping network; random bf16 weights from a seed)
     encodes 1,024 docs into a TokenIndex padded with random unit vectors to
     100,000 x 256 x 128 bf16, encodes 8 queries (32 tokens + an image) and
     serves them through RetrievalService, k = 100; the top-100 is held
     against the plain version;
  4. rerank: the 8 queries x their 100 candidates x 512 tokens through
     RerankService with a full-width FullContextRerankModel in bf16; logits
     are held against a CPU fp32 recomputation of four candidates;
  5. the ``kernels`` line, then the result line.

The launch counters are set to 0 just before each main-path phase (3 and 4)
and read just after it. Any failed check raises and the script exits
non-zero; without a CUDA card it exits non-zero before printing anything.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# K1: fp32 dot products of unit vectors, fp32 sums of <= 113 maxima in a
# different order than the plain version's matmul
K1_TOL = 2e-3
# K2: bf16 outputs of order 1; the kernel rounds unnormalised probabilities
# to bf16 where the plain version rounds normalised ones, and sums in
# another order: a few bf16 spacings
K2_TOL = 3e-2
# rerank logits in bf16 on the card against fp32 on the CPU through 12 + 1 +
# 1 BERT layers and the ViT: bf16 keeps 8 mantissa bits, about 0.4% per
# rounding, which the residual stream accumulates to a few percent
RERANK_ATOL, RERANK_RTOL = 0.05, 0.05


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` launches, timed with CUDA events after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def unit(gen, *shape):
    x = torch.randn(*shape, device="cuda", generator=gen)
    return (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from reranking_multimodal_retrievers_tpu_torch.engine import (
        TokenIndex, encode_corpus, make_chunked_rerank_fn, make_search_fn)
    from reranking_multimodal_retrievers_tpu_torch.models import (
        BertConfig, CLIPVisionConfig, FLMRConfig, FLMRModelForRetrieval)
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        FullContextRerankModel, RerankConfig)
    from reranking_multimodal_retrievers_tpu_torch.ops import _build, attention_cuda, maxsim_cuda
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention, fused_self_attention_reference)
    from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import (
        maxsim_scores, maxsim_scores_reference)
    from reranking_multimodal_retrievers_tpu_torch.serving import RerankService, RetrievalService

    # ---- 0. the card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "seconds": time.perf_counter() - t0})

    # ---- 1. build
    t0 = time.perf_counter()
    build_s = _build.build_all()
    maxsim_cuda._lib()  # load both libraries
    attention_cuda._lib()
    emit({"phase": "build", "nvcc_seconds": build_s, "seconds": time.perf_counter() - t0})

    # ---- 2. each kernel against its plain version, at main-path shapes
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, LQ, N, LD, DIM = 8, 113, 4096, 256, 128
    Q = unit(gen, B, LQ, DIM)
    D = unit(gen, N, LD, DIM)
    lens = torch.randint(1, LD + 1, (N,), device="cuda", generator=gen)
    M = torch.arange(LD, device="cuda")[None, :] < lens[:, None]
    M[7] = False  # a whole-padding doc
    got = maxsim_scores(Q, D, M)
    ref = maxsim_scores_reference(Q, D, M)
    valid = M.any(dim=1)
    k1_err = (got - ref)[:, valid].abs().max().item()
    pad_rel = ((got - ref)[:, ~valid].abs() / ref[:, ~valid].abs()).max().item()
    check(k1_err <= K1_TOL, f"K1 max |diff| {k1_err} > {K1_TOL}")
    check(pad_rel <= 1e-5 and ref[:, 7].max().item() < -9000 * LQ,
          f"K1 whole-padding doc: relative diff {pad_rel}")
    k1_ms = cuda_ms(lambda: maxsim_scores(Q, D, M), 20)
    k1_plain_ms = cuda_ms(lambda: maxsim_scores_reference(Q, D, M), 3)
    k1_bound, k1_by = bound(2 * B * LQ * N * LD * DIM,
                            Q.numel() * 2 + D.numel() * 2 + M.numel() + B * N * 4)
    k1 = dict(shape=[[B, LQ, DIM], [N, LD, DIM]], max_abs_err=k1_err, tol=K1_TOL,
              ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by,
              library_ms=None)
    emit({"phase": "kernel_check", "kernel": "K1 maxsim_scores", **k1})
    del D, M, got, ref

    k2 = {}
    for L in (512, 593):
        BA, H, HD = 100, 12, 64
        q, k, v = (torch.randn(BA, L, H * HD, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        # text tails padded within the first 512 keys; rows past 512 (the
        # cross-encoder's vision rows) always valid
        tlen = torch.randint(256, 513, (BA,), device="cuda", generator=gen)
        pos = torch.arange(L, device="cuda")[None, :]
        keep = (pos < tlen[:, None]) | (pos >= 512)
        bias = torch.where(keep, 0.0, -1e9)
        kw = dict(num_heads=H, sm_scale=HD ** -0.5)
        got = fused_self_attention(q, k, v, bias, **kw)
        ref = fused_self_attention_reference(q, k, v, bias, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()) and err <= K2_TOL,
              f"K2 at L={L}: max |diff| {err} > {K2_TOL}")
        qh, kh, vh = (x.view(BA, L, H, HD).transpose(1, 2) for x in (q, k, v))
        amask = keep[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=amask), 10)
        b_ms, b_by = bound(4 * BA * H * L * L * HD, 4 * q.numel() * 2 + bias.numel() * 4)
        k2[L] = dict(shape=[BA, L, H * HD], max_abs_err=err, tol=K2_TOL,
                     ms=cuda_ms(lambda: fused_self_attention(q, k, v, bias, **kw), 10),
                     plain_ms=cuda_ms(lambda: fused_self_attention_reference(q, k, v, bias, **kw), 3),
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        emit({"phase": "kernel_check", "kernel": "K2 fused_self_attention", **k2[L]})
        del q, k, v, got, ref
    emit({"phase": "kernel_checks", "seconds": time.perf_counter() - t0})

    # ---- 3. retrieve (main path)
    t0 = time.perf_counter()
    bert_kw = dict(use_pallas_attention=True, attention_scores_bf16=True, gelu_approximate=True)
    fcfg = FLMRConfig(text_config=BertConfig(**bert_kw), vision_config=CLIPVisionConfig(),
                      dim=128, mapping_network_prefix_length=32,
                      use_transformer_mapping_network=True,
                      transformer_mapping_num_hidden_layers=1)
    wgen = torch.Generator(device="cuda").manual_seed(SEED)
    flmr = FLMRModelForRetrieval(fcfg, device="cuda", dtype=torch.bfloat16, generator=wgen).eval()
    rng = np.random.default_rng(SEED)
    N_ENC, N_ALL, BQ, LQT, K = 1024, 100_000, 8, 32, 100
    dlen = rng.integers(32, LD + 1, size=N_ENC)
    d_am = (np.arange(LD)[None, :] < dlen[:, None]).astype(np.int64)
    d_ids = rng.integers(1000, 29000, size=(N_ENC, LD)) * d_am
    q_ids = rng.integers(1000, 29000, size=(BQ, LQT))
    q_am = np.ones((BQ, LQT), np.int64)
    pix = torch.as_tensor(rng.normal(size=(BQ, 3, 224, 224)).astype(np.float32)).to(torch.bfloat16)
    setup_s = time.perf_counter() - t0

    maxsim_scores.launches = fused_self_attention.launches = 0
    t1 = time.perf_counter()

    def doc_fn(batch):
        out = flmr.doc(batch[0].cuda(), batch[1].cuda())
        return out.late_interaction_output, out.context_mask

    batches = [(torch.as_tensor(d_ids[i:i + 128]), torch.as_tensor(d_am[i:i + 128]))
               for i in range(0, N_ENC, 128)]
    enc = encode_corpus(doc_fn, batches, [str(i) for i in range(N_ENC)], device="cuda")
    check(tuple(enc.embeddings.shape) == (N_ENC, LD, 128), f"doc matrices {enc.embeddings.shape}")
    emb = torch.empty(N_ALL, LD, 128, dtype=torch.bfloat16, device="cuda")
    emb[:N_ENC] = enc.embeddings
    for s in range(N_ENC, N_ALL, 8192):
        emb[s:min(N_ALL, s + 8192)] = unit(wgen, min(N_ALL, s + 8192) - s, LD, 128)
    mask = torch.ones(N_ALL, LD, dtype=torch.bool, device="cuda")
    mask[:N_ENC] = enc.mask
    index = TokenIndex(embeddings=emb, mask=mask, doc_ids=[str(i) for i in range(N_ALL)])
    del enc
    with torch.inference_mode():
        qout = flmr.query(torch.as_tensor(q_ids).cuda(), torch.as_tensor(q_am).cuda(),
                          pixel_values=pix.cuda())
    Qm = qout.late_interaction_output
    check(tuple(Qm.shape) == (BQ, 113, 128) and bool(torch.isfinite(Qm.float()).all()),
          f"query matrices {tuple(Qm.shape)}")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t1

    svc = RetrievalService(make_search_fn(N_ALL, k=K), index, batch_queries=BQ, max_wait_ms=50)
    try:
        t2 = time.perf_counter()
        results = [f.result(timeout=600) for f in [svc.search(Qm[i]) for i in range(BQ)]]
        search_s = time.perf_counter() - t2
    finally:
        svc.close()
    torch.cuda.synchronize()
    retrieve_launches = {"K1": maxsim_scores.launches, "K2": fused_self_attention.launches}
    check(retrieve_launches["K1"] > 0 and retrieve_launches["K2"] > 0,
          f"retrieve launches {retrieve_launches}")

    # the search program alone (K1 over every slab + top-k), after the counts
    # were read: these launches are not the main path's
    search_ms = cuda_ms(lambda: make_search_fn(N_ALL, k=K)(Qm, index.embeddings, index.mask), 3)
    search_bound, search_by = bound(2 * BQ * 113 * N_ALL * LD * 128,
                                    Qm.numel() * 2 + emb.numel() * 2 + mask.numel() + BQ * N_ALL * 4)
    ref_scores = maxsim_scores_reference(Qm, index.embeddings, index.mask)
    ref_vals, ref_idx = torch.topk(ref_scores, K, dim=1)
    identical, worst = 0, 0.0
    for i, (ids, vals) in enumerate(results):
        got_idx = torch.as_tensor([int(x) for x in ids], device="cuda")
        check(len(ids) == K and bool(np.isfinite(vals).all()), f"query {i}: {len(ids)} results")
        identical += int(torch.equal(got_idx, ref_idx[i]))
        # ranks may differ only between docs whose plain scores lie within
        # the K1 tolerance; the served values match the plain scores
        swap = (ref_scores[i, got_idx] - ref_vals[i]).abs().max().item()
        served = (torch.as_tensor(vals, device="cuda") - ref_scores[i, got_idx]).abs().max().item()
        worst = max(worst, swap, served)
    check(worst <= K1_TOL, f"retrieval top-{K} off the plain version by {worst}")
    emit({"phase": "retrieve", "index": [N_ALL, LD, 128], "queries": BQ, "k": K,
          "setup_seconds": setup_s, "encode_seconds": encode_s, "search_seconds": search_s,
          "search_ms": search_ms, "search_bound_ms": search_bound, "search_bound_by": search_by,
          "identical_rankings": identical, "max_abs_err": worst,
          "launches": retrieve_launches, "seconds": time.perf_counter() - t0})
    candidates = [[int(x) for x in ids] for ids, _ in results]
    del index, emb, mask, ref_scores, flmr

    # ---- 4. rerank (main path)
    t0 = time.perf_counter()
    L = 512
    rcfg = RerankConfig(flmr=fcfg, cross_encoder=BertConfig(
        num_hidden_layers=1, max_position_embeddings=768, **bert_kw),
        loss_fn="BCE", max_query_length=LQT, max_decoder_source_length=L)
    reranker = FullContextRerankModel(rcfg, device="cuda", dtype=torch.bfloat16,
                                      generator=wgen).eval()
    ids = np.zeros((BQ, K, L), np.int64)
    am = np.zeros((BQ, K, L), np.int64)
    for i in range(BQ):
        for j, doc in enumerate(candidates[i]):
            drng = np.random.default_rng([SEED, doc])  # the candidate's own text
            n = int(drng.integers(100, L - LQT + 1))
            ids[i, j, :LQT] = q_ids[i]
            ids[i, j, LQT:LQT + n] = drng.integers(1000, 29000, size=n)
            am[i, j, :LQT + n] = 1
    tt = np.zeros((K, L), np.int64)
    tt[:, LQT:] = 1
    rsvc = RerankService(make_chunked_rerank_fn(reranker, nway=K, chunk_size=100), nway=K,
                         max_batch=BQ, max_wait_ms=50, device="cuda")
    maxsim_scores.launches = fused_self_attention.launches = 0
    try:
        batch_s = []
        for _ in range(2):  # the first batch also warms up cuBLAS
            t1 = time.perf_counter()
            futs = [rsvc.rerank(ids[i], am[i], tt, pix[i]) for i in range(BQ)]
            logits = np.stack([f.result(timeout=600) for f in futs])
            batch_s.append(time.perf_counter() - t1)
    finally:
        rsvc.close()
    torch.cuda.synchronize()
    rerank_launches = {"K1": maxsim_scores.launches, "K2": fused_self_attention.launches}
    check(logits.shape == (BQ, K) and bool(np.isfinite(logits).all()), f"logits {logits.shape}")
    check(rerank_launches["K2"] > 0, f"rerank launches {rerank_launches}")

    t1 = time.perf_counter()
    cpu_model = FullContextRerankModel(rcfg, device="meta")  # weights come below
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in reranker.state_dict().items()},
                              assign=True)
    want = make_chunked_rerank_fn(cpu_model, nway=4, chunk_size=4)(
        torch.as_tensor(ids[0, :4]), torch.as_tensor(am[0, :4]), torch.as_tensor(tt[:4]),
        pix[:1].float())[0].numpy()
    rerank_err = float(np.abs(logits[0, :4] - want).max())
    check(np.allclose(logits[0, :4], want, atol=RERANK_ATOL, rtol=RERANK_RTOL),
          f"rerank logits {logits[0, :4]} vs CPU fp32 {want}")
    emit({"phase": "rerank", "queries": BQ, "candidates": K, "seq_len": L,
          "batch_seconds": batch_s, "candidates_per_s": BQ * K / batch_s[-1],
          "card": smi, "max_abs_err_vs_cpu_fp32": rerank_err, "logit_std": float(logits.std()),
          "cpu_check_seconds": time.perf_counter() - t1, "launches": rerank_launches,
          "seconds": time.perf_counter() - t0})

    # ---- 5. the kernels line and the result
    torch.cuda.synchronize()
    emit({"kernels": [
        dict(name="maxsim_scores", route="cuda",
             source="reranking_multimodal_retrievers_tpu_torch/csrc/maxsim.cu",
             replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:67",
             launches=retrieve_launches["K1"] + rerank_launches["K1"], **k1),
        dict(name="fused_self_attention", route="cuda",
             source="reranking_multimodal_retrievers_tpu_torch/csrc/attention.cu",
             replaces="reranking_multimodal_retrievers_tpu/ops/attention_pallas.py:95",
             launches=retrieve_launches["K2"] + rerank_launches["K2"], **k2[512],
             at_593=k2[593]),
    ], "not_ported": [
        dict(name="maxsim_scores_int8",
             replaces="reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py:183"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
