#!/usr/bin/env python3
"""Where the interaction rerankers' time goes on a CUDA card: phase 9a
(CrossEncoder type) and 9b (MORES type) of ``chip_smoke.py`` at the same
width and traffic (8 queries x 100 candidates, 128 + 512 late-interaction
tokens of dim 128, bf16 weights from seed 0), traced by ``torch.profiler``.

For each type: the wall time of one pass over the 8 queries (after a
warm-up pass, untraced and traced), the device time of every kernel in the
traced pass summed by kind (``KINDS``: K2, cuBLAS products in fp32 and in
bf16, dtype copies, LayerNorm, softmax, GELU, other), the pass's
device-busy time (the union of the kernels' intervals) and its idle share
(1 - busy / wall). The traced pass runs slower than an untraced one; the
shares are what this reads.

Run from the repository root on a machine with a CUDA card:

    python3 tools/interaction_profile.py [--out build/interaction_profile.json]

Prints the card's name and power limit, then one JSON line a type; the
20 kernels with the most device time of each go to ``--out``.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    INTER_B, INTER_DIM, INTER_K, INTER_LD, INTER_LQ, SEED, _interaction_config, _rerank_queries)
from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (  # noqa: E402
    InteractionRerankModel)


KINDS = (  # (kind, substrings of the kernel's name), the first match wins
    ("K2", ("attention_kernel",)),
    ("gemm_fp32", ("f32f32", "sgemm")),
    ("gemm_bf16", ("nvjet", "gemm", "gemv")),
    ("dtype_copy", ("copy_kernel",)),
    ("layer_norm", ("layer_norm",)),
    ("softmax", ("softmax",)),
    ("gelu", ("gelu", "erfc")),
)


def kind(name: str) -> str:
    n = name.lower()
    return next((k for k, subs in KINDS if any(x in n for x in subs)), "other")


def busy_ms(intervals):
    """The length of the union of [start, end) intervals, in ms."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "interaction_profile.json")
    out = ap.parse_args().out
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 10)
    B, K, LQ, LD, DIM = INTER_B, INTER_K, INTER_LQ, INTER_LD, INTER_DIM
    q = torch.as_tensor(rng.normal(size=(B, LQ, DIM)).astype(np.float32)).cuda().bfloat16()
    d = torch.as_tensor(rng.normal(size=(B, K, LD, DIM)).astype(np.float32)).cuda().bfloat16()
    qm = torch.ones(B, LQ, dtype=torch.int32, device="cuda")
    dm = torch.ones(B, K, LD, dtype=torch.int32, device="cuda")
    top = {}
    for typ in ("CrossEncoder", "MORES"):
        cfg = _interaction_config(typ)
        model = InteractionRerankModel(
            cfg, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(SEED)).eval()
        _rerank_queries(model, q, qm, d, dm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _rerank_queries(model, q, qm, d, dm)
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _rerank_queries(model, q, qm, d, dm)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kind, by_name, spans = {}, {}, []
        for e in kernels:
            us = e.time_range.end - e.time_range.start
            spans.append((e.time_range.start, e.time_range.end))
            by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + us / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
        device_ms = sum(by_kind.values())
        busy = busy_ms(spans)
        top[typ] = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
        print(json.dumps({
            "type": typ, "card": smi, "candidates": B * K, "untraced_pass_ms": untraced_ms,
            "traced_pass_ms": wall_ms, "kernels": len(kernels), "device_ms": device_ms,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms if kernels else None,
            "ms_by_kind": by_kind,
            "share_by_kind": {k: v / device_ms for k, v in by_kind.items()} if device_ms else {},
        }), flush=True)
        del model
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "top": top}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
