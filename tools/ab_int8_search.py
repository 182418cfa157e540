#!/usr/bin/env python3
"""Time the int8 search of ``chip_smoke.py`` phase 3b for two or more
checkouts of the port on one CUDA card, in turns.

Each turn is a child process that imports the port package from its
checkout (building the kernels there, under ``build/torch_kernels/``),
makes phase 3b's index on the card from seed 0 (100,000 docs x 256 tokens x
128 bf16 unit vectors, the first 1,024 docs of 32-256 valid tokens, the
rest full), quantizes it into a QuantizedTokenIndex and times
``make_search_fn_int8(100_000, k=100)`` on 8 queries of 113 tokens with
CUDA events: SAMPLES samples of REPS calls each, after one warm-up call, as
phase 3b's ``search_ms`` is one sample of 3 calls. The checkouts run in the
order A, B, ..., then in reverse, so that a drift of the card over the run
falls on each alike.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/ab_int8_search.py ROOT_A ROOT_B [...]

Prints the card's name and power limit, one JSON line a turn (each
sample's ms) and one summary line a checkout (median, min and max over its
turns' samples).
"""

import json
import subprocess
import sys
from pathlib import Path

SEED = 0
N, LD, DIM, BQ, LQ, K, N_ENC = 100_000, 256, 128, 8, 113, 100, 1024
SAMPLES, REPS = 20, 3


def child(root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    from reranking_multimodal_retrievers_tpu_torch.engine import (
        QuantizedTokenIndex, TokenIndex, make_search_fn_int8)
    from reranking_multimodal_retrievers_tpu_torch.ops import _build, maxsim_int8_cuda

    _build.build_all()
    maxsim_int8_cuda._lib()
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def unit(*shape):
        x = torch.randn(*shape, device="cuda", generator=gen)
        return (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)

    emb = torch.empty(N, LD, DIM, dtype=torch.bfloat16, device="cuda")
    for s in range(0, N, 8192):
        emb[s:min(N, s + 8192)] = unit(min(N, s + 8192) - s, LD, DIM)
    mask = torch.ones(N, LD, dtype=torch.bool, device="cuda")
    lens = torch.as_tensor(np.random.default_rng(SEED).integers(32, LD + 1, size=N_ENC))
    mask[:N_ENC] = (torch.arange(LD)[None, :] < lens[:, None]).cuda()
    qindex = QuantizedTokenIndex.from_token_index(
        TokenIndex(embeddings=emb, mask=mask, doc_ids=[str(i) for i in range(N)]))
    del emb
    Qf = unit(BQ, LQ, DIM).float()
    search = make_search_fn_int8(N, k=K)
    arrays = qindex.search_arrays

    search(Qf, *arrays)
    torch.cuda.synchronize()
    ms = []
    for _ in range(SAMPLES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            search(Qf, *arrays)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / REPS)
    print(json.dumps({"root": root, "ms": ms}), flush=True)


def main(roots) -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    samples = {r: [] for r in roots}
    for turn, root in enumerate(roots + roots[::-1]):
        out = subprocess.run([sys.executable, __file__, "--child", root], capture_output=True,
                             text=True, check=True, timeout=900).stdout.strip().splitlines()[-1]
        ms = json.loads(out)["ms"]
        samples[root] += ms
        print(json.dumps({"turn": turn, "root": root, "card": smi, "ms": ms}), flush=True)
    for root, ms in samples.items():
        ms = sorted(ms)
        print(json.dumps({"root": root, "card": smi, "samples": len(ms),
                          "median_ms": ms[len(ms) // 2], "min_ms": ms[0], "max_ms": ms[-1]}),
              flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
