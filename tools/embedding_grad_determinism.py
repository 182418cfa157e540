#!/usr/bin/env python3
"""Run-to-run determinism and cost of BERT's embedding backward on a CUDA
card, for the lookups ``models/bert.py::embedding`` chooses between.

Cases, at BERT-base width (768) over 512 and 8,192 tokens (phase 8 of
``chip_smoke.py`` embeds 32 docs x 256 tokens):

- ``same``: a 2-row table (the token types), every token id 0;
- ``pad``: a 30,522-row table (the vocabulary), random ids with the second
  half of each 256-token row the padding id 0;
- ``rand``: the vocabulary, random ids.

Variants: ``embedding`` (``F.embedding``'s own backward), ``det`` (the same
under ``torch.use_deterministic_algorithms``), ``put`` (``_EmbeddingLookup``:
``index_put_`` with accumulation) and, for the 2-row table, ``masked`` (one
mask a row, as ``embedding`` takes for a table of at most 4 rows). Each
variant's gradient is taken RUNS times from the same upstream gradient:
``deterministic`` says whether all runs are bitwise equal, ``max_abs_err``
is the largest difference from an fp64 ``index_add_`` and ``ms`` the mean
time of a forward and backward with CUDA events, after one warm-up.

Run from the repository root on a machine with a CUDA card:

    python3 tools/embedding_grad_determinism.py

Prints the card's name and power limit, then one JSON line a case.
"""

import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from reranking_multimodal_retrievers_tpu_torch.models.bert import (  # noqa: E402
    _EmbeddingLookup, embedding)

H, VOCAB, RUNS, REPS = 768, 30_522, 5, 10


def grad_of(lookup, ids, table, up):
    t = table.detach().clone().requires_grad_(True)
    lookup(ids, t).backward(up)
    return t.grad


def det_grad_of(lookup, ids, table, up):
    torch.use_deterministic_algorithms(True)
    try:
        return grad_of(lookup, ids, table, up)
    finally:
        torch.use_deterministic_algorithms(False)


def measure(lookup, ids, table, up, grad_of=grad_of):
    grads = [grad_of(lookup, ids, table, up) for _ in range(RUNS)]
    want = torch.zeros(table.shape, dtype=torch.float64, device=table.device)
    want.index_add_(0, ids.reshape(-1), up.reshape(-1, H).double())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    grad_of(lookup, ids, table, up)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        grad_of(lookup, ids, table, up)
    end.record()
    torch.cuda.synchronize()
    return {"deterministic": all(torch.equal(g, grads[0]) for g in grads[1:]),
            "max_abs_err": (grads[0].double() - want).abs().max().item(),
            "ms": start.elapsed_time(end) / REPS}


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    variants = {"embedding": (F.embedding, grad_of), "det": (F.embedding, det_grad_of),
                "put": (_EmbeddingLookup.apply, grad_of)}
    for tokens in (512, 8192):
        rows = tokens // 256
        for case in ("same", "pad", "rand"):
            n = 2 if case == "same" else VOCAB
            table = torch.randn(n, H, device="cuda", generator=gen)
            ids = torch.randint(0, n, (rows, 256), device="cuda", generator=gen)
            if case == "same":
                ids.zero_()
            elif case == "pad":
                ids[:, 128:] = 0
            up = torch.randn(rows, 256, H, device="cuda", generator=gen)
            # embedding() takes its masked lookup for a table of <= 4 rows
            cases = dict(variants, **({"masked": (embedding, grad_of)} if n <= 4 else {}))
            print(json.dumps({"case": case, "tokens": tokens, "table_rows": n, "card": smi,
                              **{name: measure(fn, ids, table, up, g)
                                 for name, (fn, g) in cases.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
