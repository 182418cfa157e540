#!/usr/bin/env python3
"""Where the time of K2's generic kernel (``csrc/attention_any.cu``) goes, on one GPU.

    python3 tools/k2_generic_phases.py [--phases]

At each row of ``ROWS`` it runs ``chip_smoke.py``'s phase-2 row
(``k2_width_rows``): the kernel through the port's wrapper against its plain
version, timed in turns beside ``scaled_dot_product_attention`` on the same
mask, with its bound; one JSON line a row. With ``--phases`` the generic
kernel's two libraries are built with ``-DK2_ANY_PHASE_CLOCKS=1`` (its
``clock64()`` counters; see the kernel's header), and a second line a row
gives the mean cycles a warp spends on a 64-key tile in each phase of the
tile loop, the mean cycles a warp takes from the loop's start to its end, and
the launch's grid: blocks, blocks an SM at once and the waves they take over
the card's SMs. The counters slow the kernel: compare its ms with a run
without ``--phases``. The card's name and power limit are printed first.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops import _build  # noqa: E402

PHASES = ("wait_and_barrier", "copy_issue", "qk", "softmax", "pv")
# (dtype, heads, head_dim, batch, L, mask): the bf16 rows behind SDPA and two
# ahead of it, 16 x 104 at a batch whose q/k/v fit in L2 and at L = 2,048,
# and the fp32 rows of chip_smoke.py's K2_C9 above hd 128 beside fp32 16 x 104
ROWS = [("bf16", 16, 8, 100, 512, "key"), ("bf16", 16, 24, 100, 512, "key"),
        ("bf16", 16, 40, 100, 512, "key"), ("bf16", 16, 104, 100, 512, "key"),
        ("bf16", 16, 136, 100, 512, "key"), ("bf16", 16, 104, 16, 512, "key"),
        ("bf16", 16, 104, 16, 2048, "key"),
        ("fp32", 16, 104, 100, 512, "key"), ("fp32", 16, 136, 100, 512, "key"),
        ("fp32", 2, 256, 16, 512, "key"), ("fp32", 2, 192, 16, 512, "key"),
        ("fp32", 1, 384, 8, 512, "key"), ("fp32", 2, 256, 16, 512, "head"),
        ("fp32", 2, 256, 16, 512, "causal")]


def counters(lib):
    """The kernel's phase counters since the last read (then zeroed) and the
    last launch's grid."""
    out, grid = (ctypes.c_ulonglong * 8)(), (ctypes.c_int * 6)()
    _build.check(lib.attention_any_phase_counts(out, grid), "attention_any_phase_counts")
    return list(out), list(grid)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    phases = "--phases" in sys.argv[1:]
    if phases:
        for name in _build.K2_ANY:
            _build.DEFINES[name] += ("-DK2_ANY_PHASE_CLOCKS=1",)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 plain version, as chip_smoke.py
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    for dtype, *row in ROWS:
        fp32 = dtype == "fp32"
        lib = _build.load("attention_any_f32" if fp32 else "attention_any")
        if phases:
            counters(lib)  # zero
        table = [tuple(row)]
        (got,) = chip_smoke.k2_width_rows(gen, smi, ([], table) if fp32 else (table, []),
                                          "K2 generic kernel (attention_any.cu)", profile=False)
        if not phases:
            continue
        torch.cuda.synchronize()
        c, grid = counters(lib)
        blocks, threads, smem, per_sm, cb, mt = grid
        print(json.dumps({
            "row": got["variant"], "ms_with_counters": got["ms"],
            "cycles_a_warp_tile": {n: c[i] / c[5] for i, n in enumerate(PHASES)},
            "cycles_a_warp": c[6] / c[7], "blocks": blocks, "threads": threads,
            "smem_bytes": smem, "blocks_an_sm": per_sm, "waves": blocks / (per_sm * sms),
            "column_block": cb, "m_tiles_a_warp": mt}), flush=True)


if __name__ == "__main__":
    main()
