#!/usr/bin/env python3
"""Time K2's fp32 path (``csrc/attention_f32.cu``) on one GPU, alone.

At the launch shapes of ``chip_smoke.py`` phase 11 (the FLMR doc and query
encoders, BERT-base's 12 x 64 heads at L = 16 and 24, and the
cross-encoder's [50, 161, 768]: 80 text rows, right-padded, and 81 vision
rows) with random fp32 inputs and key masks of the same form. Each row
holds the kernel against its plain version at ``chip_smoke.py``'s fp32
tolerance and times kernel, plain version and
``scaled_dot_product_attention`` in fp32 (in turns, CUDA events, and the
device time from ``torch.profiler``), beside the 3xTF32 bound and the fp32
FFMA bound (``chip_smoke.k2f32_check``). It takes only the key bias, so
that it also times an older checkout's kernel: copy it there and run it
from that root, in turns with this one. Prints the card's name and power
limit, then one JSON line a shape.

    python3 tools/k2_f32_timing.py
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_f32_timing: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    H, hd = 12, 64
    for B, L, text in ((64, 24, 24), (16, 16, 16), (48, 24, 24), (50, 161, 80)):
        q, k, v = (torch.randn(B, L, H * hd, device="cuda", generator=gen) for _ in range(3))
        lens = torch.randint(max(1, text // 4), text + 1, (B,), device="cuda", generator=gen)
        pos = torch.arange(L, device="cuda")[None, :]
        keep = (pos < lens[:, None]) | (pos >= text)
        bias = torch.where(keep, 0.0, -1e9)
        row = cs.k2f32_check(f"{B}x{L}x{H * hd}", q, k, v, bias, heads=H, scale=hd ** -0.5,
                             sdpa_mask=keep[:, None, None, :])
        cs.emit({"card": smi, **row})
    return 0


if __name__ == "__main__":
    sys.exit(main())
