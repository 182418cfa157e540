#!/usr/bin/env python3
"""Ablations of the MaxSim kernels K1 and K3 on a CUDA card.

Builds patched copies of ``reranking_multimodal_retrievers_tpu_torch/csrc``
side by side (under ``build/maxsim_ablation/``), one per variant, and times
each through the port's wrappers in turns (all variants, then all again in
reverse order) at three shapes: a 32,768-doc slab of the main path (8 x 113
query tokens, docs of 256 tokens, every token valid, then random lengths)
and ``bench.py``'s retrieval batch (128 x 96) over 4,096 docs of random
length. Variants that compute the same function are checked bitwise against
the first one; the ``diag_*`` variants remove a part of the kernel and
compute nothing useful, to show what that part costs.

Run from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/maxsim_ablation.py [variant ...]

Prints one JSON line per variant (times in ms, two turns each) and the
card's name and power limit first. With no arguments it runs every variant.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from reranking_multimodal_retrievers_tpu_torch.ops import (  # noqa: E402
    _build, maxsim_cuda, maxsim_int8_cuda)

SKELETON = "maxsim_hopper.cuh"
FOLD = "fold_tile<kInt8, kBf16Scores>(acc[mt & 1], bias, rmax[mt][0], rmax[mt][1]);"
NOFOLD = [(FOLD, "rmax[mt][0] = acc[mt & 1][0] > rmax[mt][0] ? acc[mt & 1][0] : rmax[mt][0];")]
NOMMA = [("  for (int c = 0; c < kc; ++c) {", "  for (int c = 0; c < 0 * kc; ++c) {")]
NOSUM = [("      consumer_sync();\n      for (int ql = warp; ql < nq; ql += kConsumerWarps) {",
          "      for (int ql = warp; ql < 0; ql += kConsumerWarps) {")]

# the consumer's per-tile products and folds, and the same over two
# 128-token sub-tiles a stage (int8 only)
TILE = """          issue_tile<kInt8>(acc[0], dq, dd, p.kc, a_step, b_step);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt + 1 < MT) {  // the next row tile's products under this one's max
              issue_tile<kInt8>(acc[(mt + 1) & 1], dq + (((mt + 1) * 64 * kChunk) >> 4), dd,
                                p.kc, a_step, b_step);
              wg_wait<1>();
            } else {
              wg_wait<0>();
            }
            reg_fence(acc[mt & 1]);
            """ + FOLD + """
          }"""
SKIP_EMPTY_TILE = """          issue_tile<kInt8>(acc[0], dq, dd, p.kc, a_step, b_step);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt < live) {
              if (mt + 1 < live) {
                issue_tile<kInt8>(acc[(mt + 1) & 1], dq + (((mt + 1) * 64 * kChunk) >> 4), dd,
                                  p.kc, a_step, b_step);
                wg_wait<1>();
              } else {
                wg_wait<0>();
              }
              reg_fence(acc[mt & 1]);
              """ + FOLD + """
            }
          }"""
ACTIVE = "    const bool active = wg * MT * 64 < rows;   // this warpgroup owns a row of the group\n"
BIAS_REGS = """          Bias2 bias[kTok / 8];
#pragma unroll
          for (int j = 0; j < kTok / 8; ++j) {
            bias[j] = *reinterpret_cast<const Bias2*>(bias_s + 8 * j + 2 * c);
          }
"""
SUB_TILE_BODY = """          issue_tile<kInt8>(acc[0], dq, dd, p.kc, a_step, b_step);
#pragma unroll
          for (int h = 0; h < kSub; ++h) {
            const Acc* bias_h =
                reinterpret_cast<const Acc*>(smem + L.bias) + s * kStageTok + h * kTok;
            Bias2 bias[kTok / 8];
#pragma unroll
            for (int j = 0; j < kTok / 8; ++j) {
              bias[j] = *reinterpret_cast<const Bias2*>(bias_h + 8 * j + 2 * c);
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const int k = h * MT + mt;
              if (k + 1 < kSub * MT) {
                const int h1 = (k + 1) / MT, mt1 = (k + 1) % MT;
                issue_tile<kInt8>(acc[(k + 1) & 1], dq + ((mt1 * 64 * kChunk) >> 4),
                                  dd + ((h1 * kTok * kChunk) >> 4), p.kc, a_step, b_step);
                wg_wait<1>();
              } else {
                wg_wait<0>();
              }
              reg_fence(acc[k & 1]);
              fold_tile<kInt8, kBf16Scores>(acc[k & 1], bias, rmax[mt][0], rmax[mt][1]);
            }
          }"""
COPY = """        if (lane == 0) {
          const uint32_t st = base + L.stage + s * L.stage_bytes;
          mbar_add_tx(full, L.stage_bytes);
          for (int c = 0; c < p.kc; ++c) {
            tma_load(st + c * kTok * kChunk, &p.d, full, c * kE, t * kTok, n);
          }
        }
"""
ARRIVE = "        mbar_arrive(full);  // every lane, after its bias writes\n"
SUB_TILES = [
    ("constexpr int kTok = 128;", "constexpr int kTok = 128;\n"
     "__host__ __device__ constexpr int sub_tiles(bool int8) { return int8 ? 2 : 1; }"),
    ("    stage_bytes = (uint32_t)kc * kTok * kChunk;",
     "    stage_bytes = (uint32_t)kc * kTok * sub_tiles(int8) * kChunk;"),
    ("    qs = bias + stages * kTok * 4;", "    qs = bias + stages * kTok * sub_tiles(int8) * 4;"),
    ("  constexpr int kE = kInt8 ? 128 : 64;  // elements of a 128-byte chunk",
     "  constexpr int kE = kInt8 ? 128 : 64;\n  constexpr int kSub = sub_tiles(kInt8);\n"
     "  constexpr int kStageTok = kTok * kSub;"),
    ("  const int tok_tiles = (p.Ld + kTok - 1) / kTok;",
     "  const int tok_tiles = (p.Ld + kStageTok - 1) / kStageTok;"),
    ("tma_load(st + c * kTok * kChunk, &p.d, full, c * kE, t * kTok, n);",
     "tma_load(st + c * kStageTok * kChunk, &p.d, full, c * kE, t * kStageTok, n);"),
    ("    constexpr int kPerLane = kTok / 32;", "    constexpr int kPerLane = kStageTok / 32;"),
    ("          const int tok = t * kTok + lane + 32 * k;",
     "          const int tok = t * kStageTok + lane + 32 * k;"),
    ("        Acc* bias = reinterpret_cast<Acc*>(smem + L.bias) + s * kTok;",
     "        Acc* bias = reinterpret_cast<Acc*>(smem + L.bias) + s * kStageTok;"),
    ("b_step = kTok * kChunk / 16;", "b_step = kStageTok * kChunk / 16;"),
    ("box, kTok, sw, type));", "box, kTok * sub_tiles(kInt8), sw, type));"),
    (BIAS_REGS, ""),
    (TILE, SUB_TILE_BODY),
]

# the producer's bias loop as first built: bounded by the lane index, the
# past-the-end test folded into `valid`
KEPT_LOOP = """#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int tok = t * kTok + lane + 32 * k;
          const bool past = tok >= p.Ld;
          const bool valid = p.mask == nullptr || past || p.mask[(size_t)n * p.Ld + tok];
          if constexpr (kInt8) {
            bias[lane + 32 * k] = past ? kPastEnd : (valid ? 0 : kMaskBias);
          } else {
            const float fill = kBf16Scores ? bf16_round(kMaskFill) : kMaskFill;
            bias[lane + 32 * k] = past ? -INFINITY : (valid ? 0.0f : fill);
          }
        }
"""
FIRST_LOOP = [(KEPT_LOOP, """        for (int j = lane; j < kTok; j += 32) {
          const int tok = t * kTok + j;
          const bool valid =
              tok < p.Ld && (p.mask == nullptr || p.mask[(size_t)n * p.Ld + tok]);
          if constexpr (kInt8) {
            bias[j] = tok >= p.Ld ? kPastEnd : (valid ? 0 : kMaskBias);
          } else {
            const float fill = kBf16Scores ? bf16_round(kMaskFill) : kMaskFill;
            bias[j] = tok >= p.Ld ? -INFINITY : (valid ? 0.0f : fill);
          }
        }
""")]

VARIANTS = {
    "kept": [],
    "bias_loop_first_form": FIRST_LOOP,
    # the tile's copy issued after the producer warp has written its bias
    "copy_after_bias": [(COPY, ""), (ARRIVE, COPY + ARRIVE)],
    # the bias read from shared memory in every row tile's fold
    "bias_from_smem": [
        ("const Bias2 (&bias)[kTok / 8], Acc& m0,", "const Bias2* bias, Acc& m0,"),
        ("const int2 b = bias[j];", "const int2 b = bias[4 * j];"),
        ("const float2 b = bias[j];", "const float2 b = bias[4 * j];"),
        (BIAS_REGS, "          const Bias2* bias = reinterpret_cast<const Bias2*>(bias_s + 2 * c);\n")],
    # row tiles past the group's rows skipped (a branch around wgmma)
    "skip_empty_row_tiles": [(ACTIVE, ACTIVE + "    const int live = max(0, min(MT, (rows - wg * MT * 64 + 63) / 64));\n"),
                             (TILE, SKIP_EMPTY_TILE)],
    # two 128-token sub-tiles per ring stage for int8 (K1 unchanged)
    "int8_sub_tiles": SUB_TILES,
    "diag_no_fold": NOFOLD,
    "diag_no_products": NOMMA,
    "diag_no_sums": NOSUM,
    "diag_loads_only": NOFOLD + NOMMA + NOSUM,
}
VARIANTS["diag_loads_only_copy_after_bias"] = VARIANTS["diag_loads_only"] + VARIANTS["copy_after_bias"]
VARIANTS["diag_loads_only_bias_loop_first_form"] = VARIANTS["diag_loads_only"] + FIRST_LOOP


def build(names, root):
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for v in names:
        d = root / v
        shutil.copytree(_build.CSRC, d)
        text = (d / SKELETON).read_text()
        for old, new in VARIANTS[v]:
            if text.count(old) != 1:
                raise RuntimeError(f"{v}: patch anchor found {text.count(old)} times: {old[:60]!r}")
            text = text.replace(old, new)
        (d / SKELETON).write_text(text)
        for lib in ("maxsim", "maxsim_int8"):
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{lib}.so"), str(d / f"{lib}.cu")]
            procs[v, lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs, report = {}, {}
    for (v, lib), proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{v} {lib}: nvcc failed\n{log[-3000:]}")
        report.setdefault(v, {})[lib] = {
            "spill_bytes": sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log)),
            "serialized_wgmma_notes": log.count("C7518")}
        libs.setdefault(v, {})[lib] = ctypes.CDLL(str(root / v / f"{lib}.so"))
    return libs, report


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("maxsim_ablation: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs, report = build(names, _build.BUILD_DIR.parent / "maxsim_ablation")
    current = {}
    _build.load = lambda name: libs[current["v"]][name]  # the wrappers load the variant's library
    K1, K3 = maxsim_cuda.maxsim_scores, maxsim_int8_cuda.maxsim_scores_int8

    gen = torch.Generator(device="cuda").manual_seed(0)

    def unit(*shape):
        x = torch.randn(*shape, device="cuda", generator=gen)
        return (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)

    def codes(*shape):
        return torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)

    n, ld, dim = 32768, 256, 128
    D, Dq = unit(n, ld, dim), codes(n, ld, dim)
    ds = torch.rand(n, device="cuda", generator=gen) / 127
    full = torch.ones(n, ld, dtype=torch.bool, device="cuda")
    lens = torch.randint(1, ld + 1, (n,), device="cuda", generator=gen)
    ragged = torch.arange(ld, device="cuda")[None, :] < lens[:, None]
    Q, Qq = unit(8, 113, dim), codes(8, 113, dim)
    qs = torch.rand(8, 113, device="cuda", generator=gen) / 127
    Qb, Qbq = unit(128, 96, dim), codes(128, 96, dim)
    qsb = torch.rand(128, 96, device="cuda", generator=gen) / 127
    work = {
        "k1_slab_full": lambda: K1(Q, D, full),
        "k1_slab_ragged": lambda: K1(Q, D, ragged),
        "k1_bench_batch_4096": lambda: K1(Qb, D[:4096], ragged[:4096]),
        "k3_slab_full": lambda: K3(Qq, qs, Dq, ds, full),
        "k3_slab_ragged": lambda: K3(Qq, qs, Dq, ds, ragged),
        "k3_bench_batch_4096": lambda: K3(Qbq, qsb, Dq[:4096], ds[:4096], ragged[:4096]),
    }
    first, res = {}, {v: {"build": report[v]} for v in names}
    for v in names + names[::-1]:
        current["v"] = v
        for key, fn in work.items():
            if not v.startswith("diag"):
                out = fn()
                ref = first.setdefault(key, out)
                res[v].setdefault("bitwise_equal_to_first", True)
                res[v]["bitwise_equal_to_first"] &= torch.equal(out, ref)
            res[v].setdefault(key + "_ms", []).append(cuda_ms(fn))
    for v in names:
        print(json.dumps({"variant": v, **res[v]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
