// The Hopper (sm_90a) MaxSim skeleton of K1 (maxsim.cu, bf16) and K3
// (maxsim_int8.cu, int8 codes): one kernel template, instantiated by each.
//
//     out[b, n] = sum_i max_j (Q[b, i] . D[n, j] + bias[n, j])        (K1)
//     out[b, n] = ds[n] * sum_i qs[b, i] * float(max_j (Qq[b, i] . Dq[n, j] + bias[n, j]))   (K3)
//
// Design:
// - Row groups. The flattened [B * Lq] query rows are cut into groups of
//   whole queries, each at most `cap` = 128 * MT rows: as many as shared
//   memory holds beside a ring of two or more doc tiles (512 bf16 rows of
//   dim 128, 1,024 int8 rows). A query longer than `cap` is cut into S
//   pieces instead, each written to its own [S, B, N] slab, which the
//   caller sums. A block loads its group's rows once, by TMA.
// - Persistent blocks, one per SM. Blocks b = g + G * j hold group g and walk
//   docs n = j, j + grid / G, ...: the G blocks that need one doc run side by
//   side, so G - 1 of them find its tokens in L2, and the index is read
//   from device memory about once per launch, whatever G is.
// - Doc tokens come in tiles of kTok = 128 by TMA (a 3-D map over
//   [N, Ld, dim], 128-byte boxes with a 128-byte swizzle) into a ring of 2-4
//   stages with full/empty mbarriers, loaded by one producer warp. TMA
//   zero-fills tokens past Ld and columns past dim, so ragged edges need no
//   branches; the producer also writes the tile's per-token bias (0, the
//   mask value, or "never wins" past Ld) beside it, after issuing the
//   tile's copy, each lane its 4 tokens in an unrolled loop.
// - Two consumer warpgroups each own MT 64-row tiles of the group. Per doc
//   tile and row tile: wgmma m64n128 (k16 bf16 -> fp32, or k32 s8 -> s32),
//   A and B K-major from shared memory; the next row tile's products run
//   while this one's bias add and max run on the accumulator registers
//   (two accumulators, wgmma.wait_group 1). Each thread reads its tokens'
//   bias into registers once a tile and keeps the running max of its two
//   rows of every row tile in registers. No score tile goes to shared
//   memory. (Skipping row tiles past the group's rows was slower: ptxas
//   serialises wgmma issued under such a branch; tools/maxsim_ablation.py
//   measures this and the other variants.)
// - After a doc, each row's max is reduced over its quad by shuffles and
//   goes to shared memory (K3: converted and scaled by its query scale);
//   one warp per query sums its rows in a fixed order (K3: times ds[n]
//   last). A doc's total depends on neither N, the slab, the grid nor the
//   timing.

#pragma once

#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kTok = 128;              // doc tokens per tile: the wgmma N
constexpr int kChunk = 128;            // bytes of a swizzled row: one TMA box's width
constexpr int kConsumerWarps = 8;      // two warpgroups
constexpr int kThreads = (kConsumerWarps + 4) * 32;  // + a producer warpgroup
constexpr int kProducerRegs = 40;      // 40 * 128 + 232 * 256 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kMaxStages = 4;
constexpr int kSmemBudget = 232448;    // sm_90's opt-in shared memory per block
constexpr float kMaskFill = -9999.0f;  // MASK_FILL_VALUE (K1)
constexpr int kMaskBias = -(1 << 25);  // masked doc token (K3)
constexpr int kPastEnd = -(1 << 30);   // K3 token slots past Ld: never win

struct Params {
  CUtensorMap q;        // [1, B * Lq, dim], boxes of 64 rows
  CUtensorMap d;        // [N, Ld, dim], boxes of kTok tokens
  const uint8_t* mask;  // [N, Ld] or null
  const float* qs;      // [B, Lq] (K3)
  const float* ds;      // [N] (K3)
  float* out;           // [S, B, N]
  int B, Lq, N, Ld;
  int kc;               // 128-byte column chunks of a row
  int cap;              // query rows a block holds: 128 * MT
  int stages;           // depth of the doc-tile ring
  int qpg;              // whole queries per group (S == 1)
  int splits;           // S: pieces per query
  int piece;            // rows per piece (S > 1)
  int groups;           // G
};

// Shared-memory layout, in bytes from a 1024-aligned base; every swizzled
// box starts on a 1024-byte boundary.
struct Layout {
  uint32_t q, stage, stage_bytes, bias, qs, rowval, bar, bytes;
  __host__ __device__ Layout(int kc, int cap, int stages, bool int8) {
    q = 0;                                  // [kc][cap rows][128 B]
    stage = (uint32_t)kc * cap * kChunk;    // [stages][kc][kTok rows][128 B]
    stage_bytes = (uint32_t)kc * kTok * kChunk;
    bias = stage + stages * stage_bytes;    // [stages][kTok] fp32 or int32
    qs = bias + stages * kTok * 4;          // [cap] fp32 (K3)
    rowval = qs + (int8 ? cap * 4 : 0);     // [2][cap] fp32, per doc, alternating
    bar = rowval + 2 * cap * 4;             // q, full[stages], empty[stages]
    bytes = bar + 8 * (1 + 2 * kMaxStages) + 1024;  // + alignment slack
  }
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerWarps * 32) : "memory");
}

// One row tile's products over all k-steps: D = A B^T, A the 64 query rows
// at `da`, B the kTok doc tokens at `db`; chunks of 128 bytes lie `a_step`
// and `b_step` apart (descriptor units of 16 bytes).
template <bool kInt8, typename Acc>
__device__ __forceinline__ void issue_tile(Acc (&acc)[64], uint64_t da, uint64_t db, int kc,
                                           uint32_t a_step, uint32_t b_step) {
  reg_fence(acc);
  wg_fence();
  for (int c = 0; c < kc; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 32 bytes a k-step: k16 in bf16, k32 in int8
      const uint64_t a = da + c * a_step + 2 * kk, b = db + c * b_step + 2 * kk;
      if constexpr (kInt8) {
        wgmma_ss_n128_s8(acc, a, b, (c | kk) != 0);
      } else {
        wgmma_ss_n128(acc, a, b, (c | kk) != 0);
      }
    }
  }
  wg_commit();
}

// Adds the tile's bias to the accumulator and folds it into the running
// max of this thread's rows r (m0) and r + 8 (m1). acc[4j + e] is (r, token
// 8j + 2c + e), acc[4j + 2 + e] is (r + 8, the same token); bias[j] holds
// the bias of tokens 8j + 2c and 8j + 2c + 1. Four partial maxima per row
// shorten the dependency chains.
template <bool kInt8, bool kBf16Scores, typename Acc, typename Bias2>
__device__ __forceinline__ void fold_tile(const Acc (&acc)[64], const Bias2 (&bias)[kTok / 8], Acc& m0,
                                          Acc& m1) {
  Acc x0[4], x1[4];
#pragma unroll
  for (int j = 0; j < kTok / 8; ++j) {
    const int k = j & 3;
    if constexpr (kInt8) {
      // Hopper's DPX: max(a + b, c) in one instruction
      const int2 b = bias[j];
      if (j < 4) {
        x0[k] = __viaddmax_s32(acc[4 * j], b.x, acc[4 * j + 1] + b.y);
        x1[k] = __viaddmax_s32(acc[4 * j + 2], b.x, acc[4 * j + 3] + b.y);
      } else {
        x0[k] = __viaddmax_s32(acc[4 * j + 1], b.y, __viaddmax_s32(acc[4 * j], b.x, x0[k]));
        x1[k] = __viaddmax_s32(acc[4 * j + 3], b.y, __viaddmax_s32(acc[4 * j + 2], b.x, x1[k]));
      }
    } else {
      const float2 b = bias[j];
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float be = (e & 1) ? b.y : b.x;
        // bf16 token scores: the score and the sum rounded to bf16, as the
        // TPU kernel's score_dtype does
        s[e] = kBf16Scores ? bf16_round(bf16_round(acc[4 * j + e]) + be) : acc[4 * j + e] + be;
      }
      x0[k] = j < 4 ? fmaxf(s[0], s[1]) : fmaxf(x0[k], fmaxf(s[0], s[1]));
      x1[k] = j < 4 ? fmaxf(s[2], s[3]) : fmaxf(x1[k], fmaxf(s[2], s[3]));
    }
  }
  if constexpr (kInt8) {
    m0 = __vimax3_s32(m0, __vimax3_s32(x0[0], x0[1], x0[2]), x0[3]);
    m1 = __vimax3_s32(m1, __vimax3_s32(x1[0], x1[1], x1[2]), x1[3]);
  } else {
    m0 = fmaxf(m0, fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x0[2], x0[3])));
    m1 = fmaxf(m1, fmaxf(fmaxf(x1[0], x1[1]), fmaxf(x1[2], x1[3])));
  }
}

template <bool kInt8, bool kBf16Scores, int MT>
__global__ void __launch_bounds__(kThreads, 1) maxsim_kernel(__grid_constant__ const Params p) {
  using Acc = std::conditional_t<kInt8, int, float>;
  constexpr int kE = kInt8 ? 128 : 64;  // elements of a 128-byte chunk
  const Layout L(p.kc, p.cap, p.stages, kInt8);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L.bar;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * p.stages;  // + 8 * stage
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // this block's row group and its first doc
  const int G = p.groups;
  const int g = blockIdx.x % G;
  const int doc_step = gridDim.x / G;
  int b0, nq, row0, rows, lqg, split;
  if (p.splits == 1) {
    b0 = g * p.qpg;
    nq = min(p.qpg, p.B - b0);
    row0 = b0 * p.Lq;
    rows = nq * p.Lq;
    lqg = p.Lq;
    split = 0;
  } else {
    b0 = g / p.splits;
    split = g % p.splits;
    nq = 1;
    row0 = b0 * p.Lq + split * p.piece;
    rows = min(p.piece, p.Lq - split * p.piece);
    lqg = rows;
  }
  const int tok_tiles = (p.Ld + kTok - 1) / kTok;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar_full + 8 * s, 32);               // every producer lane
      mbar_init(bar_empty + 8 * s, kConsumerWarps);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup: its first warp loads the group's rows once,
    // then every doc's token tiles into the ring, each with its bias
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * MT * p.kc * 64 * kChunk);
      for (int t = 0; t < 2 * MT; ++t) {
        for (int c = 0; c < p.kc; ++c) {
          tma_load(base + L.q + (c * p.cap + t * 64) * kChunk, &p.q, bar_q, c * kE,
                   row0 + t * 64, 0);
        }
      }
    }
    // Each lane covers tokens lane + 32 k of a tile.
    constexpr int kPerLane = kTok / 32;
    int it = 0;  // tiles issued so far
    for (int n = blockIdx.x / G; n < p.N; n += doc_step) {
      for (int t = 0; t < tok_tiles; ++t, ++it) {
        const int s = it % p.stages;
        if (it >= p.stages) mbar_wait(bar_empty + 8 * s, ((it / p.stages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        if (lane == 0) {
          const uint32_t st = base + L.stage + s * L.stage_bytes;
          mbar_add_tx(full, L.stage_bytes);
          for (int c = 0; c < p.kc; ++c) {
            tma_load(st + c * kTok * kChunk, &p.d, full, c * kE, t * kTok, n);
          }
        }
        Acc* bias = reinterpret_cast<Acc*>(smem + L.bias) + s * kTok;
#pragma unroll
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
        mbar_arrive(full);  // every lane, after its bias writes
      }
    }
  } else {
    // ---- consumer warpgroups: MT row tiles each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int r = (warp % 4) * 16 + lane / 4;  // this thread's rows r and r + 8 of a tile
    const int c = lane % 4;                    // and tokens 8j + 2c, 8j + 2c + 1
    const bool active = wg * MT * 64 < rows;   // this warpgroup owns a row of the group
    float* qs_s = reinterpret_cast<float*>(smem + L.qs);
    float* rowval = reinterpret_cast<float*>(smem + L.rowval);
    if constexpr (kInt8) {
      for (int i = threadIdx.x; i < p.cap; i += kConsumerWarps * 32) {
        qs_s[i] = i < rows ? p.qs[row0 + i] : 0.0f;
      }
    }
    consumer_sync();
    // descriptors of the warpgroup's first row tile and of the ring's
    // stage 0; + (mt * 64 * 128) >> 4 per row tile, + a_step / b_step per
    // column chunk
    const uint64_t dq = make_desc(base + L.q + wg * MT * 64 * kChunk, 16, 1024, kSw128);
    const uint64_t dd0 = make_desc(base + L.stage, 16, 1024, kSw128);
    const uint32_t a_step = p.cap * kChunk / 16, b_step = kTok * kChunk / 16;
    mbar_wait(bar_q, 0);

    int it = 0;   // tiles consumed so far
    int buf = 0;  // rowval half of this doc
    for (int n = blockIdx.x / G; n < p.N; n += doc_step, buf ^= 1) {
      Acc rmax[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (kInt8) {
          rmax[mt][0] = rmax[mt][1] = INT_MIN;
        } else {
          rmax[mt][0] = rmax[mt][1] = -INFINITY;
        }
      }
      for (int t = 0; t < tok_tiles; ++t, ++it) {
        const int s = it % p.stages;
        mbar_wait(bar_full + 8 * s, (it / p.stages) & 1);
        if (active) {
          const uint64_t dd = dd0 + ((s * L.stage_bytes) >> 4);
          // this thread's tokens' bias, read once a tile for all MT row tiles
          using Bias2 = std::conditional_t<kInt8, int2, float2>;
          const Acc* bias_s = reinterpret_cast<const Acc*>(smem + L.bias) + s * kTok;
          Bias2 bias[kTok / 8];
#pragma unroll
          for (int j = 0; j < kTok / 8; ++j) {
            bias[j] = *reinterpret_cast<const Bias2*>(bias_s + 8 * j + 2 * c);
          }
          Acc acc[2][64];
          issue_tile<kInt8>(acc[0], dq, dd, p.kc, a_step, b_step);
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
            fold_tile<kInt8, kBf16Scores>(acc[mt & 1], bias, rmax[mt][0], rmax[mt][1]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      }

      // each row's max over its quad, to shared memory; then one warp per
      // query sums its rows in a fixed order
      float* rv = rowval + buf * p.cap;
      if (active) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            Acc m = rmax[mt][h];
            if constexpr (kInt8) {
              m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
              m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
            } else {
              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            }
            const int row = (wg * MT + mt) * 64 + r + 8 * h;
            if (c == 0) {
              if constexpr (kInt8) {
                rv[row] = __int2float_rn(m) * qs_s[row];
              } else {
                rv[row] = m;
              }
            }
          }
        }
      }
      consumer_sync();
      for (int ql = warp; ql < nq; ql += kConsumerWarps) {
        const float* v = rv + ql * lqg;
        float sum = 0.0f;
        for (int i = lane; i < lqg; i += 32) sum += v[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          if constexpr (kInt8) sum *= p.ds[n];
          p.out[((size_t)split * p.B + b0 + ql) * p.N + n] = sum;
        }
      }
    }
  }
}

// ---- host side: the plan of a launch and its dispatch

struct Plan {
  int mt, stages, qpg, splits, piece, groups;
  uint32_t smem;
};

// Rows per block (128 * mt, mt a power of two up to kMaxMT) and ring depth
// for B x Lq query rows of `dim` elements of `elem` bytes: the largest mt
// whose rows fit beside a 2-stage ring, or the smallest that holds the
// whole batch; then as many stages (up to kMaxStages) as fit. Returns
// false when no mt fits (a dim too wide for shared memory).
template <bool kInt8, int kMaxMT>
bool make_plan(int B, int Lq, int dim, Plan* plan) {
  const int kc = (dim * (kInt8 ? 1 : 2) + kChunk - 1) / kChunk;
  auto fits = [&](int mt, int stages) {
    return Layout(kc, 128 * mt, stages, kInt8).bytes <= (uint32_t)kSmemBudget;
  };
  int mt = kMaxMT;
  while (mt >= 1 && !fits(mt, 2)) mt /= 2;
  if (mt < 1) return false;
  for (int m = 1; m < mt; m *= 2) {
    if (128 * m >= B * Lq) {
      mt = m;
      break;
    }
  }
  int stages = 2;
  while (stages < kMaxStages && fits(mt, stages + 1)) ++stages;
  const int cap = 128 * mt;
  plan->mt = mt;
  plan->stages = stages;
  if (Lq <= cap) {
    plan->splits = 1;
    plan->qpg = std::min(B, cap / Lq);
    plan->piece = Lq;
    plan->groups = (B + plan->qpg - 1) / plan->qpg;
  } else {
    plan->splits = (Lq + cap - 1) / cap;
    plan->piece = (Lq + plan->splits - 1) / plan->splits;
    plan->qpg = 1;
    plan->groups = B * plan->splits;
  }
  plan->smem = Layout(kc, cap, stages, kInt8).bytes;
  return true;
}

template <bool kInt8, bool kBf16Scores, int MT>
int launch_mt(const Params& p, const Plan& plan, cudaStream_t stream) {
  auto kernel = maxsim_kernel<kInt8, kBf16Scores, MT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // G blocks per doc, as many docs at once as the SMs allow (at least one)
  const int per_group = std::max(1, std::min(p.N, sms / p.groups));
  kernel<<<p.groups * per_group, kThreads, plan.smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Q [B, Lq, dim], D [N, Ld, dim] (bf16, or int8 codes with qs [B, Lq] and
// ds [N] fp32), mask [N, Ld] uint8 or null, out [S, B, N] fp32 with S from
// make_plan; Q and D 16-byte aligned, rows of dim elements a multiple of 16
// bytes. Returns a cudaError_t, or kErrEncode + CUresult / kErrNoEncoder.
template <bool kInt8, bool kBf16Scores, int kMaxMT>
int maxsim_run(const void* q, const void* qs, const void* d, const void* ds, const void* mask,
               void* out, int B, int Lq, int N, int Ld, int dim, cudaStream_t stream) {
  Plan plan;
  if (!make_plan<kInt8, kMaxMT>(B, Lq, dim, &plan)) return (int)cudaErrorInvalidValue;
  constexpr int elem = kInt8 ? 1 : 2;
  constexpr auto type = kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t row = (uint64_t)dim * elem;
  const uint32_t box = kChunk / elem;
  Params p{};
  const uint64_t rows = (uint64_t)B * Lq;
  TRY(make_map(&p.q, q, dim, rows, 1, row, rows * row, box, 64, sw, type));
  TRY(make_map(&p.d, d, dim, Ld, N, row, (uint64_t)Ld * row, box, kTok, sw, type));
  p.mask = static_cast<const uint8_t*>(mask);
  p.qs = static_cast<const float*>(qs);
  p.ds = static_cast<const float*>(ds);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.Lq = Lq;
  p.N = N;
  p.Ld = Ld;
  p.kc = (int)((row + kChunk - 1) / kChunk);
  p.cap = 128 * plan.mt;
  p.stages = plan.stages;
  p.qpg = plan.qpg;
  p.splits = plan.splits;
  p.piece = plan.piece;
  p.groups = plan.groups;
  switch (plan.mt) {
    case 1: return launch_mt<kInt8, kBf16Scores, 1>(p, plan, stream);
    case 2: return launch_mt<kInt8, kBf16Scores, 2>(p, plan, stream);
    case 4: return launch_mt<kInt8, kBf16Scores, 4>(p, plan, stream);
    default:
      if constexpr (kMaxMT >= 8) return launch_mt<kInt8, kBf16Scores, 8>(p, plan, stream);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
