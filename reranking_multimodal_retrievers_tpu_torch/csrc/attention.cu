// K2: fused multi-head self-attention on Hopper (sm_90a), bf16, at every
// head_dim that is a multiple of 16 from 16 to 128 (every other head_dim
// runs csrc/attention_any.cu).
//
// ops/_build.py builds this file into one library a group of head widths
// (K2_GROUPS), compiled in parallel: each exports attention_bf16 for every
// multiple of 16 from K2_HD_FIRST to K2_HD_LAST.
//
// Replaces reranking_multimodal_retrievers_tpu/ops/attention_pallas.py::
// fused_self_attention (pallas_call at :175, body _attn_kernel at :36). It
// computes
//     out = softmax(Q K^T * sm_scale + key_bias [+ head_bias] [+ causal]) V
// per (batch row, head), reading Q/K/V in the projection layout
// [B, L, heads * hd] through strides (no transposes), taking the padding
// mask as an additive [B, L] fp32 key bias (0 keep / -1e9 drop), an optional
// per-head additive bias [heads, L, L] in bf16 or fp32 shared over the batch
// (the T5 relative-position bias) and an optional causal mask that adds -1e9
// where key > query, as the TPU kernel does. Softmax statistics and the P.V
// accumulation are fp32.
//
// What bounds it on an H100: at the BERT rerank shape [100, 512, 12 x 64] it
// does 4*B*H*L*L*64 = 80.5 GFLOP (0.081 ms of bf16 tensor-core time) and must
// move q, k, v and out once, 315 MB (0.094 ms at 3.35 TB/s): bytes, narrowly.
// The T5 encoder shape [10, 544, 32 x 64] adds a bf16 head bias of 18.9 MB;
// the OPT shape [5, 544, 32 x 80] under the causal mask needs about half the
// operations: both are bound by bytes as well. Near either bound, the
// tensor cores must run at their Hopper rate (wgmma) while the next tiles
// arrive, and the [B, H, L, L] scores must never leave the SM.
//
// Design (FlashAttention-3-like):
// - Work items are 128 query rows of one (batch row, head). One persistent
//   block per SM walks items blockIdx.x, + gridDim.x, ...; under the causal
//   mask the heaviest items (the last query blocks) come first. A block has
//   384 threads: two consumer warpgroups of 64 rows each and a producer
//   warpgroup, which gives its registers to the consumers (setmaxnreg: 40
//   and 232 a thread) and of which one warp works.
// - The producer warp loads each item's Q once, into one of two Q buffers
//   (items alternate), and walks its 128-key tiles: one lane issues TMA
//   copies (cp.async.bulk.tensor over 3-D maps [B, L, heads * hd] with the
//   caller's strides) of K, V and, for a bf16 head bias with L % 8 == 0, the
//   128 x 128 bias tile into a 2-stage ring with full/empty mbarriers, and
//   the warp writes the tile's key bias (times log2 e; -inf past L) beside
//   it. It runs ahead into the next item, so one item's last tiles and
//   output overlap the next one's loads. TMA zero-fills rows past L, so the
//   ragged edge needs no branches; the -inf key bias keeps those keys out of
//   the softmax. A warpgroup whose rows all lie past L only takes part in
//   the handshakes.
// - A row of hd columns is cut into column boxes (struct Boxes): hd / 64
//   boxes of 64 columns with the 128-byte swizzle, then one of 32 columns
//   (64-byte swizzle) and one of 16 (32-byte swizzle) as hd % 64 needs:
//   80 = 64 + 16, 48 = 32 + 16, 112 = 64 + 32 + 16. Each box is its own TMA
//   tensor map and its own wgmma descriptor.
// - S = Q K^T is wgmma m64n128k16 (hd/16 k-steps over the boxes, Q and K
//   from shared memory), S stays in registers; the key bias, the head bias (from the
//   swizzled tile in shared memory, conflict-free, or, for an fp32 bias or
//   an L % 8 != 0, loaded from global memory straight into the score
//   registers) and the causal -1e9 (only on tiles that cross the diagonal)
//   are added there; the row max and row sum take two quad shuffles; O is
//   rescaled in registers.
// - P, rounded to bf16 in registers, is wgmma's A operand for O += P V
//   (m64n64k16 for each 64-column box, m64n32k16 and m64n16k16 for the
//   narrower ones; V from shared memory through the transposed-B form). At
//   hd 128 a thread holds 64 fp32 values of O beside the 64 of S. O stays
//   in fp32 registers across all key tiles, is normalised once, staged bf16
//   in the warpgroup's rows of the item's Q buffer and written by one TMA
//   store a box, which drops rows past L.
// - The bf16 head bias comes by TMA only where its two 128 x 64 tiles a
//   stage fit in shared memory beside Q, K and V: up to hd 96. At hd 112
//   and 128 it is read from global memory like an fp32 one.
// - The -1e9 semantics are the TPU kernel's: -1e9 is added, not -inf, so a
//   row whose keys are all masked averages V uniformly, as JAX and the plain
//   version do. Every visited tile holds a key < L, so the running max
//   stays finite. exp is exp2 of log2-scaled scores; the max is subtracted
//   before the exp2, so -1e9-sized scores cancel exactly.
// - Its limit on the card: the two warpgroups reach their softmax together,
//   so the tensor cores idle while both share the exp2 units. FA3's
//   ping-pong (one warpgroup's products under the other's softmax, P V of
//   one tile issued beside Q K^T of the next) was slower here, with
//   128-key tiles (it spilled) and with 64-key tiles (it did not); see
//   PERF.md.

#include <cuda_bf16.h>

#include <type_traits>
#include <utility>

#include "hopper.cuh"  // PTX wrappers, wgmma, TMA and tensor maps

#if !defined(K2_HD_FIRST) || !defined(K2_HD_LAST)
#error "define K2_HD_FIRST and K2_HD_LAST, the head widths this library instantiates"
#endif

namespace {

constexpr int kBM = 128;                   // query rows per block
constexpr int kWGRows = 64;                // query rows per consumer warpgroup
constexpr int kBN = 128;                   // keys per tile
constexpr int kStages = 2;                 // depth of the K/V (and head-bias) ring
constexpr int kConsumerWarps = kBM / 16;   // 8: two warpgroups
constexpr int kThreads = (kConsumerWarps + 4) * 32;  // + a producer warpgroup
// registers a thread after setmaxnreg: the producer warpgroup gives up what
// the consumers take (40 * 128 + 232 * 256 = 168 * 384, the launch's share)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kMaxSmem = 232448;      // dynamic shared memory a block may take
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e9f;           // the TPU kernel's causal mask value

struct NoHeadBias {};

// The column boxes of a row of HD bf16 columns: kN64 boxes of 64 columns,
// then one of 32 if HD % 64 >= 32, then one of 16 if HD % 32 == 16. Box i
// starts at column col(i); a buffer of R rows holds it at byte R * 2 * col(i),
// rows of 2 * width(i) bytes swizzled over the whole row.
template <int HD>
struct Boxes {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head_dim a multiple of 16 up to 128");
  static constexpr int kN64 = HD / 64;
  static constexpr bool k32 = HD % 64 >= 32;
  static constexpr bool k16 = HD % 32 == 16;
  static constexpr int kCol32 = 64 * kN64;           // first column of the 32-column box
  static constexpr int kCol16 = kCol32 + (k32 ? 32 : 0);  // of the 16-column box
};

// The 16-byte chunk that chunk j of row r of a box `width` columns wide
// lands on: its rows of 2 * width bytes are swizzled in 1024-byte patterns
__device__ __forceinline__ int swz(int width, int r, int j) {
  return j ^ (((r * 2 * width) >> 7) & (width / 8 - 1));
}

// Shared-memory layout (bytes from a 1024-aligned base). Every box starts on
// a 1024-byte boundary, where each swizzle pattern starts (boxes of 128 or
// 64 rows are multiples of 1024 bytes).
template <int HD, bool kHBTma>
struct Smem {
  // two Q buffers (items alternate between them; each also stages its
  // item's output), then the ring
  static constexpr uint32_t kQBuf = kBM * 2 * HD;
  static constexpr uint32_t kStage0 = 2 * kQBuf;
  static constexpr uint32_t kK = 0;  // offsets within a stage
  static constexpr uint32_t kV = kK + kBN * 2 * HD;
  static constexpr uint32_t kHB = kV + kBN * 2 * HD;  // two 64-key halves
  static constexpr uint32_t kHBRow = 128;             // 64 bf16 keys, 128-byte swizzle
  static constexpr uint32_t kHBHalf = kBM * kHBRow;
  static constexpr uint32_t kKB = kHB + (kHBTma ? 2 * kHBHalf : 0);  // fp32 key bias
  static constexpr uint32_t kStageBytes = (kKB + kBN * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t kBar = kStage0 + kStages * kStageBytes;
  static constexpr uint32_t kBytes = kBar + 64 + 1024;  // barriers, alignment slack
  static constexpr uint32_t kQTx = kBM * 2 * HD;
  static constexpr uint32_t kTileTx = 2 * kBN * 2 * HD + (kHBTma ? 2 * kHBHalf : 0);
  static_assert(kQBuf % 1024 == 0 && kV % 1024 == 0 && kHB % 1024 == 0,
                "swizzled boxes 1024-aligned");
};

// whether the TMA head-bias tiles fit beside Q, K and V at this width
template <int HD>
constexpr bool kHBTmaFits = Smem<HD, true>::kBytes <= kMaxSmem;

// tensor maps by box width: [0] 64 columns, [1] 32, [2] 16
struct Params {
  CUtensorMap q[3], k[3], v[3], o[3], hb;
  const float* bias;      // [B, L] key bias or null
  const void* head_bias;  // [H, L, L] (read directly unless it comes by TMA)
  int L, H, B, nm;        // nm: query blocks per (batch row, head)
  int items;              // nm * H * B work items, walked by the persistent blocks
  float scale_log2;       // sm_scale * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xFFFF0000u); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---- the kernel

// Work item -> (first query row, head, batch row). Under the causal mask the
// heaviest query blocks (the last) come first.
template <bool CAUSAL>
__device__ __forceinline__ void decode_item(const Params& p, int item, int& m0, int& h, int& b) {
  int mb;
  if (CAUSAL) {
    mb = p.nm - 1 - item / (p.H * p.B);
    item %= p.H * p.B;
  } else {
    mb = item % p.nm;
    item /= p.nm;
  }
  h = item % p.H;
  b = item / p.H;
  m0 = mb * kBM;
}

__device__ __forceinline__ int tiles_of(int m0, int L, bool causal) {
  const int n_end = causal ? min(L, m0 + kBM) : L;
  return (n_end + kBN - 1) / kBN;
}

// TMA copies of the `rows`-row slab at (c0, row, b) of every box of a row of
// HD columns into `dst` (the box layout above)
template <int HD>
__device__ __forceinline__ void load_boxes(uint32_t dst, int rows, const CUtensorMap* maps,
                                           uint32_t bar, int c0, int row, int b) {
  using X = Boxes<HD>;
#pragma unroll
  for (int i = 0; i < X::kN64; ++i) tma_load(dst + rows * 128 * i, &maps[0], bar, c0 + 64 * i, row, b);
  if (X::k32) tma_load(dst + rows * 2 * X::kCol32, &maps[1], bar, c0 + X::kCol32, row, b);
  if (X::k16) tma_load(dst + rows * 2 * X::kCol16, &maps[2], bar, c0 + X::kCol16, row, b);
}

// Stage rows r and r + 8 of one box's output (a thread's columns 8jj + 2c,
// + 1 of each 8, scaled by inv_a / inv_b) in bf16 into a buffer of kBM rows
template <int W, int N>
__device__ __forceinline__ void stage_out(unsigned char* box, const float (&o)[N], int r, int c,
                                          float inv_a, float inv_b) {
  static_assert(N == W / 2, "a thread holds W / 2 values of a 64-row box");
#pragma unroll
  for (int jj = 0; jj < W / 8; ++jj) {
    *reinterpret_cast<uint32_t*>(box + r * 2 * W + swz(W, r, jj) * 16 + c * 4) =
        pack_bf16(o[4 * jj + 0] * inv_a, o[4 * jj + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(box + (r + 8) * 2 * W + swz(W, r + 8, jj) * 16 + c * 4) =
        pack_bf16(o[4 * jj + 2] * inv_b, o[4 * jj + 3] * inv_b);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float alpha_a, float alpha_b) {
#pragma unroll
  for (int jj = 0; jj < N / 4; ++jj) {
    o[4 * jj + 0] *= alpha_a;
    o[4 * jj + 1] *= alpha_a;
    o[4 * jj + 2] *= alpha_b;
    o[4 * jj + 3] *= alpha_b;
  }
}

// HB: the head bias's type (NoHeadBias, float or __nv_bfloat16); kHBTma: a
// bf16 head bias with L % 8 == 0 comes by TMA through the ring, any other is
// read from global memory into the score registers; CAUSAL: the in-kernel
// causal mask. All are compile-time, so the BERT variant pays for none.
template <int HD, typename HB, bool kHBTma, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) attention_kernel(__grid_constant__ const Params p) {
  using S = Smem<HD, kHBTma>;
  using X = Boxes<HD>;
  constexpr bool kHB = !std::is_same<HB, NoHeadBias>::value;
  static_assert(kHB || !kHBTma, "TMA head bias without a head bias");
  static_assert(S::kBytes <= kMaxSmem, "shared memory");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q_full = base + S::kBar;         // + 8 * Q buffer
  const uint32_t bar_q_empty = bar_q_full + 16;       // + 8 * Q buffer
  const uint32_t bar_full = bar_q_empty + 16;         // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage
  const int L = p.L;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar_q_full + 8 * i, 1);   // the producer's expect_tx
      mbar_init(bar_q_empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);               // every producer lane
      mbar_init(bar_empty + 8 * s, kConsumerWarps);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup: its first warp walks the block's items; per
    // item Q into the item's Q buffer, then K, V, [head bias] and key bias
    // per tile into the ring, running ahead into the next item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps) return;
    int it = 0;  // tiles issued so far, over all items
    for (int item = blockIdx.x, j = 0; item < p.items; item += gridDim.x, ++j) {
      int m0, h, b;
      decode_item<CAUSAL>(p, item, m0, h, b);
      const int c0 = h * HD;
      const int qb = j & 1;
      if (j >= 2) mbar_wait(bar_q_empty + 8 * qb, ((j >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_q_full + 8 * qb, S::kQTx);
        load_boxes<HD>(base + qb * S::kQBuf, kBM, p.q, bar_q_full + 8 * qb, c0, m0, b);
      }
      const float* brow = p.bias ? p.bias + (long long)b * L : nullptr;
      const int ntiles = tiles_of(m0, L, CAUSAL);
      for (int t = 0; t < ntiles; ++t, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t st = base + S::kStage0 + s * S::kStageBytes;
        const uint32_t full = bar_full + 8 * s;
        const int n0 = t * kBN;
        float* kb = reinterpret_cast<float*>(smem + S::kStage0 + s * S::kStageBytes + S::kKB);
        for (int jj = lane; jj < kBN; jj += 32) {
          const int n = n0 + jj;
          kb[jj] = n < L ? (brow ? brow[n] * kLog2e : 0.0f) : -INFINITY;
        }
        if (lane == 0) {
          mbar_expect_tx(full, S::kTileTx);
          load_boxes<HD>(st + S::kK, kBN, p.k, full, c0, n0, b);
          load_boxes<HD>(st + S::kV, kBN, p.v, full, c0, n0, b);
          if (kHBTma) {
            tma_load(st + S::kHB, &p.hb, full, n0, m0, h);
            tma_load(st + S::kHB + S::kHBHalf, &p.hb, full, n0 + 64, m0, h);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each of every item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = warp / 4;
    const int g = lane / 4;  // this thread holds rows r and r + 8 of the block
    const int c = lane % 4;  // and columns 8j + 2c, 8j + 2c + 1 of every 8
    const int r = wg * kWGRows + (warp % 4) * 16 + g;
    const float sl2 = p.scale_log2;
    int it = 0;  // tiles consumed so far, over all items
    for (int item = blockIdx.x, j = 0; item < p.items; item += gridDim.x, ++j) {
      int m0, h, b;
      decode_item<CAUSAL>(p, item, m0, h, b);
      const int qb = j & 1;
      const int ntiles = tiles_of(m0, L, CAUSAL);
      const bool active = m0 + wg * kWGRows < L;  // this warpgroup owns a row < L
      const int row0 = m0 + r;
      const int row1 = row0 + 8;
      const uint32_t qs = base + qb * S::kQBuf;
      // the direct-load head bias: this thread's two rows (clamped inside
      // [0, L); rows past L read nothing)
      const HB* hb0 = nullptr;
      const HB* hb1 = nullptr;
      if constexpr (kHB && !kHBTma) {
        const HB* hh = static_cast<const HB*>(p.head_bias) + (long long)h * L * L;
        hb0 = hh + (long long)min(row0, L - 1) * L;
        hb1 = hh + (long long)min(row1, L - 1) * L;
      }

      // O by box, each in wgmma's accumulator layout: o64[i][4j + e] = (r,
      // 64i + 8j + 2c + e), o64[i][4j + 2 + e] = (r + 8, ...); o32 and o16
      // the same over their boxes' columns
      float o64[X::kN64 > 0 ? X::kN64 : 1][32];
      float o32[16];
      float o16[8];
#pragma unroll
      for (int i = 0; i < X::kN64; ++i)
#pragma unroll
        for (int e = 0; e < 32; ++e) o64[i][e] = 0.0f;
#pragma unroll
      for (int e = 0; e < 16; ++e) o32[e] = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) o16[e] = 0.0f;
      float m_a = -INFINITY, m_b = -INFINITY;  // running max of rows r, r + 8 (log2 units)
      float l_a = 0.0f, l_b = 0.0f;            // this thread's part of the running sums

      mbar_wait(bar_q_full + 8 * qb, (j >> 1) & 1);
      for (int t = 0; t < ntiles; ++t, ++it) {
        const int s = it % kStages;
        mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
        if (active) {
          const uint32_t st = base + S::kStage0 + s * S::kStageBytes;
          const unsigned char* stp = smem + S::kStage0 + s * S::kStageBytes;
          const int n0 = t * kBN;

          // S = Q K^T, overwritten by the first k-step: acc[4j + e] = (r, 8j + 2c + e),
          // acc[4j + 2 + e] = (r + 8, 8j + 2c + e). Each box's descriptors
          // step 32 bytes (16 columns) a k-step within its swizzled rows.
          float acc[64];
          reg_fence(acc);
          wg_fence();
#pragma unroll
          for (int i = 0; i < X::kN64; ++i) {
            const uint64_t dq = make_desc(qs + kBM * 128 * i + wg * kWGRows * 128, 16, 1024, kSw128);
            const uint64_t dk = make_desc(st + S::kK + kBN * 128 * i, 16, 1024, kSw128);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma_ss_n128(acc, dq + 2 * kk, dk + 2 * kk, i > 0 || kk > 0);
            }
          }
          if constexpr (X::k32) {
            const uint64_t dq =
                make_desc(qs + kBM * 2 * X::kCol32 + wg * kWGRows * 64, 16, 512, kSw64);
            const uint64_t dk = make_desc(st + S::kK + kBN * 2 * X::kCol32, 16, 512, kSw64);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              wgmma_ss_n128(acc, dq + 2 * kk, dk + 2 * kk, X::kN64 > 0 || kk > 0);
            }
          }
          if constexpr (X::k16) {
            const uint64_t dq =
                make_desc(qs + kBM * 2 * X::kCol16 + wg * kWGRows * 32, 16, 256, kSw32);
            const uint64_t dk = make_desc(st + S::kK + kBN * 2 * X::kCol16, 16, 256, kSw32);
            wgmma_ss_n128(acc, dq, dk, HD > 16);
          }
          wg_commit();
          wg_wait<0>();
          reg_fence(acc);

          // scale and biases, in log2 units
          const float* kb = reinterpret_cast<const float*>(stp + S::kKB);
#pragma unroll
          for (int jj = 0; jj < kBN / 8; ++jj) {
            const float2 x = *reinterpret_cast<const float2*>(kb + 8 * jj + 2 * c);
            acc[4 * jj + 0] = fmaf(acc[4 * jj + 0], sl2, x.x);
            acc[4 * jj + 1] = fmaf(acc[4 * jj + 1], sl2, x.y);
            acc[4 * jj + 2] = fmaf(acc[4 * jj + 2], sl2, x.x);
            acc[4 * jj + 3] = fmaf(acc[4 * jj + 3], sl2, x.y);
          }
          if constexpr (kHBTma) {
            // the 128 x 128 tile as two 64-key halves of 128-byte rows, 16-byte
            // chunks swizzled by row % 8 (== g for both of this thread's rows)
            const unsigned char* hb = stp + S::kHB + c * 4;
#pragma unroll
            for (int jj = 0; jj < kBN / 8; ++jj) {
              const unsigned char* col = hb + (jj / 8) * S::kHBHalf + (((jj % 8) ^ g) * 16);
              const uint32_t x = *reinterpret_cast<const uint32_t*>(col + r * S::kHBRow);
              const uint32_t y = *reinterpret_cast<const uint32_t*>(col + (r + 8) * S::kHBRow);
              acc[4 * jj + 0] = fmaf(bf16_lo(x), kLog2e, acc[4 * jj + 0]);
              acc[4 * jj + 1] = fmaf(bf16_hi(x), kLog2e, acc[4 * jj + 1]);
              acc[4 * jj + 2] = fmaf(bf16_lo(y), kLog2e, acc[4 * jj + 2]);
              acc[4 * jj + 3] = fmaf(bf16_hi(y), kLog2e, acc[4 * jj + 3]);
            }
          } else if constexpr (kHB) {
            const bool v0 = row0 < L, v1 = row1 < L;
#pragma unroll
            for (int jj = 0; jj < kBN / 8; ++jj) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = n0 + 8 * jj + 2 * c + e;
                const float x = (v0 && n < L) ? to_float(hb0[n]) : 0.0f;
                const float y = (v1 && n < L) ? to_float(hb1[n]) : 0.0f;
                acc[4 * jj + e] = fmaf(x, kLog2e, acc[4 * jj + e]);
                acc[4 * jj + 2 + e] = fmaf(y, kLog2e, acc[4 * jj + 2 + e]);
              }
            }
          }
          if constexpr (CAUSAL) {
            if (n0 + kBN - 1 > m0 + wg * kWGRows) {  // the tile crosses this warpgroup's diagonal
#pragma unroll
              for (int jj = 0; jj < kBN / 8; ++jj) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int n = n0 + 8 * jj + 2 * c + e;
                  if (n > row0) acc[4 * jj + e] += kNegInf * kLog2e;
                  if (n > row1) acc[4 * jj + 2 + e] += kNegInf * kLog2e;
                }
              }
            }
          }

          // online softmax: row max over the quad, rescale, exp2, partial sums
          float mx_a = m_a, mx_b = m_b;
#pragma unroll
          for (int jj = 0; jj < kBN / 8; ++jj) {
            mx_a = fmaxf(mx_a, fmaxf(acc[4 * jj + 0], acc[4 * jj + 1]));
            mx_b = fmaxf(mx_b, fmaxf(acc[4 * jj + 2], acc[4 * jj + 3]));
          }
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
          const float alpha_a = ex2(m_a - mx_a);  // 0 on the first tile (m = -inf)
          const float alpha_b = ex2(m_b - mx_b);
          m_a = mx_a;
          m_b = mx_b;
          float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
          for (int jj = 0; jj < kBN / 8; ++jj) {
            acc[4 * jj + 0] = ex2(acc[4 * jj + 0] - mx_a);
            acc[4 * jj + 1] = ex2(acc[4 * jj + 1] - mx_a);
            acc[4 * jj + 2] = ex2(acc[4 * jj + 2] - mx_b);
            acc[4 * jj + 3] = ex2(acc[4 * jj + 3] - mx_b);
            sum_a += acc[4 * jj + 0] + acc[4 * jj + 1];
            sum_b += acc[4 * jj + 2] + acc[4 * jj + 3];
          }
          l_a = l_a * alpha_a + sum_a;
          l_b = l_b * alpha_b + sum_b;
#pragma unroll
          for (int i = 0; i < X::kN64; ++i) rescale(o64[i], alpha_a, alpha_b);
          if constexpr (X::k32) rescale(o32, alpha_a, alpha_b);
          if constexpr (X::k16) rescale(o16, alpha_a, alpha_b);

          // P in bf16, in the A-operand layout of m64nNk16 (keys 16kk .. 16kk + 15)
          uint32_t pf[kBN / 16][4];
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk) {
            pf[kk][0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
            pf[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
            pf[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
            pf[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
          }

          // O += P V, a box at a time (V MN-major: 16 keys = 16 rows of the
          // box per k-step)
#pragma unroll
          for (int i = 0; i < X::kN64; ++i) reg_fence(o64[i]);
          if constexpr (X::k32) reg_fence(o32);
          if constexpr (X::k16) reg_fence(o16);
          reg_fence(pf);
          wg_fence();
#pragma unroll
          for (int i = 0; i < X::kN64; ++i) {
            const uint64_t dv = make_desc(st + S::kV + kBN * 128 * i, kBN * 128, 1024, kSw128);
#pragma unroll
            for (int kk = 0; kk < kBN / 16; ++kk) {
              wgmma_rs_n64(o64[i], pf[kk], dv + ((16 * 128 * kk) >> 4));
            }
          }
          if constexpr (X::k32) {
            const uint64_t dv = make_desc(st + S::kV + kBN * 2 * X::kCol32, kBN * 64, 512, kSw64);
#pragma unroll
            for (int kk = 0; kk < kBN / 16; ++kk) {
              wgmma_rs_n32(o32, pf[kk], dv + ((16 * 64 * kk) >> 4));
            }
          }
          if constexpr (X::k16) {
            const uint64_t dv = make_desc(st + S::kV + kBN * 2 * X::kCol16, kBN * 32, 256, kSw32);
#pragma unroll
            for (int kk = 0; kk < kBN / 16; ++kk) {
              wgmma_rs_n16(o16, pf[kk], dv + ((16 * 32 * kk) >> 4));
            }
          }
          wg_commit();
          wg_wait<0>();
#pragma unroll
          for (int i = 0; i < X::kN64; ++i) reg_fence(o64[i]);
          if constexpr (X::k32) reg_fence(o32);
          if constexpr (X::k16) reg_fence(o16);
          reg_fence(pf);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      }

      // ---- epilogue: normalise, stage bf16 in this warpgroup's rows of the
      // item's Q buffer (the TMA box layout), one TMA store per box (rows
      // past L are not stored); then the Q buffer is free
      if (active) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
        l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
        const float inv_a = 1.0f / l_a;
        const float inv_b = 1.0f / l_b;
        unsigned char* oq = smem + qb * S::kQBuf;
#pragma unroll
        for (int i = 0; i < X::kN64; ++i) stage_out<64>(oq + kBM * 128 * i, o64[i], r, c, inv_a, inv_b);
        if constexpr (X::k32) stage_out<32>(oq + kBM * 2 * X::kCol32, o32, r, c, inv_a, inv_b);
        if constexpr (X::k16) stage_out<16>(oq + kBM * 2 * X::kCol16, o16, r, c, inv_a, inv_b);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
        if (threadIdx.x % 128 == 0) {
          const uint32_t qs_wg = base + qb * S::kQBuf;
          const int rows = m0 + wg * kWGRows;
#pragma unroll
          for (int i = 0; i < X::kN64; ++i) {
            tma_store(&p.o[0], qs_wg + kBM * 128 * i + wg * kWGRows * 128, h * HD + 64 * i,
                      rows, b);
          }
          if (X::k32) {
            tma_store(&p.o[1], qs_wg + kBM * 2 * X::kCol32 + wg * kWGRows * 64,
                      h * HD + X::kCol32, rows, b);
          }
          if (X::k16) {
            tma_store(&p.o[2], qs_wg + kBM * 2 * X::kCol16 + wg * kWGRows * 32,
                      h * HD + X::kCol16, rows, b);
          }
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        }
      }
      if (threadIdx.x % 128 == 0) mbar_arrive(bar_q_empty + 8 * qb);
    }
  }
}

// ---- host side: dispatch

// One persistent block per SM (each holds one: its registers and shared
// memory), or one per item if there are fewer items.
template <int HD, typename HB, bool kHBTma, bool CAUSAL>
int launch(const Params& p, cudaStream_t stream) {
  using S = Smem<HD, kHBTma>;
  auto kernel = attention_kernel<HD, HB, kHBTma, CAUSAL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.items < sms ? p.items : sms, kThreads, S::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD, typename HB, bool kHBTma>
int launch_causal(const Params& p, int causal, cudaStream_t stream) {
  return causal ? launch<HD, HB, kHBTma, true>(p, stream)
                : launch<HD, HB, kHBTma, false>(p, stream);
}

// hb_mode: 0 none, 1 bf16 by TMA, 2 bf16 read directly, 3 fp32 read directly
template <int HD>
int launch_head_bias(const Params& p, int hb_mode, int causal, cudaStream_t stream) {
  switch (hb_mode) {
    case 0: return launch_causal<HD, NoHeadBias, false>(p, causal, stream);
    case 1:
      if constexpr (kHBTmaFits<HD>) return launch_causal<HD, __nv_bfloat16, true>(p, causal, stream);
      return (int)cudaErrorInvalidValue;
    case 2: return launch_causal<HD, __nv_bfloat16, false>(p, causal, stream);
    default: return launch_causal<HD, float, false>(p, causal, stream);
  }
}

// the maps of q, k, v or out at one box width, if HD has a box of it
int make_maps(CUtensorMap (&maps)[3], const void* ptr, int hd, uint64_t C, int L, int B,
              uint64_t row_bytes, uint64_t batch_bytes, uint32_t rows) {
  if (hd >= 64) {
    TRY(make_map(&maps[0], ptr, C, L, B, row_bytes, batch_bytes, 64, rows,
                 CU_TENSOR_MAP_SWIZZLE_128B));
  }
  if (hd % 64 >= 32) {
    TRY(make_map(&maps[1], ptr, C, L, B, row_bytes, batch_bytes, 32, rows,
                 CU_TENSOR_MAP_SWIZZLE_64B));
  }
  if (hd % 32 == 16) {
    TRY(make_map(&maps[2], ptr, C, L, B, row_bytes, batch_bytes, 16, rows,
                 CU_TENSOR_MAP_SWIZZLE_32B));
  }
  return 0;
}

// this library's head widths: K2_HD_FIRST + 16 i for each i of the sequence
using Widths = std::make_integer_sequence<int, (K2_HD_LAST - K2_HD_FIRST) / 16 + 1>;
template <int I>
constexpr int kWidth = K2_HD_FIRST + 16 * I;

template <int... I>
int dispatch(std::integer_sequence<int, I...>, const Params& p, int hd, int hb_mode, int causal,
             cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  ((hd == kWidth<I> ? (err = launch_head_bias<kWidth<I>>(p, hb_mode, causal, stream), true)
                    : false) || ...);
  return err;
}

template <int... I>
bool takes(std::integer_sequence<int, I...>, int hd, int hb_tma) {
  return ((hd == kWidth<I> && (!hb_tma || kHBTmaFits<kWidth<I>>)) || ...);
}

}  // namespace

extern "C" {

// q/k/v [B, L, H*hd] bf16 with unit stride in the last dim and the given batch
// and row strides (in elements, multiples of 8, 16-byte aligned base); bias
// [B, L] fp32 contiguous or null; head_bias [H, L, L] contiguous, bf16 when
// head_bias_bf16 is non-zero, else fp32, or null; causal 0 or 1; out
// [B, L, H*hd] bf16 contiguous. hd is one of this library's widths. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for another hd), or
// 10000 + the CUresult of a failed cuTensorMapEncodeTiled, or 20000 if the
// driver has no cuTensorMapEncodeTiled.
int attention_bf16(const void* q, const void* k, const void* v, const void* bias,
                   const void* head_bias, int head_bias_bf16, void* out, int B, int L, int H,
                   int hd, long long sqb, long long sql, long long skb, long long skl,
                   long long svb, long long svl, float sm_scale, int causal, void* stream) {
  if (!takes(Widths{}, hd, 0)) return (int)cudaErrorInvalidValue;
  Params p{};
  const uint64_t C = (uint64_t)H * hd;
  TRY(make_maps(p.q, q, hd, C, L, B, sql * 2, sqb * 2, kBM));
  TRY(make_maps(p.k, k, hd, C, L, B, skl * 2, skb * 2, kBN));
  TRY(make_maps(p.v, v, hd, C, L, B, svl * 2, svb * 2, kBN));
  TRY(make_maps(p.o, out, hd, C, L, B, C * 2, C * L * 2, kWGRows));
  // head-bias modes: 0 none, 1 bf16 by TMA (rows of L * 2 bytes, a multiple
  // of 16, where the tiles fit in shared memory), 2 bf16 read directly, 3
  // fp32 read directly
  int hb_mode = 0;
  if (head_bias) {
    const bool tma = head_bias_bf16 && L % 8 == 0 && (uintptr_t)head_bias % 16 == 0 &&
                     takes(Widths{}, hd, 1);
    hb_mode = tma ? 1 : (head_bias_bf16 ? 2 : 3);
    if (tma) {
      TRY(make_map(&p.hb, head_bias, L, L, H, (uint64_t)L * 2, (uint64_t)L * L * 2, 64, kBM,
                   CU_TENSOR_MAP_SWIZZLE_128B));
    }
  }
  p.bias = static_cast<const float*>(bias);
  p.head_bias = head_bias;
  p.L = L;
  p.H = H;
  p.B = B;
  p.nm = (L + kBM - 1) / kBM;
  p.items = p.nm * H * B;
  p.scale_log2 = sm_scale * kLog2e;
  return dispatch(Widths{}, p, hd, hb_mode, causal, (cudaStream_t)stream);
}

}  // extern "C"
