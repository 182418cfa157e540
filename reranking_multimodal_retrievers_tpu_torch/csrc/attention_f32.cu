// K2, fp32 path: fused multi-head self-attention over fp32 q/k/v for Hopper
// (sm_90a), at every head_dim that is a multiple of 16 from 16 to 128, on the
// tensor cores in 3xTF32 (every other head_dim runs csrc/attention_any.cu).
//
// ops/_build.py builds this file into one library a group of head widths
// (K2_GROUPS), compiled in parallel: each exports attention_f32 for every
// multiple of 16 from K2_HD_FIRST to K2_HD_LAST.
//
// Replaces reranking_multimodal_retrievers_tpu/ops/attention_pallas.py::
// fused_self_attention (pallas_call at :175, body _attn_kernel at :36) where
// it is called with fp32 inputs: the TPU kernel takes any float dtype and
// accumulates in fp32 (preferred_element_type), and the executors keep their
// parameters in fp32, so BERT under use_pallas_attention (and an fp32 T5
// encoder or OPT) hands it fp32 q/k/v. The bf16 inputs go to
// csrc/attention.cu. It computes
//     out = softmax(Q K^T * sm_scale + key_bias [+ head_bias] [+ causal]) V
// per (batch row, head), reading Q/K/V in the projection layout
// [B, L, heads * hd] through strides, with the padding mask as an additive
// [B, L] fp32 key bias (0 keep / -1e9 drop), an optional per-head additive
// bias [heads, L, L] in bf16 or fp32 shared over the batch (T5's relative
// positions) and an optional causal mask that adds -1e9 where key > query.
//
// The route: 3xTF32 on the tensor cores. Each fp32 operand x is split into
// hi, x rounded to TF32 (to nearest, ties away from zero: cvt.rna's
// rounding, done in two integer operations), and lo, x - hi rounded the
// same way, and each product is lo*hi + hi*lo + hi*hi, the two small terms
// first, by mma.sync.m16n8k8.tf32 with fp32 sums, for Q K^T and for P V
// alike: the error stays near fp32 round-off, as CUTLASS's
// OpMultiplyAddFastF32 keeps it, where one TF32 product keeps about three
// decimal digits (the split and the products are in mma_sync.cuh, shared
// with attention_any.cu). The tensor cores truncate each sum they keep, so
// Q K^T sums its small terms apart from its large ones and P V sums each tile
// from zero, adding to O in fp32 (at scores of std 8 that brings the
// error against fp64 below the plain fp32 version's, see PERF.md). The
// scores leave the tensor cores before any bias is added: -1e9 never meets
// a TF32 operand. mma.sync and not wgmma: these shapes are bound by bytes
// (below), and TF32 wgmma takes B only K-major, so P V would need V
// transposed in shared memory.
//
// What bounds it on an H100: 4*B*H*L*L*hd operations, three times over in
// TF32 (495 TFLOP/s), against q, k, v and out in fp32 (16*B*L*H*hd bytes)
// plus the biases, at 3.35 TB/s. That is 3*L/4 TF32 operations a byte
// against the card's 148: bytes bound every L below ~200, so at the
// executors' shapes: 0.030 ms at the cross-encoder's [50, 161, 12 x 64],
// 0.0056 ms at the doc encoder's [64, 24, 12 x 64]. What holds it back
// (PERF.md): three mma.sync products for each fp32 product, and each warp
// splitting every K and V fragment it reads.
//
// Design:
// - A block is 4 warps; a work item is 64 query rows (16 a warp) of one
//   (batch row, head). At L <= 32 an item is 2 heads of 32 rows, at L <= 16
//   4 heads of 16: the 4 warps always have rows to do. Blocks are
//   persistent (two an SM) and walk items blockIdx.x, + gridDim.x, ...;
//   under the causal mask the heaviest query blocks come first. The 8-key
//   column tiles of a head in a tile (8, 4 or 2) are a template constant,
//   so the product loops have no branches and the compiler interleaves the
//   independent sums.
// - K and V tiles of 64 keys (and the key bias) come by 16-byte cp.async
//   into a two-stage ring, Q by the same copies into its own buffer at an
//   item's first tile; the copies of the next tile, of this item or of the
//   next one, are in flight while the warps compute this one. A thread
//   copies one 16-byte column of every eighth row, so its source moves by
//   whole rows. Rows past L are zero-filled; their key bias is -inf, so
//   they get no weight.
// - No shuffles between the two products: the key order of each 8-key
//   k-step of P V is permuted (k-slot t holds key 2t, slot t + 4 key 2t + 1),
//   so the C fragment of Q K^T is the A fragment of P V as it stands, and V
//   is read at those rows. The head dims are permuted likewise (a thread's
//   k-slots of two k-steps are four consecutive dims), so Q, K and V
//   fragments come as float4 shared loads. Q and K rows are unpadded (where
//   hd is a multiple of 32, odd rows flip chunk bit 2; rows of 16 mod 32
//   words need nothing) and V rows padded by 4 words: every fragment load is
//   free of bank conflicts.
// - Up to hd 80 a warp keeps its Q fragments in registers for the whole
//   item. From hd 96 it reads them from shared memory at every tile, and
//   items alternate between two Q buffers, so that the next item's Q can
//   land while this one's last tile is computed: at hd 128 O alone is 64
//   registers a thread. P V runs over at most 64 head dims at a time, so
//   that its per-tile sums take 32 registers at any width.
// - S stays in registers; scale, key bias, head bias (loaded into registers
//   before the products) and the causal -1e9 are added there in fp32, in
//   the plain version's order; the online softmax runs once a tile (exp2f
//   with log2 e folded in after the max is subtracted, so -1e9-sized scores
//   cancel exactly). O stays in fp32 registers, is normalised once and
//   written from registers.
// - Under the causal mask, key tiles wholly above an item's last row are
//   not visited. This equals the full sum whenever each query row keeps a
//   key at or before it that its key bias leaves unmasked, or has none at
//   all (a fully masked row averages V over the keys up to itself, as the
//   plain version does); it differs only for a row whose keys up to itself
//   are all masked while a later key is not (left padding), as in the bf16
//   kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "mma_sync.cuh"

#if !defined(K2_HD_FIRST) || !defined(K2_HD_LAST)
#error "define K2_HD_FIRST and K2_HD_LAST, the head widths this library instantiates"
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 64;  // query rows an item (16 a warp)
constexpr int kBN = 64;  // keys a tile
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e9f;  // the TPU kernel's causal mask value

template <int HD>
struct Layout {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "head_dim a multiple of 16 up to 128");
  static constexpr bool kSwizzle = HD % 32 == 0;
  static constexpr bool kQInRegs = HD <= 80;  // else two Q buffers, read at every tile
  static constexpr int kQBufs = kQInRegs ? 1 : 2;
  static constexpr int kVStride = HD + 4;  // V rows: 4 mod 16 words
  // offsets in floats: the Q buffer(s), then two stages of K, V, key bias
  static constexpr int kStage0 = kQBufs * kBM * HD;
  static constexpr int kV = kBN * HD;
  static constexpr int kKB = kV + kBN * kVStride;
  static constexpr int kStage = kKB + kBN;
  static constexpr int kBytes = (kStage0 + 2 * kStage) * 4;
};

// the word offset of chunk c of row r of a Q or K tile
template <int HD>
__device__ __forceinline__ int qk_off(int r, int c) {
  return r * HD + 4 * (Layout<HD>::kSwizzle ? c ^ ((r & 1) << 2) : c);
}

struct NoHeadBias {};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* key_bias;   // [B, L] or null
  const void* head_bias;   // [H, L, L] or null
  float* out;              // [B, L, H * hd] contiguous
  long long qs0, qs1, ks0, ks1, vs0, vs1;
  int B, L, H;
  int slot_shift;  // log2 of the rows of one head in an item: 6, 5 or 4
  int groups;      // head groups of 64 >> slot_shift heads
  int qblocks;     // query blocks of kBM rows (1 when an item holds several heads)
  int items;
  int causal;
  float sm_scale;
};

struct Item {
  int b, h0, qb, tiles;
};

__device__ __forceinline__ Item decode(const Params& p, int it) {
  int qb, rest;
  if (p.causal) {  // the heaviest query blocks first
    qb = p.qblocks - 1 - it / (p.B * p.groups);
    rest = it % (p.B * p.groups);
  } else {  // the query blocks of one (batch row, head) side by side
    qb = it % p.qblocks;
    rest = it / p.qblocks;
  }
  Item x;
  x.b = rest / p.groups;
  x.h0 = (rest % p.groups) << (6 - p.slot_shift);
  x.qb = qb;
  const int key_end = p.causal ? min(p.L, (qb + 1) * kBM) : p.L;
  x.tiles = (key_end + kBN - 1) / kBN;
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Copy 64 rows of one head-dim slice of q, k or v ([B, L, H * HD] with row
// stride rs) into a tile whose rows are `stride` words apart: row r holds
// row row0 + (r & (slot rows - 1)) of head h0 + (r >> kSlotShift), zeros
// past L or past the heads. The 16-byte chunks of a row are copied in
// passes of 16, 8 or 4 chunks, largest first (hd 80: 16 + 4, hd 112:
// 16 + 8 + 4): in a pass of W chunks thread t copies chunk t % W of rows
// t / W + (128 / W) i. With one head an item its source moves by whole
// rows, and its destinations are constant offsets.
template <int HD, int kSlotShift, bool kQK, int kStart = 0>
__device__ __forceinline__ void copy_rows(float* tile, int stride, const float* base,
                                          long long rs, int row0, int h0, int L, int H) {
  constexpr int kChunks = HD / 4;
  if constexpr (kStart < kChunks) {
    constexpr int kLeft = kChunks - kStart;
    constexpr int W = kLeft >= 16 ? 16 : (kLeft >= 8 ? 8 : 4);
    constexpr int kStep = kThreads / W;  // rows a pass covers at once
    constexpr int kSlotRows = 1 << kSlotShift;
    const int t = threadIdx.x;
    const int c = kStart + t % W;
    const int r0 = t / W;
    const float* src = base + (long long)h0 * HD + 4 * c + (long long)(row0 + r0) * rs;
    // the word offset of chunk c of row r0, swizzled as qk_off; r0 and
    // r0 + kStep i share their parity
    const int dst0 = r0 * stride + 4 * ((kQK && Layout<HD>::kSwizzle) ? c ^ ((r0 & 1) << 2) : c);
#pragma unroll
    for (int i = 0; i < kBM / kStep; ++i) {
      const int rr = kStep * i, r = r0 + rr;
      // one head an item: row r is row row0 + r of head h0
      const int slot = kSlotShift == 6 ? 0 : r >> kSlotShift;
      const int j = kSlotShift == 6 ? r : r & (kSlotRows - 1);
      const bool ok = row0 + j < L && h0 + slot < H;
      const float* from = kSlotShift == 6
          ? src + rr * rs
          : base + (long long)(h0 + slot) * HD + 4 * c + (long long)(row0 + j) * rs;
      cp_async16(tile + dst0 + rr * stride, ok ? from : base, ok);
    }
    copy_rows<HD, kSlotShift, kQK, kStart + W>(tile, stride, base, rs, row0, h0, L, H);
  }
}

// Issue the copies of one step: K, V and the key bias of key tile `tile` of
// item `it` into stage `st`, and its Q rows into `qbuf` when with_q.
template <int HD, int kSlotShift>
__device__ __forceinline__ void load_step(const Params& p, const Item& it, int tile, float* st,
                                          float* qbuf, bool with_q) {
  using Ly = Layout<HD>;
  constexpr int kSlotRows = 1 << kSlotShift;
  const int k0 = tile * kBN;
  copy_rows<HD, kSlotShift, true>(st, HD, p.k + it.b * p.ks0, p.ks1, k0, it.h0, p.L, p.H);
  copy_rows<HD, kSlotShift, false>(st + Ly::kV, Ly::kVStride, p.v + it.b * p.vs0, p.vs1, k0,
                                   it.h0, p.L, p.H);
  if (threadIdx.x < kBN) {
    const int r = threadIdx.x;
    const int h = it.h0 + (r >> kSlotShift), key = k0 + (r & (kSlotRows - 1));
    float* dst = st + Ly::kKB + r;
    if (key >= p.L || h >= p.H)
      *dst = -INFINITY;  // not a key: no weight
    else if (p.key_bias)
      cp_async4(dst, p.key_bias + (long long)it.b * p.L + key);
    else
      *dst = 0.f;
  }
  if (with_q)
    copy_rows<HD, kSlotShift, true>(qbuf, HD, p.q + it.b * p.qs0, p.qs1, it.qb * kBM, it.h0,
                                    p.L, p.H);
}

// NJ: the 8-key column tiles of one head's keys in a tile (8, or 4 and 2
// when an item holds 2 or 4 heads), a constant so that the product loops
// have no branches
template <int HD, typename HB, int NJ>
__global__ void __launch_bounds__(kThreads, 2) attention_f32_kernel(const Params p) {
  using Ly = Layout<HD>;
  constexpr bool kHB = !std::is_same<HB, NoHeadBias>::value;
  constexpr int kSlotShift = NJ == 8 ? 6 : (NJ == 4 ? 5 : 4);
  constexpr int kPairs = HD / 16;  // pairs of 8-dim k-steps of Q K^T (one float4 a thread)
  constexpr int kNT = HD / 8;      // 8-dim n-tiles of P V
  // P V's column blocks: kQ32 of 32 dims (n-tiles 4q .. 4q + 3: dim 32q +
  // 4g + u for column g of n-tile 4q + u), then one of 16 if hd % 32 == 16
  // (n-tiles 4 kQ32 + u: dim 32 kQ32 + 2g + u); P V sums kBlocksPerPass
  // blocks a pass
  constexpr int kQ32 = HD / 32;
  constexpr bool kR16 = HD % 32 == 16;
  constexpr int kBlocks = kQ32 + (kR16 ? 1 : 0);
  constexpr int kBlocksPerPass = Ly::kQInRegs ? kBlocks : 2;
  constexpr int kPasses = (kBlocks + kBlocksPerPass - 1) / kBlocksPerPass;
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the warp's head slot in an item, its first row in the slot, and the
  // slot's first row in the Q, K and V tiles
  const int slot = (warp * 16) >> kSlotShift;
  const int row_in_slot = (warp * 16) & ((1 << kSlotShift) - 1);
  const int slot_base = slot << kSlotShift;

  int item = blockIdx.x;
  if (item >= p.items) return;
  Item cur = decode(p, item);
  int jq = 0;  // the block's items so far: with two Q buffers, item jq's is jq & 1
  load_step<HD, kSlotShift>(p, cur, 0, smem + Ly::kStage0, smem, true);
  cp_commit();

  float qv[Ly::kQInRegs ? kPairs : 1][2][4];  // the warp's Q rows g and g + 8, as loaded
  float o[kNT][4];
  float m[2], l[2];
  int tile = 0, stage = 0;
  for (;;) {
    Item nxt = cur;
    int ntile = tile + 1, nitem = item;
    bool has_next = true;
    if (ntile == cur.tiles) {
      nitem = item + gridDim.x;
      ntile = 0;
      has_next = nitem < p.items;
      if (has_next) nxt = decode(p, nitem);
    }
    cp_wait_all();
    __syncthreads();  // this step's copies landed; every warp is done with the last step

    const int h = cur.h0 + slot;
    const int row0 = cur.qb * kBM + row_in_slot;  // the warp's first query row
    const bool active = h < p.H && row0 < p.L;
    const float* qbuf = smem + (Ly::kQBufs == 2 ? (jq & 1) * kBM * HD : 0);
    if (tile == 0 && active) {
#pragma unroll
      for (int pp = 0; pp < (Ly::kQInRegs ? kPairs : 0); ++pp)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float4 x = *reinterpret_cast<const float4*>(
              qbuf + qk_off<HD>(warp * 16 + g + 8 * rr, 4 * pp + t));
          qv[pp][rr][0] = x.x;
          qv[pp][rr][1] = x.y;
          qv[pp][rr][2] = x.z;
          qv[pp][rr][3] = x.w;
        }
#pragma unroll
      for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
    }
    // with one Q buffer, an item of one tile reads Q in the step that would
    // copy the next Q
    if (Ly::kQBufs == 1 && has_next && ntile == 0 && tile == 0) __syncthreads();
    if (has_next) {
      float* nq = smem + (Ly::kQBufs == 2 ? ((jq + 1) & 1) * kBM * HD : 0);
      load_step<HD, kSlotShift>(p, nxt, ntile, smem + Ly::kStage0 + (stage ^ 1) * Ly::kStage, nq,
                                ntile == 0);
      cp_commit();
    }

    if (active) {
      const float* st = smem + Ly::kStage0 + stage * Ly::kStage;
      const int k0 = tile * kBN;

      float hb[NJ][4];
      if constexpr (kHB) {
        const HB* base = static_cast<const HB*>(p.head_bias) + (long long)h * p.L * p.L;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1), r = row0 + g + 8 * (e >> 1);
            hb[j][e] = (key < p.L && r < p.L) ? to_float(base[(long long)r * p.L + key]) : 0.f;
          }
      }

      // S = Q K^T: the large and the small products summed apart, then added
      // in fp32
      float s[NJ][4], ss[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = ss[j][e] = 0.f;
#pragma unroll
      for (int pp = 0; pp < kPairs; ++pp) {
        float qr[2][4];  // this pair's Q values, from registers or from the Q buffer
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if constexpr (Ly::kQInRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qr[rr][e] = qv[pp][rr][e];
          } else {
            const float4 x = *reinterpret_cast<const float4*>(
                qbuf + qk_off<HD>(warp * 16 + g + 8 * rr, 4 * pp + t));
            qr[rr][0] = x.x;
            qr[rr][1] = x.y;
            qr[rr][2] = x.z;
            qr[rr][3] = x.w;
          }
        }
        // k-step 2pp + kk: slot t holds dim 16pp + 4t + 2kk, slot t + 4 the next
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          split(qr[0][2 * kk], ah[kk][0], al[kk][0]);
          split(qr[1][2 * kk], ah[kk][1], al[kk][1]);
          split(qr[0][2 * kk + 1], ah[kk][2], al[kk][2]);
          split(qr[1][2 * kk + 1], ah[kk][3], al[kk][3]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              st + qk_off<HD>(slot_base + 8 * j + g, 4 * pp + t));
          mma3(s[j], ss[j], ah[0], al[0], kv.x, kv.y);
          mma3(s[j], ss[j], ah[1], al[1], kv.z, kv.w);
        }
      }

      // scores in the plain version's order, then the online softmax
      const float* kb = st + Ly::kKB + slot_base;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // kb is -inf past L: those keys get no weight
          const int col = 8 * j + 2 * t + (e & 1);
          float x = __fadd_rn(__fmul_rn(__fadd_rn(s[j][e], ss[j][e]), p.sm_scale), kb[col]);
          if constexpr (kHB) x = __fadd_rn(x, hb[j][e]);
          if (p.causal && k0 + col > row0 + g + 8 * (e >> 1)) x = __fadd_rn(x, kNegInf);
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], ms[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        ms[rr] = fmaxf(m[rr], mx[rr]);  // finite: the tile's first key is < L
        alpha[rr] = exp2f((m[rr] - ms[rr]) * kLog2e);
        m[rr] = ms[rr];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f((s[j][e] - ms[e >> 1]) * kLog2e);
          lsum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + lsum[rr];
      // O = alpha O + P V: the tile's P V summed from zero, then added in
      // fp32 (the tensor cores truncate a tile's sum, not O's over every
      // tile); the C fragment of S is P's A fragment (keys 2t, 2t + 1)
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        float pv[4 * kBlocksPerPass][4];
#pragma unroll
        for (int n = 0; n < 4 * kBlocksPerPass; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t ah[4], al[4];
          split(s[j][0], ah[0], al[0]);
          split(s[j][2], ah[1], al[1]);
          split(s[j][1], ah[2], al[2]);
          split(s[j][3], ah[3], al[3]);
          const float* v0 = st + Ly::kV + (slot_base + 8 * j + 2 * t) * Ly::kVStride;
          const float* v1 = v0 + Ly::kVStride;
#pragma unroll
          for (int qq = 0; qq < kBlocksPerPass; ++qq) {
            const int q = ps * kBlocksPerPass + qq;
            if (q < kQ32) {  // n-tile 4q + u, column g: dim 32q + 4g + u
              const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * q + 4 * g);
              const float4 x1 = *reinterpret_cast<const float4*>(v1 + 32 * q + 4 * g);
              mma3(pv[4 * qq + 0], ah, al, x0.x, x1.x);
              mma3(pv[4 * qq + 1], ah, al, x0.y, x1.y);
              mma3(pv[4 * qq + 2], ah, al, x0.z, x1.z);
              mma3(pv[4 * qq + 3], ah, al, x0.w, x1.w);
            } else if (kR16 && q == kQ32) {  // n-tile 4q + u, column g: dim 32q + 2g + u
              const float2 y0 = *reinterpret_cast<const float2*>(v0 + 32 * q + 2 * g);
              const float2 y1 = *reinterpret_cast<const float2*>(v1 + 32 * q + 2 * g);
              mma3(pv[4 * qq + 0], ah, al, y0.x, y1.x);
              mma3(pv[4 * qq + 1], ah, al, y0.y, y1.y);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 4 * kBlocksPerPass; ++n) {
          const int nt = 4 * ps * kBlocksPerPass + n;
          if (nt < kNT) {
#pragma unroll
            for (int e = 0; e < 4; ++e) o[nt][e] = __fmaf_rn(o[nt][e], alpha[e >> 1], pv[n][e]);
          }
        }
      }

      if (tile == cur.tiles - 1) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float sum = l[rr];
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          const float inv = 1.f / sum;
          const int row = row0 + g + 8 * rr;
          if (row < p.L) {
            float* orow = p.out + ((long long)cur.b * p.L + row) * p.H * HD + (long long)h * HD;
            const int c0 = 2 * rr, c1 = 2 * rr + 1;  // C columns 2t and 2t + 1
#pragma unroll
            for (int q = 0; q < kQ32; ++q) {
              *reinterpret_cast<float4*>(orow + 32 * q + 8 * t) =
                  make_float4(o[4 * q][c0] * inv, o[4 * q + 1][c0] * inv,
                              o[4 * q + 2][c0] * inv, o[4 * q + 3][c0] * inv);
              *reinterpret_cast<float4*>(orow + 32 * q + 8 * t + 4) =
                  make_float4(o[4 * q][c1] * inv, o[4 * q + 1][c1] * inv,
                              o[4 * q + 2][c1] * inv, o[4 * q + 3][c1] * inv);
            }
            if constexpr (kR16) {
              constexpr int q = kQ32;
              *reinterpret_cast<float4*>(orow + 32 * q + 4 * t) =
                  make_float4(o[4 * q][c0] * inv, o[4 * q + 1][c0] * inv, o[4 * q][c1] * inv,
                              o[4 * q + 1][c1] * inv);
            }
          }
        }
      }
    }

    if (!has_next) break;
    if (ntile == 0) ++jq;
    cur = nxt;
    item = nitem;
    tile = ntile;
    stage ^= 1;
  }
}

template <int HD, typename HB, int NJ>
int launch(const Params& p, cudaStream_t stream) {
  using Ly = Layout<HD>;
  // blocks resident on the whole card, per device (0 until first asked)
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return -2;
  if (resident[dev] == 0) {
    auto kern = attention_f32_kernel<HD, HB, NJ>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly::kBytes);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, Ly::kBytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    resident[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const int grid = p.items < resident[dev] ? p.items : resident[dev];
  attention_f32_kernel<HD, HB, NJ><<<grid, kThreads, Ly::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD, typename HB>
int launch_slots(const Params& p, cudaStream_t stream) {
  if (p.slot_shift == 6) return launch<HD, HB, 8>(p, stream);
  if (p.slot_shift == 5) return launch<HD, HB, 4>(p, stream);
  return launch<HD, HB, 2>(p, stream);
}

template <int HD>
int launch_head_bias(const Params& p, int hb_mode, cudaStream_t stream) {
  if (hb_mode == 0) return launch_slots<HD, NoHeadBias>(p, stream);
  if (hb_mode == 1) return launch_slots<HD, __nv_bfloat16>(p, stream);
  return launch_slots<HD, float>(p, stream);
}

// this library's head widths: K2_HD_FIRST + 16 i for each i of the sequence
using Widths = std::make_integer_sequence<int, (K2_HD_LAST - K2_HD_FIRST) / 16 + 1>;
template <int I>
constexpr int kWidth = K2_HD_FIRST + 16 * I;

template <int... I>
bool takes(std::integer_sequence<int, I...>, int hd) {
  return ((hd == kWidth<I>) || ...);
}

template <int... I>
int dispatch(std::integer_sequence<int, I...>, const Params& p, int hd, int hb_mode,
             cudaStream_t stream) {
  int err = -1;
  ((hd == kWidth<I> ? (err = launch_head_bias<kWidth<I>>(p, hb_mode, stream), true) : false) ||
   ...);
  return err;
}

}  // namespace

// q/k/v: fp32 [B, L, heads * hd] with unit stride in the last dim, batch and
// row strides (elements) that are multiples of 4 and 16-byte-aligned data;
// key_bias: fp32 [B, L] contiguous or NULL; head_bias: [heads, L, L]
// contiguous, bf16 when head_bias_bf16 is non-zero, else fp32, or NULL;
// causal 0 or 1; out: fp32 [B, L, heads * hd] contiguous. Returns a
// cudaError_t, or -1 for a head_dim not among this library's widths, -2 for a grid too
// large, -3 for q/k/v the 16-byte copies cannot read.
extern "C" int attention_f32(const float* q, const float* k, const float* v,
                             const float* key_bias, const void* head_bias, int head_bias_bf16,
                             float* out, int B, int L, int heads, int head_dim, long long qs0,
                             long long qs1, long long ks0, long long ks1, long long vs0,
                             long long vs1, float sm_scale, int causal, void* stream) {
  if (!takes(Widths{}, head_dim)) return -1;
  const uintptr_t ptr_bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  if ((ptr_bits & 15) || ((qs0 | qs1 | ks0 | ks1 | vs0 | vs1) & 3)) return -3;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.key_bias = key_bias;
  p.head_bias = head_bias;
  p.out = out;
  p.qs0 = qs0;
  p.qs1 = qs1;
  p.ks0 = ks0;
  p.ks1 = ks1;
  p.vs0 = vs0;
  p.vs1 = vs1;
  p.B = B;
  p.L = L;
  p.H = heads;
  p.slot_shift = L <= 16 ? 4 : (L <= 32 ? 5 : 6);
  const int per_item = 1 << (6 - p.slot_shift);
  p.groups = (heads + per_item - 1) / per_item;
  p.qblocks = p.slot_shift == 6 ? (L + kBM - 1) / kBM : 1;
  const long long items = (long long)B * p.groups * p.qblocks;
  if (items > 0x7fffffffLL) return -2;
  p.items = (int)items;
  p.causal = causal != 0;
  p.sm_scale = sm_scale;
  const int hb_mode = head_bias ? (head_bias_bf16 ? 1 : 2) : 0;
  return dispatch(Widths{}, p, head_dim, hb_mode, (cudaStream_t)stream);
}
