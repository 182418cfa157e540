// K2, generic path: fused multi-head self-attention for Hopper (sm_90a) at
// every head geometry that the per-width kernels (csrc/attention.cu,
// csrc/attention_f32.cu: head_dim 16..128 by 16) do not take, in bf16 and in
// fp32: head_dim 3, 8, 12, 24, 40, ..., 120, 136, 192, 256, 384 or any other.
//
// Replaces reranking_multimodal_retrievers_tpu/ops/attention_pallas.py::
// fused_self_attention (pallas_call at :175) where the JAX package's gate
// (ops/platform.py::head_pack_feasible) admits a head_dim that is not a
// multiple of 16 up to 128: the TPU kernel packs heads into 128 lanes and so
// runs 16 heads of 24, 32 of 12 or 2 of 256 as it runs 12 of 64. It computes
//     out = softmax(Q K^T * sm_scale + key_bias [+ head_bias] [+ causal]) V
// per (batch row, head), with the C interface of attention_bf16 and
// attention_f32: q/k/v in the projection layout [B, L, heads * hd] read
// through strides, an optional [B, L] fp32 additive key bias (0 keep / -1e9
// drop), an optional [heads, L, L] bf16 or fp32 head bias shared over the
// batch and an optional causal mask that adds -1e9 where key > query.
//
// What bounds it on an H100. At hd <= 40 neither the bytes nor the products
// set the pace: the exponentials do, one a score, B*H*L*L of them (4.2e8 at
// [100, 512, 16 heads], about 0.1 ms at the SFU's 16 ex2 a clock an SM on
// 132 SMs; 8.4e8 at 32 heads of 12), with the few instructions each score
// takes besides (scale and bias, max, sum, the bf16 pack). Above that the
// tensor-core products (4*B*H*L*L*hd operations, bf16 at 989 TFLOP/s, fp32
// three times over in TF32 at 495) and the bytes of q, k, v and out (at
// 3.35 TB/s) set it; chip_smoke.py prints each row's bound and PERF.md its
// times. mma.sync and not wgmma: one design serves every width and both
// dtypes, padding hd only to the k-step, and TF32 wgmma takes B only
// K-major (P V would need V transposed in shared memory). At bf16 hd 40..136
// it stays behind the library's FlashAttention-2: issuing each tile's
// cp.async copies stalls the warps about as long as Q K^T takes (PERF.md has
// the rows and the trace); TMA copies and wgmma for those widths are the open
// step. In fp32 above 128 columns it stays behind too: O's registers hold at
// most 128 columns, so each column block sums S again in 3xTF32 (Q K^T takes
// about half a warp's cycles), and a batch of a few heads fills the card for
// under two waves of one block an SM.
//
// Design (FlashAttention-2's shape on mma.sync; the helpers are in
// mma_sync.cuh):
// - A block owns 128 query rows of one (batch row, head) and one block of at
//   most CB output columns. bf16: 4 warps of 32 rows, two 16-row m-tiles
//   sharing each K and V fragment a warp loads, so that shared memory feeds
//   the tensor cores at half the bytes a product; fp32 (whose 3xTF32 sums
//   take twice the registers) and rows summed in chunks: 8 warps of 16. CB,
//   a template constant, is the least of 16, 32, 64 and 128 that holds the
//   padded head; a wider head takes more column blocks, each recomputing the
//   scores, so that O stays in registers at any hd (bf16 rows of 129..256
//   columns take one block of 256 where shared memory holds it, so that S
//   is summed once).
// - Q K^T: bf16 on mma.sync.m16n8k16 with fp32 sums; fp32 in 3xTF32 on
//   m16n8k8, with attention_f32.cu's split and summing order (the small
//   terms summed apart from the large ones, P V summed a tile from zero in
//   passes of at most 64 columns and added to O in fp32), so that the error
//   stays near fp32 round-off. hd is padded to the k-step (16 bf16, 8 fp32)
//   with zero columns in shared memory; Q and K fragments come by ldmatrix
//   (over fp32 data it gives the TF32 fragments as they stand). Rows of up
//   to 128 columns keep Q in shared memory for the whole block; a wider row
//   is summed in chunks of 128 columns (fp32: 64 where shared memory holds
//   no more), Q's chunk copied beside K's at each step. The k-steps of a
//   chunk (bf16) and P V's column pairs are template constants picked by
//   one branch a tile, so that the product loops are straight-line code and
//   each step's fragment loads are issued under the last one's products.
// - S stays in registers. Scale, key bias, head bias and the causal -1e9 are
//   added there (fp32: in the plain version's order, the scores leaving the
//   tensor cores before any bias is added; bf16: as one FMA in log2 units);
//   the online softmax runs once a 64-key tile on exp2 of log2-scaled
//   scores, and O is rescaled in registers, in bf16 only when some row's
//   running max moved.
// - P V: the C fragments of S are P's A fragments (bf16: rounded to bf16 in
//   registers, as the plain version rounds P to V's dtype; fp32: split in
//   TF32, the keys of each 8-key step permuted so that slot t holds key 2t and
//   slot t + 4 key 2t + 1). P never goes through shared memory. V comes by
//   ldmatrix.trans (bf16) or by scalar loads from rows padded to 4 mod 16
//   words (fp32); every fragment load is free of bank conflicts (rows padded
//   by 16 bytes).
// - K and V come in 64-key tiles (with the tile's key bias and head bias
//   rows) through a two-stage cp.async ring: the next step's copies are in
//   flight while the warps compute this one. The copy width is chosen at
//   each launch from what hd * size, the strides and the pointers allow: 16,
//   8 or 4 bytes by cp.async, 2 bytes (bf16 at an odd hd or odd head offsets)
//   by plain loads and stores. Rows past L and padded columns are written as
//   zeros; keys past L get a -inf key bias, so they get no weight.
// - No key tile is skipped under the causal mask: when a query row's
//   visible keys are all padded, its causal-masked keys sit at the same
//   -1e9 level as the visible ones, and the plain version averages V over
//   all of them; skipping the tiles above the diagonal would change that
//   row's sum.
// - O is divided by the row sum once and written in the output's dtype.
// Instances: by dtype, output column block and m-tiles a warp (6 bf16, 4
// fp32). ops/_build.py builds this file twice, K2_ANY_FP32 0 and 1, into
// the libraries attention_any (bf16) and attention_any_f32, compiled in
// parallel.
//
// K2_ANY_PHASE_CLOCKS=1 (tools/k2_generic_phases.py builds with it;
// ops/_build.py never does) adds clock64() reads at the tile loop's phase
// boundaries, summed a warp and added to device counters at its end, and
// records each launch's grid; attention_any_phase_counts reads them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>
#include <utility>

#include "mma_sync.cuh"

#if !defined(K2_ANY_FP32)
#error "define K2_ANY_FP32: 1 builds the fp32 entry point, 0 the bf16 one"
#endif

#if K2_ANY_PHASE_CLOCKS
// cycles summed over warps: [wait and barrier, copy issue, Q K^T, scores and
// softmax, P V], warp-tiles, cycles from the loop's start to a warp's end,
// warps; the last launch's blocks, threads a block, shared memory bytes,
// blocks an SM at once, CB, MT
__device__ unsigned long long g_phase[8];
static int g_launch[6];
#define PHASE_BEGIN()                 \
  unsigned long long ph_[8] = {};     \
  const long long ph_t0_ = clock64(); \
  long long ph_t_ = ph_t0_
#define PHASE(i)                       \
  do {                                 \
    const long long ph_n_ = clock64(); \
    ph_[i] += ph_n_ - ph_t_;           \
    ph_t_ = ph_n_;                     \
  } while (0)
#define PHASE_TILE() (ph_[5] += 1)
#define PHASE_END()                                                      \
  do {                                                                   \
    ph_[6] = clock64() - ph_t0_;                                         \
    ph_[7] = 1;                                                          \
    if ((threadIdx.x & 31) == 0)                                         \
      for (int ph_i_ = 0; ph_i_ < 8; ++ph_i_)                            \
        atomicAdd(&g_phase[ph_i_], ph_[ph_i_]);                          \
  } while (0)
#else
#define PHASE_BEGIN()
#define PHASE(i)
#define PHASE_TILE()
#define PHASE_END()
#endif

namespace {

constexpr int kBM = 128;          // query rows a block
constexpr int kBN = 64;           // keys a tile
constexpr int kNJ = kBN / 8;      // 8-key n-tiles of S a tile
constexpr int kRowPad = 16;       // bytes a Q, K or V row in shared memory is padded by
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e9f;  // the TPU kernel's mask value

template <typename T>
constexpr int kStep = std::is_same<T, float>::value ? 8 : 16;  // hd columns a k-step

// threads a block of MT 16-row m-tiles a warp: 4 warps of 32 query rows
// (two m-tiles share each K and V fragment a warp loads) or 8 warps of 16
template <int MT>
constexpr int kThreadsOf = 32 * kBM / (16 * MT);

// blocks an SM, at least: with two m-tiles a warp at most 168 registers a
// thread up to 64 output columns, else 255
template <int CB, int MT>
constexpr int kMinBlocks = MT == 1 ? 1 : (CB <= 64 ? 3 : 2);

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block, at most

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* key_bias;   // [B, L] or null
  const void* head_bias;   // [H, L, L] or null
  void* out;               // [B, L, H * hd] contiguous
  long long qs0, qs1, ks0, ks1, vs0, vs1;  // strides, elements
  int B, L, H, hd;
  int qblocks, oblocks;
  int kc;          // Q/K columns a chunk (hd padded to the k-step when nc == 1)
  int nc;          // chunks of a Q/K row
  int qks, vks;    // row strides of the Q/K and V tiles in shared memory, bytes
  int q_bytes;     // the block's Q tile when nc == 1, else 0
  // a stage: [Q chunk,] K chunk, V tile, key bias[, head bias tile]
  int stage_bytes, k_off, v_off, kb_off, hb_off;
  int hbs;         // row stride of the head bias tile in shared memory, bytes
  int copy;        // bytes a copy of q, k and v: 16, 8, 4 or 2
  int hb_copy;     // bytes a copy of the head bias
  int hb_mode;     // 0 none, 1 bf16, 2 fp32
  int causal;
  float sm_scale;
};

struct Item {
  int b, h, q0, o0, ocols, dop;  // dop: ocols padded to the k-step
};

template <typename T>
__device__ __forceinline__ Item decode(const Params& p, int CB) {
  unsigned x = blockIdx.x;
  Item it;
  const int ob = x % p.oblocks;
  x /= p.oblocks;
  it.q0 = (x % p.qblocks) * kBM;
  x /= p.qblocks;
  it.h = x % p.H;
  it.b = x / p.H;
  it.o0 = ob * CB;
  it.ocols = min(CB, p.hd - it.o0);
  it.dop = (it.ocols + kStep<T> - 1) / kStep<T> * kStep<T>;
  return it;
}

// Copy rows row0 .. row0 + ROWS - 1 of a slice of q, k, v or the head bias
// (bytes [0, vbytes) of each row at src, rows rs bytes apart) into a tile
// whose rows are `stride` bytes apart, writing zeros into bytes [vbytes,
// pbytes) and into rows past L. W bytes a copy: thread t of THREADS copies
// unit t % TPR of rows t / TPR + (THREADS / TPR) i, TPR the power of two at
// or above the units of a row (never above THREADS: a row is at most 256
// bytes with 128 threads, 512 with 256, and a unit at least 2 bytes in bf16,
// 4 in fp32).
template <int W, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows_w(unsigned char* tile, int stride, const char* src,
                                            long long rs, int row0, int L, int vbytes,
                                            int pbytes) {
  const int units = pbytes / W, vunits = vbytes / W;
  const int shift = units > 1 ? 32 - __clz(units - 1) : 0;
  const int c = threadIdx.x & ((1 << shift) - 1);
  if (c >= units) return;
  const char* from0 = src + c * W;
  unsigned char* to0 = tile + c * W;
#pragma unroll 4
  for (int r = threadIdx.x >> shift; r < ROWS; r += THREADS >> shift) {
    const bool ok = row0 + r < L && c < vunits;
    const char* from = ok ? from0 + (row0 + r) * rs : src;
    if constexpr (W == 2) {
      *reinterpret_cast<uint16_t*>(to0 + r * stride) =
          ok ? __ldg(reinterpret_cast<const unsigned short*>(from)) : (uint16_t)0;
    } else if constexpr (W == 16) {
      cp_async16(to0 + r * stride, from, ok);
    } else {
      cp_async_small<W>(to0 + r * stride, from, ok);
    }
  }
}

// the copy width is the launch's: one branch, outside the copy loops
template <int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(int W, unsigned char* tile, int stride, const char* src,
                                          long long rs, int row0, int L, int vbytes,
                                          int pbytes) {
  if (W == 16)
    copy_rows_w<16, ROWS, THREADS>(tile, stride, src, rs, row0, L, vbytes, pbytes);
  else if (W == 8)
    copy_rows_w<8, ROWS, THREADS>(tile, stride, src, rs, row0, L, vbytes, pbytes);
  else if (W == 4)
    copy_rows_w<4, ROWS, THREADS>(tile, stride, src, rs, row0, L, vbytes, pbytes);
  else
    copy_rows_w<2, ROWS, THREADS>(tile, stride, src, rs, row0, L, vbytes, pbytes);
}

// Issue the copies of step `step` (key tile step / nc, Q/K chunk step % nc)
// into its stage: the Q chunk (every step when nc > 1, else the block's Q
// tile at step 0), the K chunk, and at a tile's last chunk its V columns,
// key bias and head bias tile.
template <typename T, int N>
__device__ __forceinline__ void load_step(const Params& p, unsigned char* smem, const Item& it,
                                          int step) {
  constexpr int S = sizeof(T);
  const int tile = step / p.nc, c = step - tile * p.nc;
  const int k0 = tile * kBN, c0 = c * p.kc;
  unsigned char* st = smem + p.q_bytes + (step & 1) * p.stage_bytes;
  const int cols = min(p.kc, p.hd - c0);
  const int vb = cols * S, pb = (cols + kStep<T> - 1) / kStep<T> * kStep<T> * S;
  const long long hoff = ((long long)it.h * p.hd + c0) * S;
  if (p.nc > 1 || step == 0)
    copy_rows<kBM, N>(p.copy, p.nc > 1 ? st : smem, p.qks,
                   static_cast<const char*>(p.q) + (it.b * p.qs0) * S + hoff, p.qs1 * S, it.q0,
                   p.L, vb, pb);
  copy_rows<kBN, N>(p.copy, st + p.k_off, p.qks,
                 static_cast<const char*>(p.k) + (it.b * p.ks0) * S + hoff, p.ks1 * S, k0, p.L,
                 vb, pb);
  if (c == p.nc - 1) {
    copy_rows<kBN, N>(p.copy, st + p.v_off, p.vks,
                   static_cast<const char*>(p.v) +
                       (it.b * p.vs0 + (long long)it.h * p.hd + it.o0) * S,
                   p.vs1 * S, k0, p.L, it.ocols * S, it.dop * S);
    if (threadIdx.x < kBN) {
      const int key = k0 + threadIdx.x;
      float* dst = reinterpret_cast<float*>(st + p.kb_off) + threadIdx.x;
      if (key >= p.L)
        *dst = -INFINITY;  // not a key: no weight
      else if (p.key_bias)
        cp_async4(dst, p.key_bias + (long long)it.b * p.L + key);
      else
        *dst = 0.f;
    }
    if (p.hb_mode) {  // rows q0 .. q0 + kBM - 1, keys k0 .. k0 + kBN - 1; zeros past L
      const int hsz = p.hb_mode == 1 ? 2 : 4;
      copy_rows<kBM, N>(p.hb_copy, st + p.hb_off, p.hbs,
                     static_cast<const char*>(p.head_bias) +
                         ((long long)it.h * p.L * p.L + k0) * hsz,
                     (long long)p.L * hsz, it.q0, p.L, min(kBN, p.L - k0) * hsz, kBN * hsz);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct NoHeadBias {};

__device__ __forceinline__ float2 pair(const float* x) {
  return *reinterpret_cast<const float2*>(x);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}

// The scores of a tile, in place: bf16 in log2 units, x = s * sm_scale *
// log2 e + (key bias [+ head bias] [+ causal -1e9]) * log2 e; fp32 in the
// plain version's order, x = s * sm_scale + key bias [+ head bias] [+ causal
// -1e9], s the sum of the large and the small 3xTF32 terms. HB: the head
// bias's type (NoHeadBias: none), its tile at hb, rows hbs bytes apart from
// the warp's first; kMask: the tile holds keys above some of the warp's rows.
// Sets each row half's maximum.
template <typename T, typename HB, bool kMask>
__device__ __forceinline__ void score_tile(float (&s)[kNJ][4], const float (&ss)[kNJ][4],
                                           const float* kb, const unsigned char* hb, int hbs,
                                           float sm_scale, int k0, int row0, int g, int t,
                                           float (&mx)[2]) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kHB = !std::is_same<HB, NoHeadBias>::value;
  const float scale_l2 = sm_scale * kLog2e;
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    float2 kbv = *reinterpret_cast<const float2*>(kb + 8 * j + 2 * t);
    if constexpr (!kF32) {
      kbv.x *= kLog2e;
      kbv.y *= kLog2e;
    }
    float2 hbv[2] = {};  // rows g and g + 8, keys 8j + 2t and 8j + 2t + 1
    if constexpr (kHB) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        hbv[rr] = pair(reinterpret_cast<const HB*>(hb + (g + 8 * rr) * hbs) + 8 * j + 2 * t);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t + (e & 1), row = row0 + g + 8 * (e >> 1);
      const float bias = (e & 1) ? kbv.y : kbv.x;
      const float hbe = (e & 1) ? hbv[e >> 1].y : hbv[e >> 1].x;
      float x;
      if constexpr (kF32) {
        x = __fadd_rn(__fmul_rn(__fadd_rn(s[j][e], ss[j][e]), sm_scale), bias);
        if constexpr (kHB) x = __fadd_rn(x, hbe);
        if (kMask && key > row) x = __fadd_rn(x, kNegInf);
      } else {
        x = fmaf(s[j][e], scale_l2, bias);
        if constexpr (kHB) x = fmaf(hbe, kLog2e, x);
        if (kMask && key > row) x += kNegInf * kLog2e;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
}

// score_tile over a warp's m-tiles, the m-th 16 rows below the warp's first
template <typename T, typename HB, bool kMask, int kMT>
__device__ __forceinline__ void score_tiles(float (&s)[kMT][kNJ][4],
                                            const float (&ss)[kMT][kNJ][4],
                                            const float* kb, const unsigned char* hb, int hbs,
                                            float sm_scale, int k0, int row0, int g, int t,
                                            float (&mx)[kMT][2]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
    score_tile<T, HB, kMask>(s[mt], ss[mt], kb, hb + 16 * mt * hbs, hbs, sm_scale, k0,
                             row0 + 16 * mt, g, t, mx[mt]);
}

// S[mt] (+)= Q[mt] K^T over k-step kk of a chunk: Q fragments by ldmatrix
// from qa (+ 16 rows an m-tile), K's from ka, rows qks bytes apart, each K
// fragment serving every m-tile; bf16 on m16n8k16, fp32 in 3xTF32 (the
// small terms into ss)
template <typename T, int kMT>
__device__ __forceinline__ void qk_step(float (&s)[kMT][kNJ][4], float (&ss)[kMT][kNJ][4],
                                        uint32_t qa, uint32_t ka, int qks, int kk) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  uint32_t a[kMT][4], ah[kMT][4], al[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    ldsm_x4(a[mt], qa + mt * 16 * qks + 32 * kk);
    if constexpr (kF32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(a[mt][i]), ah[mt][i], al[mt][i]);
    }
  }
#pragma unroll
  for (int jp = 0; jp < kNJ / 2; ++jp) {
    uint32_t b[4];  // n-tiles 2 jp (b[0], b[1]) and 2 jp + 1 (b[2], b[3])
    ldsm_x4(b, ka + jp * 16 * qks + 32 * kk);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if constexpr (kF32) {
        mma3(s[mt][2 * jp], ss[mt][2 * jp], ah[mt], al[mt], __uint_as_float(b[0]),
             __uint_as_float(b[1]));
        mma3(s[mt][2 * jp + 1], ss[mt][2 * jp + 1], ah[mt], al[mt], __uint_as_float(b[2]),
             __uint_as_float(b[3]));
      } else {
        mma_bf16(s[mt][2 * jp], a[mt], b[0], b[1]);
        mma_bf16(s[mt][2 * jp + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// qk_step over KS k-steps; KS a constant, so that the loop is straight-line
// code and each step's loads can be issued under the last one's products
template <typename T, int KS, int kMT>
__device__ __forceinline__ void qk_chunk(float (&s)[kMT][kNJ][4], float (&ss)[kMT][kNJ][4],
                                         uint32_t qa, uint32_t ka, int qks) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) qk_step<T>(s, ss, qa, ka, qks, kk);
}

// k-steps of a chunk, at most: 128 columns, or the block's CB if narrower
template <typename T, int CB>
constexpr int kMaxKS = (CB < 128 ? CB : 128) / kStep<T>;

// qk_chunk<n> for the chunk's n k-steps: one branch a chunk, to straight-line
// code (bf16)
template <typename T, int kMT, int... I>
__device__ __forceinline__ void qk_tile(std::integer_sequence<int, I...>, int n,
                                        float (&s)[kMT][kNJ][4], float (&ss)[kMT][kNJ][4],
                                        uint32_t qa, uint32_t ka, int qks) {
  (void)((n == I + 1 && (qk_chunk<T, I + 1>(s, ss, qa, ka, qks), true)) || ...);
}

// O[mt] += P[mt] V over a tile's keys for the block's first NP pairs of
// 8-column n-tiles, bf16: P rounded to bf16 in registers as each 16-key
// k-step's A fragments (n-tile 2 kk + i / 2, rows g, + 8 for odd i), V's B
// fragments by ldmatrix.trans from va (rows vks bytes apart). NP is a
// constant, so the loops have no branches.
template <int NP, int kMT, int kNT>
__device__ __forceinline__ void pv_bf16(float (&o)[kMT][kNT][4], const float (&s)[kMT][kNJ][4],
                                        uint32_t va, int vks) {
#pragma unroll
  for (int kk = 0; kk < kNJ / 2; ++kk) {  // keys 16 kk .. 16 kk + 15
    uint32_t pa[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kk + (i >> 1), e = 2 * (i & 1);
        const __nv_bfloat162 x = __floats2bfloat162_rn(s[mt][j][e], s[mt][j][e + 1]);
        pa[mt][i] = *reinterpret_cast<const uint32_t*>(&x);
      }
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b[4];  // n-tiles 2 np (b[0], b[1]) and 2 np + 1 (b[2], b[3])
      ldsm_x4_t(b, va + kk * 16 * vks + 32 * np);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma_bf16(o[mt][2 * np], pa[mt], b[0], b[1]);
        mma_bf16(o[mt][2 * np + 1], pa[mt], b[2], b[3]);
      }
    }
  }
}

// The same in 3xTF32 for the first NT n-tiles: a tile's P V summed from zero
// in passes of at most 8 n-tiles (their sums take 32 registers at any width),
// then added to O in fp32 after O is scaled by alpha; P split in TF32 with the
// keys of each 8-key k-step permuted (slot t holds key 8j + 2t, slot t + 4 key
// 8j + 2t + 1), V read at those rows from vt (rows vw words apart).
template <int NT, int kMT, int kNT>
__device__ __forceinline__ void pv_f32(float (&o)[kMT][kNT][4], const float (&s)[kMT][kNJ][4],
                                       const float (&alpha)[kMT][2], const float* vt, int vw,
                                       int g, int t) {
  constexpr int kPass = 8;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int ps = 0; ps < (NT + kPass - 1) / kPass; ++ps) {
      float pv[kPass][4];
#pragma unroll
      for (int n = 0; n < kPass; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        uint32_t ah[4], al[4];
        split(s[mt][j][0], ah[0], al[0]);
        split(s[mt][j][2], ah[1], al[1]);
        split(s[mt][j][1], ah[2], al[2]);
        split(s[mt][j][3], ah[3], al[3]);
        const float* v0 = vt + (8 * j + 2 * t) * vw + 8 * kPass * ps + g;
        const float* v1 = v0 + vw;
#pragma unroll
        for (int n = 0; n < kPass; ++n)
          if (kPass * ps + n < NT) mma3(pv[n], ah, al, v0[8 * n], v1[8 * n]);
      }
#pragma unroll
      for (int n = 0; n < kPass; ++n)
        if (kPass * ps + n < NT) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[mt][kPass * ps + n][e] =
                __fmaf_rn(o[mt][kPass * ps + n][e], alpha[mt][e >> 1], pv[n][e]);
        }
    }
}

// pv_bf16<n> (bf16) or pv_f32<n> (fp32) for the block's n, the pairs of
// n-tiles (bf16) or the n-tiles (fp32) that its columns take: one branch a
// tile, to straight-line code
template <typename T, int kMT, int kNT, int... I>
__device__ __forceinline__ void pv_tile(std::integer_sequence<int, I...>, int n,
                                        float (&o)[kMT][kNT][4], const float (&s)[kMT][kNJ][4],
                                        const float (&alpha)[kMT][2],
                                        const unsigned char* vtile, int vks, int g, int t) {
  if constexpr (std::is_same<T, float>::value) {
    const float* vt = reinterpret_cast<const float*>(vtile);
    (void)((n == I + 1 && (pv_f32<I + 1>(o, s, alpha, vt, vks / 4, g, t), true)) || ...);
  } else {
    const uint32_t va = smem_addr(vtile) + (((threadIdx.x & 31) & 15) * vks +
                                            ((threadIdx.x & 31) >> 4) * 16);
    (void)((n == I + 1 && (pv_bf16<I + 1>(o, s, va, vks), true)) || ...);
  }
}

// CB: output columns a block, at most; MT: 16-row m-tiles a warp
template <typename T, int CB, int MT>
__global__ void __launch_bounds__(kThreadsOf<MT>, kMinBlocks<CB, MT>)
    attention_any_kernel(const Params p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kMT = MT, kThreads = kThreadsOf<MT>;
  constexpr int kNT = CB / 8;  // 8-column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Item it = decode<T>(p, CB);
  const int tiles = (p.L + kBN - 1) / kBN, steps = tiles * p.nc;
  const int wrow = warp * 16 * kMT;    // the warp's first row in the block
  const int row0 = it.q0 + wrow;       // and in the sequence
  const bool active = row0 < p.L;

  load_step<T, kThreads>(p, smem, it, 0);
  cp_commit();

  float o[kMT][kNT][4];
  float s[kMT][kNJ][4], ss[kMT][kNJ][4];  // ss: fp32's small 3xTF32 terms (unused in bf16)
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }
  // each lane's ldmatrix row address: Q rows wrow + (lane & 15) (+ 16 an
  // m-tile), bytes 16 (lane >> 4) of a k-step; K rows 8 (lane >> 4) + (lane &
  // 7), bytes 16 ((lane >> 3) & 1) (V's in pv_tile: rows lane & 15, bytes
  // 16 (lane >> 4))
  const int a_off = (wrow + (lane & 15)) * p.qks + (lane >> 4) * 16;
  const int b_off = ((lane >> 4) * 8 + (lane & 7)) * p.qks + ((lane >> 3) & 1) * 16;

  PHASE_BEGIN();
  for (int step = 0; step < steps; ++step) {
    cp_wait_all();
    __syncthreads();  // this step's copies landed; every warp is done with the last step
    PHASE(0);
    if (step + 1 < steps) {
      load_step<T, kThreads>(p, smem, it, step + 1);
      cp_commit();
    }
    PHASE(1);
    if (!active) continue;
    const int tile = step / p.nc, c = step - tile * p.nc;
    const unsigned char* st = smem + p.q_bytes + (step & 1) * p.stage_bytes;

    // S (+)= Q K^T over this chunk's k-steps; each K fragment serves every m-tile
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = ss[mt][j][e] = 0.f;
    }
    const uint32_t qa = smem_addr(p.nc > 1 ? st : smem) + a_off;
    const uint32_t ka = smem_addr(st + p.k_off) + b_off;
    const int ksteps = (min(p.kc, p.hd - c * p.kc) + kStep<T> - 1) / kStep<T>;
    if constexpr (kF32) {  // 3xTF32 products: a straight-line copy per count gains nothing
#pragma unroll 2
      for (int kk = 0; kk < ksteps; ++kk) qk_step<T>(s, ss, qa, ka, p.qks, kk);
    } else {
      qk_tile<T>(std::make_integer_sequence<int, kMaxKS<T, CB>>{}, ksteps, s, ss, qa, ka, p.qks);
    }
    PHASE(2);
    if (c != p.nc - 1) continue;

    // the scores, then the online softmax
    const int k0 = tile * kBN;
    const float* kb = reinterpret_cast<const float*>(st + p.kb_off);
    const unsigned char* hb = st + p.hb_off + wrow * p.hbs;
    float mx[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) mx[mt][0] = mx[mt][1] = -INFINITY;
    if (p.causal && k0 + kBN - 1 > row0) {  // keys above some of the warp's rows
      if (p.hb_mode == 1)
        score_tiles<T, __nv_bfloat16, true>(s, ss, kb, hb, p.hbs, p.sm_scale, k0, row0, g, t, mx);
      else if (p.hb_mode == 2)
        score_tiles<T, float, true>(s, ss, kb, hb, p.hbs, p.sm_scale, k0, row0, g, t, mx);
      else
        score_tiles<T, NoHeadBias, true>(s, ss, kb, hb, p.hbs, p.sm_scale, k0, row0, g, t, mx);
    } else if (p.hb_mode == 1) {
      score_tiles<T, __nv_bfloat16, false>(s, ss, kb, hb, p.hbs, p.sm_scale, k0, row0, g, t, mx);
    } else if (p.hb_mode == 2) {
      score_tiles<T, float, false>(s, ss, kb, hb, p.hbs, p.sm_scale, k0, row0, g, t, mx);
    } else {
      score_tiles<T, NoHeadBias, false>(s, ss, kb, hb, p.hbs, p.sm_scale, k0, row0, g, t, mx);
    }
    float alpha[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float x = mx[mt][rr];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float mnew = fmaxf(m[mt][rr], x);  // finite: the tile's first key is < L
        alpha[mt][rr] = kF32 ? exp2f((m[mt][rr] - mnew) * kLog2e) : ex2(m[mt][rr] - mnew);
        m[mt][rr] = mnew;
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mr = m[mt][e >> 1];
          s[mt][j][e] = kF32 ? exp2f((s[mt][j][e] - mr) * kLog2e) : ex2(s[mt][j][e] - mr);
          lsum[e >> 1] += s[mt][j][e];
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) l[mt][rr] = l[mt][rr] * alpha[mt][rr] + lsum[rr];
    }

    PHASE(3);
    PHASE_TILE();
    // O = alpha O + P V, P from S's C fragments in registers
    if constexpr (!kF32) {
      // rescale O only where some row's running max moved (after the first
      // tiles it seldom does): alpha is exactly 1 elsewhere
      bool moved = false;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) moved |= alpha[mt][0] != 1.f || alpha[mt][1] != 1.f;
      if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][n][e] *= alpha[mt][e >> 1];
      }
    }
    constexpr int kPV = kF32 ? kNT : kNT / 2;  // the units pv_tile counts
    pv_tile<T>(std::make_integer_sequence<int, kPV>{}, kF32 ? it.dop / 8 : it.dop / 16, o, s,
               alpha, st + p.v_off, p.vks, g, t);
    PHASE(4);

    if (tile == tiles - 1) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float sum = l[mt][rr];
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          const float inv = 1.f / sum;
          const int row = row0 + 16 * mt + g + 8 * rr;
          if (row >= p.L) continue;
          T* orow = static_cast<T*>(p.out) + ((long long)it.b * p.L + row) * p.H * p.hd +
                    (long long)it.h * p.hd + it.o0;
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * n + 2 * t + e;
              if (col < it.ocols) {
                const float y = o[mt][n][2 * rr + e] * inv;
                if constexpr (kF32)
                  orow[col] = y;
                else
                  orow[col] = __float2bfloat16_rn(y);
              }
            }
        }
    }
  }
  PHASE_END();
}

template <typename T, int CB, int MT>
int launch_cb(Params& p, cudaStream_t stream) {
  // the largest dynamic shared memory set for this instance so far, per device
  static int attr_bytes[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return -2;
  const int bytes = p.q_bytes + 2 * p.stage_bytes;
  if (attr_bytes[dev] < bytes) {
    e = cudaFuncSetAttribute(attention_any_kernel<T, CB, MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr_bytes[dev] = bytes;
  }
  p.oblocks = (p.hd + CB - 1) / CB;
  const long long blocks = (long long)p.B * p.H * p.qblocks * p.oblocks;
  if (blocks > 0x7fffffffLL) return -2;
#if K2_ANY_PHASE_CLOCKS
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attention_any_kernel<T, CB, MT>,
                                                    kThreadsOf<MT>, bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid[6] = {(int)blocks, kThreadsOf<MT>, bytes, per_sm, CB, MT};
  for (int i = 0; i < 6; ++i) g_launch[i] = grid[i];
#endif
  attention_any_kernel<T, CB, MT><<<(unsigned)blocks, kThreadsOf<MT>, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// the widest copy, of 16, 8, 4 and 2 bytes, that divides every byte offset
// ORed into `bits` (pointers, row widths, strides), so that every row a copy
// loop reads starts and ends on it
int copy_bytes(unsigned long long bits) {
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : 2;
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* key_bias, const void* head_bias,
           int head_bias_bf16, T* out, int B, int L, int heads, int head_dim, long long qs0,
           long long qs1, long long ks0, long long ks1, long long vs0, long long vs1,
           float sm_scale, int causal, void* stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int S = sizeof(T);
  if (head_dim <= 0 || heads <= 0 || B < 0 || L < 0) return -1;
  if (B == 0 || L == 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.key_bias = key_bias;
  p.head_bias = head_bias;
  p.hb_mode = head_bias ? (head_bias_bf16 ? 1 : 2) : 0;
  p.out = out;
  p.B = B;
  p.L = L;
  p.H = heads;
  p.hd = head_dim;
  p.qblocks = (L + kBM - 1) / kBM;
  p.qs0 = qs0;
  p.qs1 = qs1;
  p.ks0 = ks0;
  p.ks1 = ks1;
  p.vs0 = vs0;
  p.vs1 = vs1;
  p.sm_scale = sm_scale;
  p.causal = causal != 0;
  unsigned long long bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  for (long long x : {(long long)head_dim, qs0, qs1, ks0, ks1, vs0, vs1})
    bits |= (unsigned long long)x * S;
  p.copy = copy_bytes(bits);
  const int hsz = head_bias_bf16 ? 2 : 4;
  p.hb_copy = copy_bytes((uintptr_t)head_bias | (unsigned long long)L * hsz);
  // Q/K rows: hd padded to the k-step when it fits in a chunk of `chunk`
  // columns, else chunks of `chunk`; V rows: the block's columns padded to the
  // k-step. layout(cb, chunk) sets the shared memory layout at cb output
  // columns a block and returns its bytes.
  const int hdp = (head_dim + kStep<T> - 1) / kStep<T> * kStep<T>;
  p.hbs = kBN * hsz + kRowPad;
  auto layout = [&](int cb, int chunk) {
    p.nc = (hdp + chunk - 1) / chunk;
    p.kc = p.nc == 1 ? hdp : chunk;
    p.qks = p.kc * S + kRowPad;
    const int dop = hdp < cb ? hdp : cb;
    // bf16: 16 bytes of padding (ldmatrix rows an odd number of 16-byte units
    // apart); fp32: rows 4 mod 16 words apart (scalar loads of keys 2t, 2t + 1)
    p.vks = kF32 ? (dop + (dop % 16 == 0 ? 4 : 12)) * S : dop * S + kRowPad;
    p.q_bytes = p.nc == 1 ? kBM * p.qks : 0;
    p.k_off = p.nc == 1 ? 0 : kBM * p.qks;
    p.v_off = p.k_off + kBN * p.qks;
    p.kb_off = p.v_off + kBN * p.vks;
    p.hb_off = p.kb_off + kBN * 4;
    p.stage_bytes = p.hb_off + (p.hb_mode ? kBM * p.hbs : 0);
    return p.q_bytes + 2 * p.stage_bytes;
  };
  const int cb = hdp <= 16 ? 16 : hdp <= 32 ? 32 : hdp <= 64 ? 64 : 128;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (kF32) {
    // one m-tile a warp (the 3xTF32 sums take twice the registers); rows of up
    // to 128 columns in one chunk, else chunks of 64, and 64 output columns a
    // block, where shared memory holds no more
    int fcb = cb, chunk = 128;
    if (layout(fcb, chunk) > kMaxSmem) chunk = 64;
    if (layout(fcb, chunk) > kMaxSmem) fcb = 64;
    layout(fcb, chunk);
    if (fcb == 16) return launch_cb<T, 16, 1>(p, s);
    if (fcb == 32) return launch_cb<T, 32, 1>(p, s);
    if (fcb == 64) return launch_cb<T, 64, 1>(p, s);
    return launch_cb<T, 128, 1>(p, s);
  } else {
    // two m-tiles a warp where registers and shared memory leave room for
    // two blocks an SM (one chunk of 128 columns); chunked rows of up to 256
    // columns one block of 256 output columns, so that S is summed once
    if (hdp > 128 && hdp <= 256 && layout(256, 128) <= kMaxSmem)
      return launch_cb<T, 256, 1>(p, s);
    layout(cb, 128);
    if (cb == 16) return launch_cb<T, 16, 2>(p, s);
    if (cb == 32) return launch_cb<T, 32, 2>(p, s);
    if (cb == 64) return launch_cb<T, 64, 2>(p, s);
    return p.nc == 1 ? launch_cb<T, 128, 2>(p, s) : launch_cb<T, 128, 1>(p, s);
  }
}

}  // namespace

// q/k/v: [B, L, heads * hd] with unit stride in the last dim and any batch
// and row strides (elements); key_bias: fp32 [B, L] contiguous or NULL;
// head_bias: [heads, L, L] contiguous, bf16 when head_bias_bf16 is non-zero,
// else fp32, or NULL; causal 0 or 1; out: [B, L, heads * hd] contiguous in
// q's dtype. Returns a cudaError_t, or -1 for a shape it cannot take, -2 for
// a grid too large.
#if !K2_ANY_FP32
extern "C" int attention_any_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, const float* key_bias,
                                  const void* head_bias, int head_bias_bf16, __nv_bfloat16* out,
                                  int B, int L, int heads, int head_dim, long long qs0,
                                  long long qs1, long long ks0, long long ks1, long long vs0,
                                  long long vs1, float sm_scale, int causal, void* stream) {
  return launch(q, k, v, key_bias, head_bias, head_bias_bf16, out, B, L, heads, head_dim, qs0,
                qs1, ks0, ks1, vs0, vs1, sm_scale, causal, stream);
}

#else
extern "C" int attention_any_f32(const float* q, const float* k, const float* v,
                                 const float* key_bias, const void* head_bias,
                                 int head_bias_bf16, float* out, int B, int L, int heads,
                                 int head_dim, long long qs0, long long qs1, long long ks0,
                                 long long ks1, long long vs0, long long vs1, float sm_scale,
                                 int causal, void* stream) {
  return launch(q, k, v, key_bias, head_bias, head_bias_bf16, out, B, L, heads, head_dim, qs0,
                qs1, ks0, ks1, vs0, vs1, sm_scale, causal, stream);
}
#endif

#if K2_ANY_PHASE_CLOCKS
// out[8]: the phase counters (see g_phase) since the last call, which zeroes
// them; launch[6]: the last launch's grid (see g_launch)
extern "C" int attention_any_phase_counts(unsigned long long* out, int* launch) {
  for (int i = 0; i < 6; ++i) launch[i] = g_launch[i];
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
#endif
