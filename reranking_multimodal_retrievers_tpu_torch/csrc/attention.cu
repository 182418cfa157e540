// K2: fused multi-head self-attention on Hopper (sm_90a), head_dim 64 or 80,
// bf16.
//
// Replaces reranking_multimodal_retrievers_tpu/ops/attention_pallas.py::
// fused_self_attention (bodies _attn_kernel / _dispatch_kernel). It computes
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
// does 4*B*H*L*L*64 = 80.5 GFLOP (0.08 ms of bf16 tensor-core time) and must
// move q, k, v and out once, 315 MB (0.094 ms at 3.35 TB/s): bytes, narrowly.
// The T5 encoder shape [10, 544, 32 x 64] adds a bf16 head bias of 18.9 MB;
// the OPT shape [5, 544, 32 x 80] under the causal mask needs about half the
// operations: both are bound by bytes as well.
// Design: FlashAttention-style online softmax, so the [B, H, L, L] scores
// never reach device memory and q/k/v are each read once per query tile. One
// block of 4 warps owns 64 query rows of one (batch row, head); each warp owns
// 16 rows. The block walks 64-key tiles of K and V staged in shared memory
// (and, with a head bias, that head's 64 x 64 bias tile, converted to fp32);
// each warp computes its 16x64 score tile on the tensor cores (WMMA, bf16 ->
// fp32, hd/16 k-steps), updates the running row max and row sum in fp32,
// rescales its fp32 output rows (hd wide) and adds P.V (P rounded to bf16)
// on the tensor cores (hd/16 output tiles). Any L is taken: keys past L get
// -inf and bias reads past L are skipped; query rows past L are computed and
// not stored. Under the causal mask, key tiles wholly above the diagonal are
// skipped: each of their entries would be exp(-1e9 - m) = 0. Tiles are
// walked from 0 upward, so every tile visited holds a key < L and the
// running max stays finite.
// This is the simple first version: synchronous staging, score and output
// tiles round-trip through shared memory. wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kBM = 64;           // query rows per block
constexpr int kBN = 64;           // keys per tile
constexpr int kWarps = kBM / 16;  // 4
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kBN + 4;     // fp32 score / head-bias row stride
constexpr int kLdp = kBN + 8;     // bf16 probability row stride (16-byte skew)
constexpr float kNegInf = -1e9f;  // the TPU kernel's causal mask value

template <int HD>
struct Layout {
  static_assert(HD % 16 == 0, "head_dim is a whole number of 16-wide MMA steps");
  static constexpr int kLdh = HD + 8;  // bf16 Q/K/V row stride (16-byte skew)
  static constexpr int kLdo = HD + 4;  // fp32 output row stride
  static constexpr int kOC = HD / 2;   // output columns per lane
  static_assert(kOC % 8 == 0, "each lane stores its output columns in 16-byte chunks");
  static constexpr size_t kQs = 0;
  static constexpr size_t kKs = kQs + (size_t)kBM * kLdh * 2;
  static constexpr size_t kVs = kKs + (size_t)kBN * kLdh * 2;
  static constexpr size_t kS = kVs + (size_t)kBN * kLdh * 2;
  static constexpr size_t kP = kS + (size_t)kWarps * 16 * kLds * 4;
  static constexpr size_t kO = kP + (size_t)kWarps * 16 * kLdp * 2;
  static constexpr size_t kBias = kO + (size_t)kWarps * 16 * kLdo * 4;
  static constexpr size_t kHs = kBias + (size_t)kBN * 4;
  static constexpr size_t kBytes = kHs;                              // no head bias
  static constexpr size_t kBytesHB = kHs + (size_t)kBM * kLds * 4;   // with head bias
  // WMMA pointers must be 32-byte aligned: every region starts on one
  static_assert(kKs % 32 == 0 && kVs % 32 == 0 && kS % 32 == 0 && kP % 32 == 0 &&
                kO % 32 == 0 && kHs % 32 == 0, "shared-memory regions 32-byte aligned");
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Stage 64 rows x HD columns of one head into shared memory (zero rows past L).
template <int HD>
__device__ __forceinline__ void stage_head(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int row0, int L) {
  constexpr int kLdh = Layout<HD>::kLdh;
  for (int c = threadIdx.x; c < kBM * (HD / 8); c += blockDim.x) {
    const int r = c / (HD / 8);
    const int k = (c % (HD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < L) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + k);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdh + k) = v;
  }
}

// Stage the 64 x 64 tile of one head's [L, L] bias at (m0, n0) as fp32;
// nothing is read at or past L (those entries are never used unmasked).
template <typename HB>
__device__ __forceinline__ void stage_head_bias(float* dst, const HB* src, int m0, int n0,
                                                int L) {
  for (int c = threadIdx.x; c < kBM * kBN; c += blockDim.x) {
    const int r = c / kBN;
    const int j = c % kBN;
    float x = 0.0f;
    if (m0 + r < L && n0 + j < L) x = to_float(src[(long long)(m0 + r) * L + n0 + j]);
    dst[r * kLds + j] = x;
  }
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;      // [B, L] key bias or null
  const void* head_bias;  // [H, L, L], its type set by the kernel's HB
  __nv_bfloat16* out;
  int L, H;
  long long sqb, sql, skb, skl, svb, svl;
  float sm_scale;
};

// HB: the head bias's type (NoHeadBias, float or __nv_bfloat16); CAUSAL: the
// in-kernel causal mask. Both are compile-time, so the BERT variant pays
// for neither.
struct NoHeadBias {};

template <int HD, typename HB, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) attention_kernel(const Args a) {
  constexpr bool kHB = !std::is_same<HB, NoHeadBias>::value;
  using Lay = Layout<HD>;
  constexpr int kLdh = Lay::kLdh;
  constexpr int kLdo = Lay::kLdo;
  constexpr int kOC = Lay::kOC;
  const int L = a.L;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kQs);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kKs);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kVs);
  float* S = reinterpret_cast<float*>(smem + Lay::kS);
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kP);
  float* O = reinterpret_cast<float*>(smem + Lay::kO);
  float* bias_s = reinterpret_cast<float*>(smem + Lay::kBias);
  float* Hs = reinterpret_cast<float*>(smem + Lay::kHs);  // only with a head bias

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  float* Sw = S + warp * 16 * kLds;
  __nv_bfloat16* Pw = P + warp * 16 * kLdp;
  float* Ow = O + warp * 16 * kLdo;
  // each lane owns half of one of the warp's 16 rows: 32 score columns and
  // HD/2 output columns
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  const int o0 = (lane & 1) * kOC;
  const int row = m0 + warp * 16 + r;
  const float* Hw = Hs + (warp * 16 + r) * kLds + c0;

  stage_head<HD>(Qs, a.q + b * a.sqb + h * HD, a.sql, m0, L);
  for (int j = 0; j < kOC; ++j) Ow[r * kLdo + o0 + j] = 0.0f;
  float m_i = -INFINITY;
  float l_i = 0.0f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], Qs + warp * 16 * kLdh + kk * 16, kLdh);
  }

  // under the causal mask, the last key tile with a key <= the block's last row
  const int n_end = CAUSAL ? min(L, m0 + kBM) : L;
  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();  // previous K/V/bias tile no longer read
    stage_head<HD>(Ks, a.k + b * a.skb + h * HD, a.skl, n0, L);
    stage_head<HD>(Vs, a.v + b * a.svb + h * HD, a.svl, n0, L);
    for (int j = threadIdx.x; j < kBN; j += blockDim.x) {
      bias_s[j] = (n0 + j < L) ? (a.bias ? a.bias[(long long)b * L + n0 + j] : 0.0f)
                               : -INFINITY;
    }
    if constexpr (kHB) {
      stage_head_bias(Hs, static_cast<const HB*>(a.head_bias) + (long long)h * L * L, m0, n0,
                      L);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int ct = 0; ct < kBN / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + ct * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(Sw + ct * 16, acc, kLds, wmma::mem_row_major);
    }
    __syncwarp();

    // scale, biases and masks, then the online softmax over this tile
    float mx = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      float s = Sw[r * kLds + c0 + j] * a.sm_scale + bias_s[c0 + j];
      if constexpr (kHB) s += Hw[j];
      if constexpr (CAUSAL) {
        if (n0 + c0 + j > row) s += kNegInf;
      }
      Sw[r * kLds + c0 + j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);  // finite: every tile holds a key < L
    const float alpha = __expf(m_i - m_new);
    float sum = 0.0f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float p = __expf(Sw[r * kLds + c0 + j] - m_new);
      Pw[r * kLdp + c0 + j] = __float2bfloat16(p);
      sum += p;
      if constexpr (kOC == 32) Ow[r * kLdo + o0 + j] *= alpha;  // hd 64: same columns
    }
    if constexpr (kOC != 32) {
#pragma unroll 8
      for (int j = 0; j < kOC; ++j) Ow[r * kLdo + o0 + j] *= alpha;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    __syncwarp();

    // O += P V
#pragma unroll
    for (int ct = 0; ct < HD / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Ow + ct * 16, kLdo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Pw + kk * 16, kLdp);
        wmma::load_matrix_sync(vb, Vs + kk * 16 * kLdh + ct * 16, kLdh);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(Ow + ct * 16, acc, kLdo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (row < L) {
    const float inv = 1.0f / l_i;
    __nv_bfloat16* dst = a.out + ((long long)b * L + row) * (a.H * HD) + h * HD + o0;
#pragma unroll
    for (int j = 0; j < kOC; j += 8) {
      __align__(16) __nv_bfloat16 vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(Ow[r * kLdo + o0 + j + e] * inv);
      *reinterpret_cast<uint4*>(dst + j) = *reinterpret_cast<const uint4*>(vals);
    }
  }
}

template <int HD, typename HB, bool CAUSAL>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr bool kHB = !std::is_same<HB, NoHeadBias>::value;
  const size_t smem = kHB ? Layout<HD>::kBytesHB : Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD, HB, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.L + kBM - 1) / kBM, a.H, B);
  attention_kernel<HD, HB, CAUSAL><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD, typename HB>
int launch_causal(const Args& a, int B, int causal, cudaStream_t stream) {
  return causal ? launch<HD, HB, true>(a, B, stream) : launch<HD, HB, false>(a, B, stream);
}

template <int HD>
int launch_head_bias(const Args& a, int B, int head_bias_bf16, int causal,
                     cudaStream_t stream) {
  if (!a.head_bias) return launch_causal<HD, NoHeadBias>(a, B, causal, stream);
  if (head_bias_bf16) return launch_causal<HD, __nv_bfloat16>(a, B, causal, stream);
  return launch_causal<HD, float>(a, B, causal, stream);
}

}  // namespace

extern "C" {

// q/k/v [B, L, H*hd] bf16 with unit stride in the last dim and the given batch
// and row strides (in elements, multiples of 8, 16-byte aligned base); bias
// [B, L] fp32 contiguous or null; head_bias [H, L, L] contiguous, bf16 when
// head_bias_bf16 is non-zero, else fp32, or null; causal 0 or 1; out
// [B, L, H*hd] bf16 contiguous. hd is 64 or 80. Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for another hd).
int attention_bf16(const void* q, const void* k, const void* v, const void* bias,
                   const void* head_bias, int head_bias_bf16, void* out, int B, int L, int H,
                   int hd, long long sqb, long long sql, long long skb, long long skl,
                   long long svb, long long svl, float sm_scale, int causal, void* stream) {
  const Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
               (const float*)bias, head_bias, (__nv_bfloat16*)out, L, H, sqb, sql, skb, skl,
               svb, svl, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64) return launch_head_bias<64>(a, B, head_bias_bf16, causal, s);
  if (hd == 80) return launch_head_bias<80>(a, B, head_bias_bf16, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
