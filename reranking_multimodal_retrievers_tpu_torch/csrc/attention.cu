// K2: fused multi-head self-attention on Hopper (sm_90a), head_dim 64, bf16.
//
// Replaces reranking_multimodal_retrievers_tpu/ops/attention_pallas.py::
// fused_self_attention (bodies _attn_kernel / _dispatch_kernel). It computes
//     out = softmax(Q K^T * sm_scale + key_bias) V
// per (batch row, head), reading Q/K/V in the projection layout
// [B, L, heads * 64] through strides (no transposes) and taking the padding
// mask as an additive [B, L] fp32 key bias (0 keep / -1e9 drop). Softmax
// statistics and the P.V accumulation are fp32.
//
// What bounds it on an H100: at the rerank shape [100, 512, 12 x 64] it does
// 4*B*H*L*L*64 = 80.5 GFLOP (0.08 ms of bf16 tensor-core time) and must move
// q, k, v and out once, 315 MB (0.094 ms at 3.35 TB/s): bytes, narrowly.
// Design: FlashAttention-style online softmax, so the [B, H, L, L] scores
// never reach device memory and q/k/v are each read once per query tile. One
// block of 4 warps owns 64 query rows of one (batch row, head); each warp owns
// 16 rows. The block walks 64-key tiles of K and V staged in shared memory;
// each warp computes its 16x64 score tile on the tensor cores (WMMA, bf16 ->
// fp32), updates the running row max and row sum in fp32, rescales its fp32
// output rows and adds P.V (P rounded to bf16) on the tensor cores. Any L is
// taken: keys past L get -inf, query rows past L are computed and not stored.
// This is the simple first version: synchronous staging, score and output
// tiles round-trip through shared memory. wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kHd = 64;           // head dim
constexpr int kBM = 64;           // query rows per block
constexpr int kBN = 64;           // keys per tile
constexpr int kWarps = kBM / 16;  // 4
constexpr int kThreads = kWarps * 32;
constexpr int kLdh = kHd + 8;     // bf16 smem row stride (16-byte skew)
constexpr int kLds = kBN + 4;     // fp32 smem row stride
static_assert(kHd == kBN, "score and output tiles share one fp32 layout");

constexpr size_t kSmemBytes =
    (size_t)3 * kBM * kLdh * sizeof(__nv_bfloat16)        // Qs, Ks, Vs
    + (size_t)kWarps * 16 * kLds * sizeof(float)           // S (per warp)
    + (size_t)kWarps * 16 * kLdh * sizeof(__nv_bfloat16)   // P (per warp)
    + (size_t)kWarps * 16 * kLds * sizeof(float)           // O (per warp)
    + (size_t)kBN * sizeof(float);                         // key bias

// Stage 64 rows x 64 columns of one head into shared memory (zero rows past L).
__device__ __forceinline__ void stage_head(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int row0, int L) {
  for (int c = threadIdx.x; c < kBM * (kHd / 8); c += blockDim.x) {
    const int r = c / (kHd / 8);
    const int k = (c % (kHd / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < L) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + k);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdh + k) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int L, int H, long long sqb, long long sql,
                 long long skb, long long skl, long long svb, long long svl, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBM * kLdh;
  __nv_bfloat16* Vs = Ks + kBN * kLdh;
  float* S = reinterpret_cast<float*>(Vs + kBN * kLdh);
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(S + kWarps * 16 * kLds);
  float* O = reinterpret_cast<float*>(P + kWarps * 16 * kLdh);
  float* bias_s = O + kWarps * 16 * kLds;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  float* Sw = S + warp * 16 * kLds;
  __nv_bfloat16* Pw = P + warp * 16 * kLdh;
  float* Ow = O + warp * 16 * kLds;
  // each lane owns half (32 columns) of one of the warp's 16 rows
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;

  stage_head(Qs, q + b * sqb + h * kHd, sql, m0, L);
  for (int j = 0; j < 32; ++j) Ow[r * kLds + c0 + j] = 0.0f;
  float m_i = -INFINITY;
  float l_i = 0.0f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[kHd / 16];
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], Qs + warp * 16 * kLdh + kk * 16, kLdh);
  }

  for (int n0 = 0; n0 < L; n0 += kBN) {
    __syncthreads();  // previous K/V tile no longer read
    stage_head(Ks, k + b * skb + h * kHd, skl, n0, L);
    stage_head(Vs, v + b * svb + h * kHd, svl, n0, L);
    for (int j = threadIdx.x; j < kBN; j += blockDim.x) {
      bias_s[j] = (n0 + j < L) ? (bias ? bias[(long long)b * L + n0 + j] : 0.0f) : -INFINITY;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int ct = 0; ct < kBN / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + ct * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(Sw + ct * 16, acc, kLds, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile
    float mx = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float s = Sw[r * kLds + c0 + j] * sm_scale + bias_s[c0 + j];
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
      Pw[r * kLdh + c0 + j] = __float2bfloat16(p);
      sum += p;
      Ow[r * kLds + c0 + j] *= alpha;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    __syncwarp();

    // O += P V
#pragma unroll
    for (int ct = 0; ct < kHd / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Ow + ct * 16, kLds, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Pw + kk * 16, kLdh);
        wmma::load_matrix_sync(vb, Vs + kk * 16 * kLdh + ct * 16, kLdh);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(Ow + ct * 16, acc, kLds, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int row = m0 + warp * 16 + r;
  if (row < L) {
    const float inv = 1.0f / l_i;
    __nv_bfloat16* dst = out + ((long long)b * L + row) * (H * kHd) + h * kHd + c0;
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
      __align__(16) __nv_bfloat16 vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(Ow[r * kLds + c0 + j + e] * inv);
      *reinterpret_cast<uint4*>(dst + j) = *reinterpret_cast<const uint4*>(vals);
    }
  }
}

}  // namespace

extern "C" {

// q/k/v [B, L, H*64] bf16 with unit stride in the last dim and the given batch
// and row strides (in elements, multiples of 8, 16-byte aligned base); bias
// [B, L] fp32 contiguous or null; out [B, L, H*64] bf16 contiguous.
// Returns the cudaError_t of the launch.
int attention_hd64_bf16(const void* q, const void* k, const void* v, const void* bias,
                        void* out, int B, int L, int H, long long sqb, long long sql,
                        long long skb, long long skl, long long svb, long long svl,
                        float sm_scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kBM - 1) / kBM, H, B);
  attention_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)bias, (__nv_bfloat16*)out, L, H, sqb, sql, skb, skl, svb, svl, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
