// K1: all-pairs late-interaction MaxSim totals on Hopper (sm_90a).
//
// Replaces reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py::
// maxsim_scores_pallas (body _maxsim_kernel). For queries Q [B, Lq, dim] and
// docs D [N, Ld, dim] (bf16) it computes
//     out[b, n] = sum_i max_j (Q[b, i] . D[n, j] + bias[n, j])
// with bias = 0 for a valid doc token and -9999 for a masked one (added
// BEFORE the max, as the TPU kernel does), fp32 dot products and an fp32 sum.
// The [B, N, Lq, Ld] score tensor never reaches device memory.
//
// What bounds it on an H100: 2*B*Lq*N*Ld*dim tensor-core operations
// (5.9 TFLOP at 8 x 113 queries over a 100k x 256 x 128 index) against
// N*Ld*dim*2 bytes of index (6.55 GB): compute, not bytes, sets the floor.
// Design: one block holds up to kRows flattened query-token rows (all queries
// of a small batch) in shared memory and walks a strided range of docs, so
// the index is read from device memory once per row group rather than once
// per query. Doc tokens are staged kTok at a time; each warp multiplies its
// 16-row tiles of Q by 16-token tiles of D on the tensor cores (WMMA,
// bf16 x bf16 -> fp32), adds the mask bias and folds the tile into a running
// per-row max kept in registers. After a doc, the per-row maxima are summed
// per query in fp32. The rows of one query may straddle row groups; each
// group writes its own partial [G, B, N] slab and the caller sums over G.
// This is the simple first version: synchronous shared-memory staging and a
// round trip of every 16x16 score tile through shared memory. wgmma, TMA and
// a register-resident max are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 256;                         // query-token rows per block
constexpr int kTilesPerWarp = kRows / 16 / kWarps;  // 2 row tiles per warp
constexpr int kTok = 64;                           // doc tokens staged per step
constexpr float kMaskFill = -9999.0f;              // MASK_FILL_VALUE

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Copies `rows` rows of `dim` bf16 values into shared memory rows of `ld`
// elements, zero-filling rows >= valid and columns in [dim, dim_pad).
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int rows, int valid, int dim, int dim_pad,
                                           int ld) {
  const int chunks = dim_pad / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
    const int r = c / chunks;
    const int k = (c % chunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid && k < dim) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * dim + k);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + k) = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
maxsim_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ D,
              const uint8_t* __restrict__ mask, float* __restrict__ partial, int B, int Lq,
              int N, int Ld, int dim, int dim_pad, int ld, int score_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][ld]
  __nv_bfloat16* Ds = Qs + kRows * ld;                          // [kTok][ld]
  float* tilebuf = reinterpret_cast<float*>(Ds + kTok * ld);    // [kWarps][16*16]
  float* bias_s = tilebuf + kWarps * 256;                       // [kTok]
  float* rowmax = bias_s + kTok;                                // [kRows]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.y;
  const int total_rows = B * Lq;
  const int row0 = g * kRows;
  const int rows = min(kRows, total_rows - row0);
  float* tile = tilebuf + warp * 256;

  stage_rows(Qs, Q + (size_t)row0 * dim, kRows, rows, dim, dim_pad, ld);

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    float rmax[kTilesPerWarp];
#pragma unroll
    for (int t = 0; t < kTilesPerWarp; ++t) rmax[t] = -INFINITY;

    for (int tok0 = 0; tok0 < Ld; tok0 += kTok) {
      const int ntok = min(kTok, Ld - tok0);
      __syncthreads();  // Ds / bias_s / rowmax of the previous step are free
      stage_rows(Ds, D + ((size_t)n * Ld + tok0) * dim, kTok, ntok, dim, dim_pad, ld);
      for (int j = threadIdx.x; j < kTok; j += blockDim.x) {
        float b = -INFINITY;  // tokens past Ld never win the max
        if (j < ntok) {
          b = (mask == nullptr || mask[(size_t)n * Ld + tok0 + j]) ? 0.0f : kMaskFill;
          if (score_bf16) b = bf16_round(b);
        }
        bias_s[j] = b;
      }
      __syncthreads();

#pragma unroll
      for (int t = 0; t < kTilesPerWarp; ++t) {
        const int rt = warp * kTilesPerWarp + t;
        if (rt * 16 >= rows) break;  // warp-uniform: tile past this group's rows
        for (int ct = 0; ct * 16 < ntok; ++ct) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::fill_fragment(acc, 0.0f);
          for (int kk = 0; kk < dim_pad; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
            wmma::load_matrix_sync(a, Qs + rt * 16 * ld + kk, ld);
            wmma::load_matrix_sync(b, Ds + ct * 16 * ld + kk, ld);
            wmma::mma_sync(acc, a, b, acc);
          }
          wmma::store_matrix_sync(tile, acc, 16, wmma::mem_row_major);
          __syncwarp();
          // two lanes per row, eight columns each
          const int r = lane >> 1;
          const int c0 = (lane & 1) * 8;
          float m = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float s = tile[r * 16 + c0 + j];
            const float b = bias_s[ct * 16 + c0 + j];
            s = score_bf16 ? bf16_round(bf16_round(s) + b) : s + b;
            m = fmaxf(m, s);
          }
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          rmax[t] = fmaxf(rmax[t], m);
          __syncwarp();
        }
      }
    }

#pragma unroll
    for (int t = 0; t < kTilesPerWarp; ++t) {
      const int rt = warp * kTilesPerWarp + t;
      if ((lane & 1) == 0) rowmax[rt * 16 + (lane >> 1)] = rmax[t];
    }
    __syncthreads();
    // per-query fp32 sums over this group's rows
    const int q_first = row0 / Lq;
    const int q_last = (row0 + rows - 1) / Lq;
    for (int q = q_first + threadIdx.x; q <= q_last; q += blockDim.x) {
      const int lo = max(q * Lq, row0) - row0;
      const int hi = min((q + 1) * Lq, row0 + rows) - row0;
      float s = 0.0f;
      for (int r = lo; r < hi; ++r) s += rowmax[r];
      partial[((size_t)g * B + q) * N + n] = s;
    }
  }
}

}  // namespace

extern "C" {

// Rows of the flattened [B*Lq] query-token axis that one block holds; the
// caller sizes the partial output as [ceil(B*Lq / rows), B, N], zero-filled.
int maxsim_rows_per_block() { return kRows; }

// Q [B, Lq, dim] bf16, D [N, Ld, dim] bf16, mask [N, Ld] uint8 or null, all
// contiguous; dim % 8 == 0. Returns the cudaError_t of the launch.
int maxsim_scores_bf16(const void* q, const void* d, const void* mask, void* partial, int B,
                       int Lq, int N, int Ld, int dim, int score_bf16, int grid_x,
                       void* stream) {
  const int dim_pad = (dim + 15) / 16 * 16;
  const int ld = dim_pad + 8;  // 16-byte skew against bank conflicts
  const size_t smem = (size_t)(kRows + kTok) * ld * sizeof(__nv_bfloat16) +
                      (size_t)(kWarps * 256 + kTok + kRows) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (B * Lq + kRows - 1) / kRows;
  dim3 grid(grid_x, groups);
  maxsim_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)d, (const uint8_t*)mask,
      (float*)partial, B, Lq, N, Ld, dim, dim_pad, ld, score_bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
