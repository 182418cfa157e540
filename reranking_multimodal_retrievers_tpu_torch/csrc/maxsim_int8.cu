// K3: all-pairs late-interaction MaxSim totals over int8 codes on Hopper
// (sm_90a).
//
// Replaces reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py::
// maxsim_scores_pallas_int8 (body _maxsim_kernel_int8). For query codes
// Qq [B, Lq, dim] with per-query-token scales qs [B, Lq] and doc codes
// Dq [N, Ld, dim] with per-doc scales ds [N] (int8 codes, fp32 scales) it
// computes
//     out[b, n] = ds[n] * sum_i qs[b, i] * float(max_j (Qq[b, i] . Dq[n, j] + bias[n, j]))
// with s8 x s8 -> s32 dot products, bias = 0 for a valid doc token and
// -(1 << 25) for a masked one (added in int32 BEFORE the max, as the TPU
// kernel does), an int32 max converted with __int2float_rn and fp32 sums.
// Every rescale happens after the max, so the [B, N, Lq, Ld] score tensor
// stays int32 and never reaches device memory.
//
// What bounds it on an H100: 2*B*Lq*N*Ld*dim int8 tensor-core operations
// (5.9 TOP at 8 x 113 queries over a 100k x 256 x 128 index, 3.0 ms at
// 1,979 TOP/s) against N*Ld*dim bytes of codes (3.3 GB, 1.0 ms at 3.35 TB/s):
// compute, not bytes, sets the floor.
// Design, the same structure as K1 (csrc/maxsim.cu): one block holds up to
// kRows flattened query-token rows in shared memory and walks a strided range
// of docs, so the index is read once per row group rather than once per
// query. Doc tokens are staged kTok at a time. Each warp owns two 16-row
// tiles of Q; for each it multiplies against all kTok/8 8-token tiles of D
// with mma.sync.m16n8k32 (s8 x s8 -> s32), adds the int32 mask bias to the
// accumulators in registers and folds them into a running int32 max per
// row, kept in registers (no round trip of the score tiles through shared
// memory). After a doc, each row's max is reduced over the four lanes that
// hold it, converted, scaled by its query scale and summed per query by one
// warp; the sum is multiplied by the doc scale. A query's rows may straddle
// row groups; each group writes its own partial [G, B, N] slab and the
// caller sums over G.
// This is the simple first version: synchronous shared-memory staging and
// fragments loaded from shared memory with 32-bit loads. wgmma, TMA and a
// pipelined staging ring are later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 256;                          // query-token rows per block
constexpr int kTilesPerWarp = kRows / 16 / kWarps;  // 2 row tiles per warp
constexpr int kTok = 64;                            // doc tokens staged per step
constexpr int kColTiles = kTok / 8;                 // 8-token column tiles per step
constexpr int kMaskBias = -(1 << 25);               // masked doc token
constexpr int kPastEnd = -(1 << 30);                // token slots past Ld: never win

// D[16x8] (+)= A[16x32] * B[32x8], int8 inputs, int32 accumulators.
// Fragments (lane = 4 * grp + tig): a[0] = A[grp][4tig..4tig+3],
// a[1] = A[grp+8][same], a[2] = A[grp][16+4tig..], a[3] = A[grp+8][16+4tig..];
// b[0] = B[4tig..4tig+3][grp], b[1] = B[16+4tig..][grp];
// c[0], c[1] = D[grp][2tig, 2tig+1], c[2], c[3] = D[grp+8][2tig, 2tig+1].
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int lds32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// Copies `rows` rows of `dim` int8 codes into shared-memory rows of `ld`
// bytes, zero-filling rows >= valid. dim % 16 == 0 and ld % 16 == 0.
__device__ __forceinline__ void stage_rows(int8_t* dst, const int8_t* src, int rows, int valid,
                                           int dim, int ld) {
  const int chunks = dim / 16;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
    const int r = c / chunks;
    const int k = (c % chunks) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * dim + k);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + k) = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
maxsim_int8_kernel(const int8_t* __restrict__ Q, const float* __restrict__ qs,
                   const int8_t* __restrict__ D, const float* __restrict__ ds,
                   const uint8_t* __restrict__ mask, float* __restrict__ partial, int B, int Lq,
                   int N, int Ld, int dim, int ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);             // [kRows][ld]
  int8_t* Ds = Qs + kRows * ld;                             // [kTok][ld]
  int* bias_s = reinterpret_cast<int*>(Ds + kTok * ld);     // [kTok]
  float* qs_s = reinterpret_cast<float*>(bias_s + kTok);    // [kRows]
  float* rowval = qs_s + kRows;                             // [kRows]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int g = blockIdx.y;
  const int row0 = g * kRows;
  const int rows = min(kRows, B * Lq - row0);
  const int q_first = row0 / Lq;
  const int q_last = (row0 + rows - 1) / Lq;

  stage_rows(Qs, Q + (size_t)row0 * dim, kRows, rows, dim, ld);
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    qs_s[r] = r < rows ? qs[row0 + r] : 0.0f;
  }

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    int rmax[kTilesPerWarp][2];  // rows grp and grp + 8 of each row tile
#pragma unroll
    for (int t = 0; t < kTilesPerWarp; ++t) rmax[t][0] = rmax[t][1] = INT_MIN;

    for (int tok0 = 0; tok0 < Ld; tok0 += kTok) {
      const int ntok = min(kTok, Ld - tok0);
      __syncthreads();  // Ds / bias_s of the previous step and rowval are free
      stage_rows(Ds, D + ((size_t)n * Ld + tok0) * dim, kTok, ntok, dim, ld);
      for (int j = threadIdx.x; j < kTok; j += blockDim.x) {
        int b = kPastEnd;
        if (j < ntok) b = (mask == nullptr || mask[(size_t)n * Ld + tok0 + j]) ? 0 : kMaskBias;
        bias_s[j] = b;
      }
      __syncthreads();

      const int ctiles = (ntok + 7) / 8;
#pragma unroll
      for (int t = 0; t < kTilesPerWarp; ++t) {
        const int rt = warp * kTilesPerWarp + t;
        if (rt * 16 >= rows) continue;  // warp-uniform: tile past this group's rows
        int acc[kColTiles][4];
#pragma unroll
        for (int ct = 0; ct < kColTiles; ++ct) acc[ct][0] = acc[ct][1] = acc[ct][2] = acc[ct][3] = 0;
        const int8_t* qa = Qs + (rt * 16 + grp) * ld + tig * 4;
        for (int kk = 0; kk < dim; kk += 32) {
          const int a[4] = {lds32(qa + kk), lds32(qa + 8 * ld + kk), lds32(qa + kk + 16),
                            lds32(qa + 8 * ld + kk + 16)};
#pragma unroll
          for (int ct = 0; ct < kColTiles; ++ct) {
            if (ct < ctiles) {  // warp-uniform
              const int8_t* db = Ds + (ct * 8 + grp) * ld + tig * 4 + kk;
              const int b[2] = {lds32(db), lds32(db + 16)};
              mma_s8(acc[ct], a, b);
            }
          }
        }
#pragma unroll
        for (int ct = 0; ct < kColTiles; ++ct) {
          if (ct < ctiles) {
            const int b0 = bias_s[ct * 8 + tig * 2];
            const int b1 = bias_s[ct * 8 + tig * 2 + 1];
            rmax[t][0] = max(rmax[t][0], max(acc[ct][0] + b0, acc[ct][1] + b1));
            rmax[t][1] = max(rmax[t][1], max(acc[ct][2] + b0, acc[ct][3] + b1));
          }
        }
      }
    }

    // each row's max over the four lanes of its quad, converted and scaled
#pragma unroll
    for (int t = 0; t < kTilesPerWarp; ++t) {
      const int rt = warp * kTilesPerWarp + t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int m = rmax[t][h];
        m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const int r = rt * 16 + grp + 8 * h;
        if (tig == 0) rowval[r] = __int2float_rn(m) * qs_s[r];
      }
    }
    __syncthreads();
    // per-query fp32 sums over this group's rows, one warp per query
    for (int q = q_first + warp; q <= q_last; q += kWarps) {
      const int lo = max(q * Lq, row0) - row0;
      const int hi = min((q + 1) * Lq, row0 + rows) - row0;
      float s = 0.0f;
      for (int r = lo + lane; r < hi; r += 32) s += rowval[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) partial[((size_t)g * B + q) * N + n] = s * ds[n];
    }
  }
}

}  // namespace

extern "C" {

// Rows of the flattened [B*Lq] query-token axis that one block holds; the
// caller sizes the partial output as [ceil(B*Lq / rows), B, N], zero-filled
// when there is more than one group.
int maxsim_int8_rows_per_block() { return kRows; }

// Qq [B, Lq, dim] int8, qs [B, Lq] fp32, Dq [N, Ld, dim] int8, ds [N] fp32,
// mask [N, Ld] uint8 or null, all contiguous; dim % 32 == 0 and Qq, Dq
// 16-byte aligned. Returns the cudaError_t of the launch.
int maxsim_scores_int8(const void* q, const void* qs, const void* d, const void* ds,
                       const void* mask, void* partial, int B, int Lq, int N, int Ld, int dim,
                       int grid_x, void* stream) {
  if (dim % 32 != 0) return (int)cudaErrorInvalidValue;
  const int ld = dim + 16;  // 16-byte skew: the 8 rows of a fragment hit distinct banks
  const size_t smem = (size_t)(kRows + kTok) * ld + (size_t)kTok * sizeof(int) +
                      (size_t)2 * kRows * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (B * Lq + kRows - 1) / kRows;
  dim3 grid(grid_x, groups);
  maxsim_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)qs, (const int8_t*)d, (const float*)ds,
      (const uint8_t*)mask, (float*)partial, B, Lq, N, Ld, dim, ld);
  return (int)cudaGetLastError();
}

}  // extern "C"
