// K3: all-pairs late-interaction MaxSim totals over int8 codes on Hopper
// (sm_90a).
//
// Replaces reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py::
// maxsim_scores_pallas_int8 (pallas_call at :247, body _maxsim_kernel_int8
// at :150). For query codes Qq [B, Lq, dim] with per-query-token scales
// qs [B, Lq] and doc codes Dq [N, Ld, dim] with per-doc scales ds [N] (int8
// codes, fp32 scales) it computes
//     out[b, n] = ds[n] * sum_i qs[b, i] * float(max_j (Qq[b, i] . Dq[n, j] + bias[n, j]))
// with s8 x s8 -> s32 dot products, bias = 0 for a valid doc token and
// -(1 << 25) for a masked one (added in int32 BEFORE the max, as the TPU
// kernel does), an int32 max converted with __int2float_rn and fp32 sums.
// Every rescale happens after the max, so the [B, N, Lq, Ld] score tensor
// stays int32 and never reaches device memory.
//
// What bounds it on an H100: 2*B*Lq*N*Ld*dim int8 tensor-core operations
// (5.92 TOP at 8 x 113 queries over a 100k x 256 x 128 index, 2.99 ms at
// 1,979 TOP/s) against N*Ld*dim bytes of codes (3.28 GB, 0.98 ms at
// 3.35 TB/s): operations. The bias add and max over 2.3e10 int32 scores
// cost about as much issue time as the products, so they must overlap them
// and take one instruction a score.
//
// Design: the skeleton in maxsim_hopper.cuh, shared with K1. Persistent
// blocks each hold a group of up to 1,024 query rows in shared memory (all
// 904 rows of 8 x 113: one group, so every doc is read once and no partial
// sums are written). Doc tokens arrive by TMA through a 4-stage ring of
// 128-token tiles; wgmma m64n128k32 (s8 -> s32) takes both operands from
// shared memory; the bias add and the running max are one DPX instruction
// a score (__viaddmax_s32) on the accumulator registers; per-query sums run
// in a fixed order, times ds[n] last.

#include "maxsim_hopper.cuh"

extern "C" {

// Pieces S of the [S, B, N] output a launch writes for B x Lq query rows of
// dim codes (1 unless a query has more rows than a block holds; the caller
// sums the pieces), or -1 if dim is too wide for shared memory.
int maxsim_int8_splits(int B, int Lq, int dim) {
  Plan plan;
  return make_plan<true, 8>(B, Lq, dim, &plan) ? plan.splits : -1;
}

// Qq [B, Lq, dim] int8, qs [B, Lq] fp32, Dq [N, Ld, dim] int8, ds [N] fp32,
// mask [N, Ld] uint8 or null, out [S, B, N] fp32 (S from
// maxsim_int8_splits), all contiguous; dim % 32 == 0 and Qq, Dq 16-byte
// aligned. Returns the cudaError_t of the launch, or 10000 + the CUresult
// of a failed cuTensorMapEncodeTiled, or 20000 if the driver has none.
int maxsim_scores_int8(const void* q, const void* qs, const void* d, const void* ds,
                       const void* mask, void* out, int B, int Lq, int N, int Ld, int dim,
                       void* stream) {
  if (dim % 32 != 0) return (int)cudaErrorInvalidValue;
  return maxsim_run<true, false, 8>(q, qs, d, ds, mask, out, B, Lq, N, Ld, dim,
                                    (cudaStream_t)stream);
}

}  // extern "C"
