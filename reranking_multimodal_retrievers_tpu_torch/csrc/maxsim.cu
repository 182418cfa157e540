// K1: all-pairs late-interaction MaxSim totals on Hopper (sm_90a), bf16.
//
// Replaces reranking_multimodal_retrievers_tpu/ops/maxsim_pallas.py::
// maxsim_scores_pallas (pallas_call at :127, body _maxsim_kernel at :35).
// For queries Q [B, Lq, dim] and docs D [N, Ld, dim] (bf16) it computes
//     out[b, n] = sum_i max_j (Q[b, i] . D[n, j] + bias[n, j])
// with bias = 0 for a valid doc token and -9999 for a masked one (added
// BEFORE the max, as the TPU kernel does), fp32 dot products and an fp32 sum;
// with score_bf16 each token score is rounded to bf16 and the bias added in
// bf16. The [B, N, Lq, Ld] score tensor never reaches device memory.
//
// What bounds it on an H100: 2*B*Lq*N*Ld*dim bf16 tensor-core operations
// (5.92 TFLOP at 8 x 113 queries over a 100k x 256 x 128 index, 5.99 ms at
// 989 TFLOP/s) against N*Ld*dim*2 bytes of index (6.55 GB, 1.96 ms at
// 3.35 TB/s): operations, as long as the index is read about once.
//
// Design: the skeleton in maxsim_hopper.cuh, shared with K3. Persistent
// blocks each hold a group of up to 512 query rows in shared memory; the
// G = ceil(B / queries per group) blocks that need a doc read it side by
// side, so the index comes from device memory about once (the 904 rows of
// 8 x 113 are 2 groups of 4 queries). Doc tokens arrive by TMA through a
// 2-stage ring of 128-token tiles; wgmma m64n128k16 (bf16 -> fp32) takes
// both operands from shared memory; the bias add and the running max work
// on the accumulator registers; per-query sums run in a fixed order.

#include "maxsim_hopper.cuh"

extern "C" {

// Pieces S of the [S, B, N] output a launch writes for B x Lq query rows of
// dim bf16 values (1 unless a query has more rows than a block holds; the
// caller sums the pieces), or -1 if dim is too wide for shared memory.
int maxsim_splits(int B, int Lq, int dim) {
  Plan plan;
  return make_plan<false, 4>(B, Lq, dim, &plan) ? plan.splits : -1;
}

// Q [B, Lq, dim] bf16, D [N, Ld, dim] bf16, mask [N, Ld] uint8 or null, out
// [S, B, N] fp32 (S from maxsim_splits), all contiguous; dim % 8 == 0, Q and
// D 16-byte aligned. Returns the cudaError_t of the launch, or 10000 + the
// CUresult of a failed cuTensorMapEncodeTiled, or 20000 if the driver has
// no cuTensorMapEncodeTiled.
int maxsim_scores_bf16(const void* q, const void* d, const void* mask, void* out, int B, int Lq,
                       int N, int Ld, int dim, int score_bf16, void* stream) {
  if (dim % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return score_bf16
             ? maxsim_run<false, true, 4>(q, nullptr, d, nullptr, mask, out, B, Lq, N, Ld, dim, s)
             : maxsim_run<false, false, 4>(q, nullptr, d, nullptr, mask, out, B, Lq, N, Ld, dim, s);
}

}  // extern "C"
