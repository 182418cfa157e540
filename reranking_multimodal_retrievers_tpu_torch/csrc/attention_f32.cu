// K2, fp32 path: fused multi-head self-attention over fp32 q/k/v with a key
// bias, head_dim 64 or 80, for Hopper (sm_90a) with plain SIMT FFMA.
//
// Replaces reranking_multimodal_retrievers_tpu/ops/attention_pallas.py::
// fused_self_attention (pallas_call at :175) where it is called with fp32
// inputs: the TPU kernel takes any float dtype and accumulates in fp32
// (preferred_element_type), and the executors keep their parameters in
// fp32, so BERT under use_pallas_attention hands it fp32 q/k/v. The bf16
// inputs go to csrc/attention.cu. It computes
//     out = softmax(Q K^T * sm_scale + key_bias) V
// per (batch row, head), reading Q/K/V in the projection layout
// [B, L, heads * hd] through strides, with the padding mask as an additive
// [B, L] fp32 key bias (0 keep / -1e9 drop), all in fp32.
//
// What bounds it on an H100: outside the tensor cores fp32 peaks at 67
// TFLOP/s. At the executors' shapes (L <= 80, BERT-base's 12 x 64 heads) it
// does 4*B*H*L*L*hd operations against 16*B*L*H*hd bytes moved: L/4
// operations a byte, below the card's 20 fp32 operations a byte for L < 80,
// so bytes bound it there, operations above.
//
// Design (simple first): one block of 128 threads takes 32 query rows of one
// (batch row, head); each query row belongs to a quad of 4 threads, thread t
// of the quad holding dims t, t+4, t+8, ... of the row's q and output
// accumulator in registers (dims interleaved, so the quad's 4 threads read 4
// consecutive words of a K or V row: no bank conflict; the 8 quads of a warp
// read the same row, a broadcast). K and V pass through shared memory in
// tiles of 64 keys. A score is the quad's partial dot products summed with
// two shuffles; the softmax is online (running max and sum in fp32, expf),
// as the bf16 kernel's. The -1e9 bias is added, not -inf, so a row whose
// keys are all masked averages V uniformly, as JAX and the plain version do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQuad = 4;
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kRowsPerBlock * kQuad;
constexpr int kKeyTile = 64;

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, int L, int heads, int q_tiles,
                     int64_t qs0, int64_t qs1, int64_t ks0, int64_t ks1,
                     int64_t vs0, int64_t vs1, float sm_scale) {
  constexpr int kPer = HD / kQuad;
  __shared__ float ks[kKeyTile][HD];
  __shared__ float vsm[kKeyTile][HD];
  __shared__ float bs[kKeyTile];

  const int b = blockIdx.x / q_tiles;
  const int tile = blockIdx.x % q_tiles;
  const int h = blockIdx.y;
  const int lane_q = threadIdx.x / kQuad;
  const int t = threadIdx.x % kQuad;
  const int row = tile * kRowsPerBlock + lane_q;
  const bool live = row < L;

  float qr[kPer], acc[kPer];
  const float* qrow = q + b * qs0 + (int64_t)(live ? row : 0) * qs1 + h * HD;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = live ? qrow[t + kQuad * i] * sm_scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < L; k0 += kKeyTile) {
    const int n = min(kKeyTile, L - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      ks[j][d] = k[b * ks0 + (int64_t)(k0 + j) * ks1 + h * HD + d];
      vsm[j][d] = v[b * vs0 + (int64_t)(k0 + j) * vs1 + h * HD + d];
    }
    for (int j = threadIdx.x; j < n; j += kThreads)
      bs[j] = bias ? bias[(int64_t)b * L + k0 + j] : 0.f;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) s = fmaf(qr[i], ks[j][t + kQuad * i], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += bs[j];
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * alpha + p;
      m = m_new;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(p, vsm[j][t + kQuad * i], acc[i] * alpha);
    }
  }

  if (live) {
    const float inv = 1.f / l;
    float* orow = out + ((int64_t)b * L + row) * (int64_t)heads * HD + h * HD;
#pragma unroll
    for (int i = 0; i < kPer; ++i) orow[t + kQuad * i] = acc[i] * inv;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* bias, float* out,
           int B, int L, int heads, int64_t qs0, int64_t qs1, int64_t ks0, int64_t ks1,
           int64_t vs0, int64_t vs1, float sm_scale, cudaStream_t stream) {
  const int q_tiles = (L + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid((unsigned)((int64_t)B * q_tiles), (unsigned)heads);
  attention_f32_kernel<HD><<<grid, kThreads, 0, stream>>>(
      q, k, v, bias, out, L, heads, q_tiles, qs0, qs1, ks0, ks1, vs0, vs1, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v: fp32 [B, L, heads * hd] with unit stride in the last dim and the
// given batch and row strides (elements); bias: fp32 [B, L] contiguous or
// NULL; out: fp32 [B, L, heads * hd] contiguous. Returns a cudaError_t, or
// -1 for a head_dim other than 64 or 80, or -2 for a grid too large.
extern "C" int attention_f32(const float* q, const float* k, const float* v,
                             const float* bias, float* out, int B, int L, int heads,
                             int head_dim, int64_t qs0, int64_t qs1, int64_t ks0,
                             int64_t ks1, int64_t vs0, int64_t vs1, float sm_scale,
                             void* stream) {
  const int64_t blocks = (int64_t)B * ((L + kRowsPerBlock - 1) / kRowsPerBlock);
  if (blocks > 0x7fffffff || heads > 65535) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  if (head_dim == 64)
    return launch<64>(q, k, v, bias, out, B, L, heads, qs0, qs1, ks0, ks1, vs0, vs1, sm_scale, s);
  if (head_dim == 80)
    return launch<80>(q, k, v, bias, out, B, L, heads, qs0, qs1, ks0, ks1, vs0, vs1, sm_scale, s);
  return -1;
}
