// K2, generic path: fused multi-head self-attention for Hopper (sm_90a) at
// every head geometry that the per-width kernels (csrc/attention.cu,
// csrc/attention_f32.cu: head_dim 16..128 by 16) do not take, in bf16 and in
// fp32: head_dim 8, 12, 24, 40, ..., 120, 192, 256, 384 or any other.
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
// What bounds it on an H100: 4*B*H*L*L*hd operations against the bytes of
// q, k, v and out. This kernel does them on the fp32 pipes (67 TFLOP/s), not
// on the tensor cores, so it sits far above the bound that chip_smoke.py
// prints (bf16 at 989 TFLOP/s, fp32 at TF32's 495); PERF.md has its times.
// It is the simple kernel that is right, kept for the geometries no model
// of the repo runs on the card today.
//
// Design:
// - A block is 256 threads and owns 64 query rows of one (batch row, head)
//   and up to DO output columns of that head: DO = 64 up to hd 64, else 256
//   (a wider head takes more blocks, each recomputing the scores, so shared
//   memory and registers stay bounded at any hd; at DO = 64 a thread holds
//   16 accumulators, not 64, and more blocks fit on an SM). Thread (ty, tx),
//   ty and tx in 0..15, owns rows 4 ty .. 4 ty + 3, score columns
//   tx + 16 j (j < 4) of each 64-key tile and output columns tx + 16 j
//   (j < DO / 16) of the block's range, accumulated in fp32 registers.
// - The key tiles are 64 keys. S = Q K^T is summed in fp32 over column
//   chunks of 32: each chunk of Q and K is loaded element by element
//   (converted to fp32) into padded shared tiles, so any hd and any row
//   stride is read. Scale, key bias, head bias and the causal -1e9 are added
//   in the plain version's order; keys past L get -inf.
// - The online softmax keeps each row's running max and sum; the row's 16
//   threads reduce with 4 shuffles inside their half-warp. P, in fp32, and
//   the tile's V columns go to shared memory, and each thread adds its
//   4 x (DO / 16) block of P V. No key tile is skipped under the causal mask, so
//   every row's sum is the plain version's at any key bias.
// - O is divided by the row sum once and written in the output's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;   // query rows a block
constexpr int kBN = 64;   // keys a tile
constexpr int kDC = 32;   // columns of a Q K^T chunk
constexpr int kQKStride = kDC + 1;
constexpr int kPStride = kBN + 1;
// shared bytes with DO output columns a block: Q chunk, K chunk, P, V tile
constexpr int smem_bytes(int DO) {
  return (2 * kBM * kQKStride + kBM * kPStride + kBN * DO) * 4;
}
constexpr float kNegInf = -1e9f;  // the TPU kernel's causal mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const float* key_bias;
  const void* head_bias;
  int head_bias_bf16;
  T* out;
  int B, L, H, hd, qblocks, oblocks;
  long long qs0, qs1, ks0, ks1, vs0, vs1;
  float sm_scale;
  int causal;
};

template <typename T, int DO>
__global__ void __launch_bounds__(kThreads) attention_any_kernel(const Params<T> p) {
  constexpr int kJ = DO / 16;  // output columns a thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBM * kQKStride;
  float* ps = ks + kBN * kQKStride;
  float* vs = ps + kBM * kPStride;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  long long item = blockIdx.x;
  const int ob = (int)(item % p.oblocks);
  item /= p.oblocks;
  const int qb = (int)(item % p.qblocks);
  item /= p.qblocks;
  const int h = (int)(item % p.H);
  const int b = (int)(item / p.H);
  const int q0 = qb * kBM, o0 = ob * DO;
  const int ocols = min(DO, p.hd - o0);
  const int L = p.L;

  const T* qbase = p.q + b * p.qs0 + (long long)h * p.hd;
  const T* kbase = p.k + b * p.ks0 + (long long)h * p.hd;
  const T* vbase = p.v + b * p.vs0 + (long long)h * p.hd + o0;

  float o[4][kJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBN) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

    for (int c0 = 0; c0 < p.hd; c0 += kDC) {
      const int cn = min(kDC, p.hd - c0);
      __syncthreads();  // the previous chunk's (or tile's) readers are done
      for (int e = tid; e < kBM * kDC; e += kThreads) {
        const int r = e / kDC, c = e % kDC;
        float xq = 0.f, xk = 0.f;
        if (c < cn) {
          if (q0 + r < L) xq = to_f32(qbase[(q0 + r) * p.qs1 + c0 + c]);
          if (k0 + r < L) xk = to_f32(kbase[(k0 + r) * p.ks1 + c0 + c]);
        }
        qs[r * kQKStride + c] = xq;
        ks[r * kQKStride + c] = xk;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < cn; ++c) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(4 * ty + i) * kQKStride + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * kQKStride + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
    }

    // scale and biases in the plain version's order; the online softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + 4 * ty + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        float x;
        if (kc >= L) {
          x = -INFINITY;
        } else {
          x = s[i][j] * p.sm_scale;
          if (p.key_bias) x += p.key_bias[(long long)b * L + kc];
          if (p.head_bias && qr < L) {
            const long long off = ((long long)h * L + qr) * L + kc;
            x += p.head_bias_bf16
                     ? __bfloat162float(((const __nv_bfloat16*)p.head_bias)[off])
                     : ((const float*)p.head_bias)[off];
          }
          if (p.causal && kc > qr) x += kNegInf;
        }
        s[i][j] = x;
        tmax = fmaxf(tmax, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, w));
      const float mnew = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - mnew);  // 0 at the first tile
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - mnew);
        s[i][j] = e;
        tsum += e;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, w);
      l[i] = l[i] * alpha + tsum;
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < kJ; ++j) o[i][j] *= alpha;
    }

    // P and the tile's V columns to shared memory (the last chunk's sync
    // ordered every earlier reader of ps and vs before this point)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(4 * ty + i) * kPStride + tx + 16 * j] = s[i][j];
    for (int e = tid; e < kBN * ocols; e += kThreads) {
      const int r = e / ocols, c = e % ocols;
      vs[r * DO + c] = k0 + r < L ? to_f32(vbase[(k0 + r) * p.vs1 + c]) : 0.f;
    }
    __syncthreads();
    const int kn = min(kBN, L - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(4 * ty + i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (tx + 16 * j < ocols) {
          const float vv = vs[kk * DO + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pr[i], vv, o[i][j]);
        }
      }
    }
  }

  const int HD = p.H * p.hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + 4 * ty + i;
    if (qr >= L) continue;
    T* orow = p.out + ((long long)b * L + qr) * HD + (long long)h * p.hd + o0;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      if (tx + 16 * j < ocols) store(orow + tx + 16 * j, o[i][j] * inv);
  }
}

template <typename T, int DO>
int launch_do(Params<T> p, void* stream) {
  p.oblocks = (p.hd + DO - 1) / DO;
  const long long blocks = (long long)p.B * p.H * p.qblocks * p.oblocks;
  if (blocks > 0x7fffffffLL) return -2;
  // the attribute is per function and per device: set it at every launch
  cudaError_t e = cudaFuncSetAttribute(attention_any_kernel<T, DO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes(DO));
  if (e != cudaSuccess) return (int)e;
  attention_any_kernel<T, DO>
      <<<(unsigned)blocks, kThreads, smem_bytes(DO), (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* key_bias, const void* head_bias,
           int head_bias_bf16, T* out, int B, int L, int heads, int head_dim, long long qs0,
           long long qs1, long long ks0, long long ks1, long long vs0, long long vs1,
           float sm_scale, int causal, void* stream) {
  if (head_dim <= 0 || heads <= 0 || B < 0 || L < 0) return -1;
  if (B == 0 || L == 0) return 0;
  Params<T> p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.key_bias = key_bias;
  p.head_bias = head_bias;
  p.head_bias_bf16 = head_bias_bf16;
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
  return head_dim <= 64 ? launch_do<T, 64>(p, stream) : launch_do<T, 256>(p, stream);
}

}  // namespace

// q/k/v: [B, L, heads * hd] with unit stride in the last dim and any batch
// and row strides (elements); key_bias: fp32 [B, L] contiguous or NULL;
// head_bias: [heads, L, L] contiguous, bf16 when head_bias_bf16 is non-zero,
// else fp32, or NULL; causal 0 or 1; out: [B, L, heads * hd] contiguous in
// q's dtype. Returns a cudaError_t, or -1 for a shape it cannot take, -2 for
// a grid too large.
extern "C" int attention_any_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, const float* key_bias,
                                  const void* head_bias, int head_bias_bf16, __nv_bfloat16* out,
                                  int B, int L, int heads, int head_dim, long long qs0,
                                  long long qs1, long long ks0, long long ks1, long long vs0,
                                  long long vs1, float sm_scale, int causal, void* stream) {
  return launch(q, k, v, key_bias, head_bias, head_bias_bf16, out, B, L, heads, head_dim, qs0,
                qs1, ks0, ks1, vs0, vs1, sm_scale, causal, stream);
}

extern "C" int attention_any_f32(const float* q, const float* k, const float* v,
                                 const float* key_bias, const void* head_bias,
                                 int head_bias_bf16, float* out, int B, int L, int heads,
                                 int head_dim, long long qs0, long long qs1, long long ks0,
                                 long long ks1, long long vs0, long long vs1, float sm_scale,
                                 int causal, void* stream) {
  return launch(q, k, v, key_bias, head_bias, head_bias_bf16, out, B, L, heads, head_dim, qs0,
                qs1, ks0, ks1, vs0, vs1, sm_scale, causal, stream);
}
