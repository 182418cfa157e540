// The mma.sync route's building blocks, shared by K2's fp32 kernel
// (attention_f32.cu) and its generic kernel (attention_any.cu): cp.async
// copies into shared memory, ldmatrix fragment loads, and the products
// (bf16 m16n8k16, and 3xTF32 on m16n8k8: each fp32 operand split into a TF32
// hi and lo part, the products summed as lo*hi + hi*lo + hi*hi).
//
// Each library is its own shared object, so everything here has internal
// linkage. ops/_build.py hashes every csrc/*.cuh into each library's name: a
// change here rebuilds every library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes, or 16 zero bytes when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// W (4 or 8) bytes, or W zero bytes when !ok (src is then not read)
template <int W>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, bool ok) {
  static_assert(W == 4 || W == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(W), "r"(ok ? W : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes each, one
// row address a lane: lanes 8i .. 8i + 7 give matrix i's rows); thread T
// gets, in r[i], the 32 bits at row T / 4, bytes 4 (T % 4) .. 4 (T % 4) + 3
// of matrix i. Over fp32 data that is the element at row T / 4, column T % 4
// of an 8 x 4 block: the TF32 fragments' layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, transposed: thread T gets the 16-bit elements at rows 2 (T % 4)
// and 2 (T % 4) + 1, column T / 4 of matrix i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += A B, A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), in two integer operations: half of the dropped bits' weight is
// added to the magnitude bits, then the 13 dropped bits are cleared
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each rounded to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += A B, A 16 x 8 TF32 (row), B 8 x 8 TF32 (col), fp32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 with B = (b0, b1) split here: small += Al Bh + Ah Bl (the two
// small terms first), big += Ah Bh. The tensor cores truncate each sum they
// keep, so Q K^T keeps its small terms apart from its large ones, where a
// long chain of small terms added to a large sum would lose what they carry
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4], const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// d += A B in 3xTF32, all three products in one sum
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  mma3(d, d, ah, al, b0, b1);
}

}  // namespace
