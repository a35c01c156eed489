// Error-compensated TF32 ("3xTF32") tensor-core helpers for Hopper
// (sm_90a), shared by fused_gru.cu and bipartite.cu.
//
// A float32 product a * b is split into TF32 halves, a = a_hi + a_lo with
// a_hi = tf32(a) and a_lo = tf32(a - a_hi) (the rounding of cvt.rna: to
// nearest, ties away from zero), and taken as a_hi*b_hi + a_hi*b_lo + a_lo*b_hi on the
// tensor cores (mma.sync m16n8k8, fp32 accumulate). The dropped a_lo*b_lo
// term is ~2^-22 of the product, so sums match float32 FMA to ~1e-6, where
// one TF32 term keeps only ~3 decimal digits. The operands are split as a
// tile moves from shared memory into fragments: no second copy of the
// weights exists. The two small terms go to their own accumulator, so a
// k step issues two independent mma chains instead of one of three.
//
// Fragment layouts of mma.m16n8k8 (PTX ISA, "Matrix fragments for
// mma.m16n8k8", .tf32), lane = 4 * g + t:
//   A (16 x 8, row-major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                          a3 = A[g+8][t+4]
//   B (8 x 8, k x n):      b0 = B[t][g],  b1 = B[t+4][g]
//   C (16 x 8):            c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                          c3 = C[g+8][2t+1]
// A staged as [row][k] with a row stride of 4 mod 32 floats, and B as
// [k][n] with a row stride of 8 or 24 mod 32 floats, read conflict-free.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// tf32(v) with the rounding of cvt.rna.tf32.f32 (to nearest, ties away
// from zero, on the 13 low mantissa bits) by an integer add and mask: the
// same bits for every finite v, and 8-11% faster kernels than the cvt
// instruction (tools/kernel_variants.py, PERF.md)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a * b on one m16n8k8 tile, TF32 inputs, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the 16 x 8 A tile at s (row stride lda floats)
__device__ __forceinline__ void load_a(FragA& f, const float* s, int lda) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split(s[g * lda + t], f.hi[0], f.lo[0]);
  split(s[(g + 8) * lda + t], f.hi[1], f.lo[1]);
  split(s[g * lda + t + 4], f.hi[2], f.lo[2]);
  split(s[(g + 8) * lda + t + 4], f.hi[3], f.lo[3]);
}

// the 8 x 8 B tile at s, stored [k][n] (row stride ldb floats)
__device__ __forceinline__ void load_b(FragB& f, const float* s, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split(s[t * ldb + g], f.hi[0], f.lo[0]);
  split(s[(t + 4) * ldb + g], f.hi[1], f.lo[1]);
}

// big += a_hi b_hi;  small += a_hi b_lo + a_lo b_hi
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const FragA& a, const FragB& b) {
  mma(small, a.lo, b.hi);
  mma(small, a.hi, b.lo);
  mma(big, a.hi, b.hi);
}

// ---- cp.async: 16-byte copies where rows and pointers are aligned,
// 4-byte copies otherwise, zero-filled where `pred` is false (ragged
// edges; `src` must still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N));
}

}  // namespace tf32x3
