// Building blocks of the 3xTF32 tensor-core products (sm_90a): the split of
// an f32 operand into two TF32 halves, the m16n8k8 TF32 mma.sync with f32
// accumulation, the three-product step over a block of fragments (with
// MT = NT = 1, one fragment), and 16-byte / 4-byte cp.async
// copies with commit and wait groups. Kernels 2 and 3 (edge_transform.cu,
// edge_transform_bwd.cu) build their products from these; no GEMM here.
//
// The split. hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest,
// ties away from zero (the rounding of cvt.rna.tf32.f32). x - hi is exact in
// f32, so hi + lo carries 21 significant bits of x, and a.b = a_hi.b_hi +
// a_hi.b_lo + a_lo.b_hi up to the dropped a_lo.b_lo (< 2^-22 |a.b|) and the
// rounding of the lo halves. Single-pass TF32 (hi.hi alone) keeps 11 bits
// and misses the repository's 3e-5 gate; kernels 2 and 3 offer it as their
// precision="default" mode (operand<1>, mma_tile<1, ...>), the Hopper form
// of the TPU's one bf16 pass, outside parity mode. On sm_90a
// cvt.rna.tf32.f32 lowers to an add of half a TF32 ulp to the bits, a
// mask, and an infinity test with a select; split() keeps the add and the
// mask and drops the test (an infinite operand gives NaN instead of an
// infinity): 4 instructions a split instead of 8. The tensor cores read
// only the 19 high bits of a TF32 operand, so lo needs the add alone.
//
// The sums. The tensor cores add each step's products into the f32
// accumulator without rounding to nearest, and a long chain of mma.sync into
// one accumulator drifted on the card (kernel 3's dW over 1,024-row runs:
// 6.6e-6 scaled against float64, where the plain f32 version has 3.0e-7).
// So each step's three products go into a zeroed fragment, which is then
// added to the running sum with one rounded f32 add: the error of a step
// stays at the size of that step's terms, and the steps add up as in a
// plain f32 loop. tests/test_torch_tf32x3.py emulates this arithmetic
// against float64; the card tests hold the kernels to at most twice the
// float64 error of the plain f32 version.
//
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x -> (hi, lo), TF32 bit patterns for mma.sync (see above).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// The operand of kPasses TF32 passes: the split for 3; for 1 (one TF32
// pass, precision="default") hi alone, and lo is neither set nor read.
template <int kPasses>
__device__ __forceinline__ void operand(float x, uint32_t& hi, uint32_t& lo) {
  static_assert(kPasses == 1 || kPasses == 3, "1 or 3 TF32 passes");
  if constexpr (kPasses == 3) {
    split(x, hi, lo);
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  }
}

// d += a . b on the tensor cores: one m16n8k8 TF32 product, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b over an MT x NT block of fragments for one 8-deep step: the
// three products of each fragment into a zeroed one, term by term (so that
// products into one fragment stand MT * NT instructions apart and the
// tensor pipe always has independent work), then one rounded f32 add each.
template <int MT, int NT>
__device__ __forceinline__ void mma3_tile(float (&d)[MT][NT][4],
                                          const uint32_t (&a_hi)[MT][4],
                                          const uint32_t (&a_lo)[MT][4],
                                          const uint32_t (&b_hi)[NT][2],
                                          const uint32_t (&b_lo)[NT][2]) {
  float t[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) t[i][j][l] = 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(t[i][j], a_lo[i], b_hi[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(t[i][j], a_hi[i], b_lo[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(t[i][j], a_hi[i], b_hi[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) d[i][j][l] += t[i][j][l];
}

// d += a . b over an MT x NT block of fragments in kPasses TF32 passes:
// mma3_tile for 3; for 1 each hi product straight into the running sums,
// as a TF32 GEMM takes them (its error is the operands' rounding to TF32,
// ~2^-11 relative, which any drift of the sums stays far below).
template <int kPasses, int MT, int NT>
__device__ __forceinline__ void mma_tile(float (&d)[MT][NT][4],
                                         const uint32_t (&a_hi)[MT][4],
                                         const uint32_t (&a_lo)[MT][4],
                                         const uint32_t (&b_hi)[NT][2],
                                         const uint32_t (&b_lo)[NT][2]) {
  if constexpr (kPasses == 3) {
    mma3_tile<MT, NT>(d, a_hi, a_lo, b_hi, b_lo);
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(d[i][j], a_hi[i], b_hi[j]);
  }
}

// Asynchronous global -> shared copies. With `valid` false nothing is read
// and the destination is zero-filled (src-size 0), which is how the kernels
// pad ragged rows and columns; `src` must still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32x3
