// Building blocks of the bf16 tensor-core products (sm_90a): the m16n8k16
// bf16 mma.sync with f32 accumulation, ldmatrix loads of its A and B
// fragments from row-major shared-memory tiles (plain, or transposed where
// the tile holds the operand's transpose), and the 16-byte cp.async of 8
// bf16. Kernels 2 and 3 (edge_transform.cu, edge_transform_bwd.cu) build
// their bf16 forms from these: one pass, no split, every product summed in
// f32 by the tensor cores and rounded once where the kernel stores it.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): gid = lane / 4, tig = lane
// % 4. A (16 x 16, row): a0 = A[gid][2 tig, +1], a1 = A[gid + 8][2 tig, +1],
// a2 = A[gid][2 tig + 8, +9], a3 = A[gid + 8][2 tig + 8, +9]. B (16 x 8,
// col): b0 = B[2 tig, +1][gid], b1 = B[2 tig + 8, +9][gid]. C: c0, c1 =
// C[gid][2 tig, +1], c2, c3 = C[gid + 8][2 tig, +1]. Each 32-bit register
// holds two bf16, the lower k in the low half. ldmatrix x4 reads four 8 x 8
// b16 matrices; lane l gives the address of row l % 8 of matrix l / 8, a
// row being 16 contiguous bytes; without .trans thread t receives row t / 4,
// columns 2 (t % 4) and +1 of each matrix, with .trans column t / 4, rows
// 2 (t % 4) and +1. Tiles whose row stride is an odd multiple of 16 bytes
// (the kernels pad rows by 8 bf16) put the 8 rows of a matrix in 8 distinct
// 16-byte bank groups: the loads are free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace bf16mma {

using bf16 = __nv_bfloat16;

// d += a . b on the tensor cores: one m16n8k16 bf16 product, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* row) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* row) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// A fragment of the 16 x 16 tile at `t`, stored [m][k] with `stride` bf16
// a row: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
// (m 8-15, k 8-15).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int stride, int lane) {
  ldsm_x4(a, t + (lane & 15) * stride + (lane >> 4) * 8);
}

// A fragment of the 16 x 16 tile whose transpose is stored at `t` ([k][m]):
// the same four matrices, each read transposed.
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const bf16* t,
                                             int stride, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4_trans(a, t + ((i >> 1) * 8 + r) * stride + (i & 1) * 8);
}

// B fragments of two 16 x 8 n-tiles (n 0-7 and 8-15) of the tile at `t`,
// stored [n][k]: matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
// (n 8-15, k 8-15).
__device__ __forceinline__ void load_b2(uint32_t (&b)[2][2], const bf16* t,
                                        int stride, int lane) {
  const int i = lane >> 3, r = lane & 7;
  uint32_t q[4];
  ldsm_x4(q, t + ((i >> 1) * 8 + r) * stride + (i & 1) * 8);
  b[0][0] = q[0];
  b[0][1] = q[1];
  b[1][0] = q[2];
  b[1][1] = q[3];
}

// B fragments of two n-tiles of the tile at `t`, stored [k][n] (row-major
// K x N, as a weight bank [d_in][d_out] is): each matrix read transposed.
__device__ __forceinline__ void load_b2_trans(uint32_t (&b)[2][2],
                                              const bf16* t, int stride,
                                              int lane) {
  const int i = lane >> 3, r = lane & 7;
  uint32_t q[4];
  ldsm_x4_trans(q, t + ((i & 1) * 8 + r) * stride + (i >> 1) * 8);
  b[0][0] = q[0];
  b[0][1] = q[1];
  b[1][0] = q[2];
  b[1][1] = q[3];
}

// 8 bf16 (16 bytes) global -> shared, asynchronously; zero-filled when
// `valid` is false (`src` must still be a valid address).
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, bool valid) {
  tf32x3::cp_async16(dst, src, valid);
}

// 1 bf16, synchronously (the path for widths or pointers that are not
// 16-byte aligned); zero when `valid` is false.
__device__ __forceinline__ void copy1(bf16* dst, const bf16* src, bool valid) {
  *dst = valid ? *src : __float2bfloat16(0.f);
}

// Two f32 values rounded to nearest into one bf16 pair.
__device__ __forceinline__ __nv_bfloat162 pack(float lo, float hi) {
  return __floats2bfloat162_rn(lo, hi);
}

}  // namespace bf16mma
