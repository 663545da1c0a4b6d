// The cross-block dW reduction of kernels 3 and 6 (edge_transform_bwd.cu,
// segment_outer.cu), inside the kernels: an ordered last-arriver reduction.
//
// A block walks one run of up to run_tiles consecutive 256-row tiles of one
// relation u (relation u's runs are run_splits[u] .. run_splits[u + 1] - 1)
// and one slab of dW's rows and columns. Where u has one run, its block
// writes the slab of dW[u] itself. Where u has several, each run's block
//   1. writes its f32 partial of the slab (partial[run], the layout of dW),
//   2. fences it (__threadfence) and takes a ticket: one thread adds 1 to
//      the int32 counter of (u, slab) with atomicAdd;
//   3. the block that draws the last ticket resets the counter to 0 and sums
//      the slab of every partial of u in run order, run_splits[u] first,
//      into dW[u].
// The order of the sum is fixed by the run index, never by which block
// arrived last, so dW is bitwise the same from launch to launch; no float
// atomics. The partials are read back soon after they were written, mostly
// from L2, and through L2 (ld.global.cg), never from a stale L1 line.
// Relations that no tile visits have no run: the blocks of the grid's first
// num_rel run indices write their slab of dW[u = run index] as exact zeros
// where u has no tile (the launch gives the grid at least num_rel runs).
//
// Every counter a launch touches is back at 0 when the launch ends (each
// (u, slab) of a relation with n > 1 runs takes exactly n tickets, and the
// last one resets it), so the next launch on the same stream can use the
// same counters; the wrapper keeps one zeroed buffer per device and stream
// (ops/cuda/_common.py, run_counters).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace runred {

// Block-uniform: true in the block that drew the last of `runs` tickets of
// `counter`, which it resets to 0 for the next launch. Every thread of the
// block has written its share of the block's partial before the call.
__device__ __forceinline__ bool last_arriver(int* counter, int runs) {
  __shared__ int last;
  __threadfence();  // this thread's partial is visible on the whole device
  __syncthreads();  // ... for every thread of the block, before the ticket
  if (threadIdx.x == 0) {
    const int ticket = atomicAdd(counter, 1);
    last = ticket == runs - 1;
    if (last) *counter = 0;
    __threadfence();  // the other runs' partials are read after the ticket
  }
  __syncthreads();
  return last;
}

// dW slab rows [c0, c0 + 64) x columns [n0, n0 + kCols), clipped to d_in x
// d_out, of each of kBanks banks: dw_b[bank + c d_out + n] = the sum over
// runs q = q0 .. q0 + runs - 1, in that order, of partial[q][b][c][n]
// (partial: [run][kBanks][d_in][d_out] f32). kVec: d_out % 4 == 0 and every
// pointer 16-byte aligned (float4 loads and stores).
template <int kBanks, int kCols, int kThreads, bool kVec>
__device__ __forceinline__ void sum_runs(const float* __restrict__ partial,
                                         int q0, int runs, float* dw0,
                                         float* dw1, int64_t bank, int c0,
                                         int n0, int d_in, int d_out) {
  constexpr int kRows = 64;
  constexpr int kPerRow = kVec ? kCols / 4 : kCols;  // items a row
  constexpr int kItems = kBanks * kRows * kPerRow / kThreads;
  // Items summed together: 4 float4 or 16 floats of registers, loads of
  // all of them in flight for each run.
  constexpr int kGroup = kVec ? 4 : 16;
  static_assert(kItems % kGroup == 0, "items split evenly");
  const int64_t plane = (int64_t)d_in * d_out;  // one bank of one run
  // Item i of this thread: bank, row and first column, in dW's layout.
  auto at = [&](int i, int& b, int& c, int& n) {
    const int v = threadIdx.x + i * kThreads;
    b = v / (kRows * kPerRow);
    c = c0 + (v / kPerRow) % kRows;
    n = n0 + (v % kPerRow) * (kVec ? 4 : 1);
    return c < d_in && n < d_out;
  };
#pragma unroll 1
  for (int i0 = 0; i0 < kItems; i0 += kGroup) {
    float4 acc[kGroup];  // the scalar path uses .x alone
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = q0; q < q0 + runs; ++q) {
      const float* p = partial + (int64_t)q * kBanks * plane;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        int b, c, n;
        if (!at(i0 + i, b, c, n)) continue;
        const float* src = p + b * plane + (int64_t)c * d_out + n;
        if constexpr (kVec) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(src));
          acc[i].x += x.x;
          acc[i].y += x.y;
          acc[i].z += x.z;
          acc[i].w += x.w;
        } else {
          acc[i].x += __ldcg(src);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      int b, c, n;
      if (!at(i0 + i, b, c, n)) continue;
      float* dst = (b ? dw1 : dw0) + bank + (int64_t)c * d_out + n;
      if constexpr (kVec) {
        *reinterpret_cast<float4*>(dst) = acc[i];
      } else {
        *dst = acc[i].x;
      }
    }
  }
}

// Exact zeros in dW slab rows [c0, c0 + 64) x columns [n0, n1), clipped to
// d_in x d_out, of each of kBanks banks at `bank`.
template <int kBanks, int kThreads>
__device__ __forceinline__ void zero_slab(float* dw0, float* dw1, int64_t bank,
                                          int c0, int n0, int n1, int d_in,
                                          int d_out) {
  const int rows = min(64, d_in - c0);
  const int cols = min(n1, d_out) - n0;
  for (int v = threadIdx.x; v < kBanks * rows * cols; v += kThreads) {
    const int b = v / (rows * cols);
    const int c = c0 + (v / cols) % rows;
    const int n = n0 + v % cols;
    (b ? dw1 : dw0)[bank + (int64_t)c * d_out + n] = 0.f;
  }
}

}  // namespace runred
