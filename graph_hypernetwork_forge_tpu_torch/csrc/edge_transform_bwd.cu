// Fused backward of the relation-grouped combined edge transform (sm_90a).
//
//   dx_src[e, :] = g[e, :] @ W_msg[r]^T      dx_dst[e, :] = g[e, :] @ W_self[r]^T
//   partial[t]   = [ x_src[tile t]^T g[tile t] | x_dst[tile t]^T g[tile t] ]
//   r = rel_sorted[(e / 256) * 256]                                    (f32)
//
// The edge rows come relation-sorted and group-padded, so every 256-row tile
// holds one relation and takes it from its first row (a ragged last tile
// too, its missing rows counting as zero). dW_msg[u] and dW_self[u] are the
// sums of the partials of relation u's tiles; the wrapper takes that sum
// with the CSR segment-sum kernel (segment_sum.cu) over tile bounds, so a
// relation that no tile visits comes out exactly zero.
//
// Replaces the TPU kernel _combined_bwd_fused_impl
// (graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:368, kernel
// body :334-365), the backward of edge_transform_sorted_combined. On the
// TPU the dW block of a relation stays in VMEM while the grid walks the
// relation's consecutive tiles in order. Hopper's blocks run in no order,
// so each tile writes its own [2, d_in, d_out] partial and a second,
// deterministic pass adds them: no float atomics, and the result is
// bitwise the same from run to run.
//
// What bounds it on the H100: f32 operations. 8 * E * d_in * d_out (dx:
// two products of 2*E*d_in*d_out; dW: the same) against about 5 * E * d * 4
// bytes: 33.8 GFLOP against 1.3 GB at E=1.03M, d=64. Tensor cores would
// take the products in TF32 or bf16 and break the f32 parity gate, so the
// work runs as f32 FMAs on the CUDA cores, whose peak is the bound.
//
// What the design does about it: one block owns one 256-row tile and one
// window of 64 d_in columns, and computes both halves of the work for it,
// one after the other, so g's tile rows are fetched from device memory by
// the tile's blocks and re-read from L2:
//   1. dx: two 128-row x 64-column outputs (msg and self) per half tile,
//      K = d_out staged through shared memory 8 at a time; g's slice is
//      stored transposed, each thread keeps 8x4 outputs of each bank in
//      registers: 64 FMAs for each 16 shared-memory words it reads;
//   2. dW: the window's 64 rows of both partials against 64 d_out columns
//      at a time, K = the tile's rows, 8 at a time; each thread keeps 4x4
//      outputs of each bank: 32 FMAs for each 12 words read.
// The shared-memory rows are padded by 4 floats so the transposed stores
// fall on distinct banks. About 12 KB of shared memory a block, so several
// blocks share an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 256;  // relation tile of the group-padded layout
constexpr int kThreads = 256;
constexpr int BC = 64;          // d_in columns per block
constexpr int BK = 8;           // K slice staged per step
constexpr int kPad = 4;         // shared-memory row padding (floats)

// Part 1, dx: BM1 rows x BC columns of each bank; TM1 x TN1 per thread.
constexpr int BM1 = 128;
constexpr int TM1 = 8;
constexpr int TN1 = 4;
// Part 2, dW: BC rows (d_in) x BN2 columns (d_out); TM2 x TN2 per thread.
constexpr int BN2 = 64;
constexpr int TM2 = 4;
constexpr int TN2 = 4;

static_assert((BM1 / TM1) * (BC / TN1) == kThreads, "dx thread layout");
static_assert((BC / TM2) * (BN2 / TN2) == kThreads, "dW thread layout");
static_assert(kTileRows % BM1 == 0, "dx halves stay inside one tile");
static_assert(BM1 * BK == 4 * kThreads, "g slice: four loads per thread");
static_assert(BC * BK == 2 * kThreads, "weight / x slices: two loads each");
static_assert(BN2 * BK == 2 * kThreads, "g slice of part 2: two loads each");

__global__ void __launch_bounds__(kThreads)
edge_transform_bwd_kernel(const float* __restrict__ g,
                          const float* __restrict__ x_src,
                          const float* __restrict__ x_dst,
                          const int32_t* __restrict__ rel_sorted,
                          const float* __restrict__ w_msg,
                          const float* __restrict__ w_self,
                          float* __restrict__ dx_src,
                          float* __restrict__ dx_dst,
                          float* __restrict__ partial, int num_edges,
                          int d_in, int d_out) {
  __shared__ __align__(16) float Gt[BK][BM1 + kPad];  // g slice, transposed
  __shared__ __align__(16) float Wm[BK][BC + kPad];   // W_msg^T slice
  __shared__ __align__(16) float Ws[BK][BC + kPad];   // W_self^T slice
  __shared__ __align__(16) float Xs[BK][BC];          // x_src rows slice
  __shared__ __align__(16) float Xd[BK][BC];          // x_dst rows slice
  __shared__ __align__(16) float G2[BK][BN2];         // g rows slice

  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int64_t tile0 = tile * kTileRows;
  const int c0 = blockIdx.y * BC;
  const int rel = rel_sorted[tile0];
  const int64_t bank = (int64_t)rel * d_in * d_out;
  const float* __restrict__ wm = w_msg + bank;
  const float* __restrict__ ws = w_self + bank;
  const int tile_rows =
      (int)min((int64_t)kTileRows, (int64_t)num_edges - tile0);

  // ---- Part 1: dx_src, dx_dst = g @ W^T for this tile's rows ----------
  {
    const int tx = tid % (BC / TN1);  // column group
    const int ty = tid / (BC / TN1);  // row group
    for (int half = 0; half * BM1 < tile_rows; ++half) {
      const int64_t row0 = tile0 + half * BM1;
      float am[TM1][TN1], as[TM1][TN1];
#pragma unroll
      for (int i = 0; i < TM1; ++i)
#pragma unroll
        for (int j = 0; j < TN1; ++j) am[i][j] = as[i][j] = 0.f;

      for (int k0 = 0; k0 < d_out; k0 += BK) {
        // g slice: BM1 rows x BK columns, stored transposed.
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int idx = tid + l * kThreads;
          const int rr = idx / BK;
          const int kk = idx % BK;
          const int64_t row = row0 + rr;
          const int k = k0 + kk;
          Gt[kk][rr] = (row < num_edges && k < d_out)
                           ? __ldg(g + row * d_out + k)
                           : 0.f;
        }
        // W^T slices: W^T[k][c] = W[c][k], BK x BC of each bank.
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const int idx = tid + l * kThreads;
          const int kk = idx % BK;
          const int cc = idx / BK;
          const int k = k0 + kk;
          const int c = c0 + cc;
          const bool ok = k < d_out && c < d_in;
          const int64_t off = (int64_t)c * d_out + k;
          Wm[kk][cc] = ok ? __ldg(wm + off) : 0.f;
          Ws[kk][cc] = ok ? __ldg(ws + off) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&Gt[kk][ty * TM1]);
          const float4 a1 =
              *reinterpret_cast<const float4*>(&Gt[kk][ty * TM1 + 4]);
          const float4 bm = *reinterpret_cast<const float4*>(&Wm[kk][tx * TN1]);
          const float4 bs = *reinterpret_cast<const float4*>(&Ws[kk][tx * TN1]);
          const float a[TM1] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float vm[TN1] = {bm.x, bm.y, bm.z, bm.w};
          const float vs[TN1] = {bs.x, bs.y, bs.z, bs.w};
#pragma unroll
          for (int i = 0; i < TM1; ++i)
#pragma unroll
            for (int j = 0; j < TN1; ++j) {
              am[i][j] = fmaf(a[i], vm[j], am[i][j]);
              as[i][j] = fmaf(a[i], vs[j], as[i][j]);
            }
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < TM1; ++i) {
        const int64_t row = row0 + ty * TM1 + i;
        if (row >= num_edges) break;
#pragma unroll
        for (int j = 0; j < TN1; ++j) {
          const int c = c0 + tx * TN1 + j;
          if (c < d_in) {
            dx_src[row * d_in + c] = am[i][j];
            dx_dst[row * d_in + c] = as[i][j];
          }
        }
      }
    }
  }

  // ---- Part 2: this tile's dW partial rows c0..c0+BC ------------------
  {
    const int tx = tid % (BN2 / TN2);  // d_out column group
    const int ty = tid / (BN2 / TN2);  // d_in row group
    float* __restrict__ pm = partial + tile * 2 * d_in * d_out;
    float* __restrict__ ps = pm + (int64_t)d_in * d_out;
    for (int n0 = 0; n0 < d_out; n0 += BN2) {
      float am[TM2][TN2], as[TM2][TN2];
#pragma unroll
      for (int i = 0; i < TM2; ++i)
#pragma unroll
        for (int j = 0; j < TN2; ++j) am[i][j] = as[i][j] = 0.f;

      for (int k0 = 0; k0 < tile_rows; k0 += BK) {
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const int idx = tid + l * kThreads;
          const int kk = idx / BC;
          const int cc = idx % BC;
          const int64_t row = tile0 + k0 + kk;
          const int c = c0 + cc;
          const bool ok = k0 + kk < tile_rows && c < d_in;
          Xs[kk][cc] = ok ? __ldg(x_src + row * d_in + c) : 0.f;
          Xd[kk][cc] = ok ? __ldg(x_dst + row * d_in + c) : 0.f;
        }
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const int idx = tid + l * kThreads;
          const int kk = idx / BN2;
          const int nn = idx % BN2;
          const int64_t row = tile0 + k0 + kk;
          const int n = n0 + nn;
          G2[kk][nn] = (k0 + kk < tile_rows && n < d_out)
                           ? __ldg(g + row * d_out + n)
                           : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 xm = *reinterpret_cast<const float4*>(&Xs[kk][ty * TM2]);
          const float4 xd = *reinterpret_cast<const float4*>(&Xd[kk][ty * TM2]);
          const float4 b = *reinterpret_cast<const float4*>(&G2[kk][tx * TN2]);
          const float um[TM2] = {xm.x, xm.y, xm.z, xm.w};
          const float ud[TM2] = {xd.x, xd.y, xd.z, xd.w};
          const float v[TN2] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < TM2; ++i)
#pragma unroll
            for (int j = 0; j < TN2; ++j) {
              am[i][j] = fmaf(um[i], v[j], am[i][j]);
              as[i][j] = fmaf(ud[i], v[j], as[i][j]);
            }
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < TM2; ++i) {
        const int c = c0 + ty * TM2 + i;
        if (c >= d_in) break;
#pragma unroll
        for (int j = 0; j < TN2; ++j) {
          const int n = n0 + tx * TN2 + j;
          if (n < d_out) {
            pm[(int64_t)c * d_out + n] = am[i][j];
            ps[(int64_t)c * d_out + n] = as[i][j];
          }
        }
      }
    }
  }
}

}  // namespace

// g: [E, d_out] f32; x_src, x_dst: [E, d_in] f32; rel_sorted: [E] int32;
// w_msg, w_self: [U, d_in, d_out] f32; dx_src, dx_dst: [E, d_in] f32;
// partial: [ceil(E / 256), 2, d_in, d_out] f32, every element written. All
// contiguous. Launches on `stream`; returns cudaGetLastError().
extern "C" int ghf_edge_transform_bwd(const void* g, const void* x_src,
                                      const void* x_dst,
                                      const void* rel_sorted,
                                      const void* w_msg, const void* w_self,
                                      void* dx_src, void* dx_dst,
                                      void* partial, int num_edges, int d_in,
                                      int d_out, void* stream) {
  if (num_edges <= 0 || d_in <= 0 || d_out <= 0) return (int)cudaSuccess;
  dim3 grid((num_edges + kTileRows - 1) / kTileRows, (d_in + BC - 1) / BC);
  edge_transform_bwd_kernel<<<grid, kThreads, 0,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(x_src),
      static_cast<const float*>(x_dst),
      static_cast<const int32_t*>(rel_sorted),
      static_cast<const float*>(w_msg), static_cast<const float*>(w_self),
      static_cast<float*>(dx_src), static_cast<float*>(dx_dst),
      static_cast<float*>(partial), num_edges, d_in, d_out);
  return (int)cudaGetLastError();
}
