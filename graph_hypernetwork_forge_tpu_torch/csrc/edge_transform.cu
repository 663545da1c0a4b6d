// Relation-grouped combined edge transform for Hopper (sm_90a).
//
//   out[e, :] = x_src[e, :] @ W_msg[r] + x_dst[e, :] @ W_self[r] + bias[r]
//   r = rel_sorted[(e / 256) * 256]                                  (f32)
//
// The edge rows come relation-sorted and group-padded so that every
// 256-row tile holds one relation (encode_graph(sort_by_relation=True,
// group_pad=256)); a tile takes its relation from its first row, and a
// ragged last tile from that same first row.
//
// Replaces the TPU kernel edge_transform_sorted_combined
// (graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:239), both as
// the `pallas` backend runs it at d=128 and as the `pallas_packed` backend
// runs it at d=64 through [U, 128, 128] block-diagonal banks. The block-
// diagonal packing only fills the TPU's 128 lanes; here the product runs
// directly at the model's width.
//
// What bounds it on the H100: at d=64 bytes and f32 operations about
// equally (~0.79 GB against ~17 GFLOP at E=1.03M); at d=128 the f32
// operations (~68 GFLOP against ~1.6 GB). Tensor cores would take the
// product in TF32 or bf16 and break the f32 parity gate, so the work runs
// as f32 FMAs on the CUDA cores, whose peak is the bound.
//
// What the design does about it: each block computes a 128-row x 64-column
// output tile as a small GEMM with K = 2 * d_in ([x_src | x_dst] against
// [W_msg ; W_self] of the tile's relation). K is staged through shared
// memory in slices of 8, transposed for the rows so a thread reads its
// 8 rows and 4 columns as float4s, and every thread keeps an 8x4 block of
// outputs in registers: 32 FMAs for each 12 shared-memory words it reads.
// A 128-row block never crosses a 256-row tile, so one relation serves the
// whole block; the weight slices of a relation are re-read from L2 by each
// of its blocks (the banks, at most ~31 MB at U=240, d=128, stay in the
// 50 MB L2). Shared memory is 6 KB a block, so several blocks share an SM
// and hide each other's load latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 256;  // relation tile of the group-padded layout
constexpr int BM = 128;         // output rows per block (divides kTileRows)
constexpr int BN = 64;          // output columns per block
constexpr int BK = 8;           // K slice staged per step
constexpr int TM = 8;           // rows per thread
constexpr int TN = 4;           // columns per thread
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

static_assert(kTileRows % BM == 0, "a block must stay inside one tile");
static_assert(BM * BK == 4 * kThreads, "A slice: four loads per thread");
static_assert(BK * BN == 2 * kThreads, "B slice: two loads per thread");

__global__ void __launch_bounds__(kThreads)
edge_transform_kernel(const float* __restrict__ x_src,
                      const float* __restrict__ x_dst,
                      const int32_t* __restrict__ rel_sorted,
                      const float* __restrict__ w_msg,
                      const float* __restrict__ w_self,
                      const float* __restrict__ bias,
                      float* __restrict__ out, int num_edges, int d_in,
                      int d_out) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // row group
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int rel = rel_sorted[(row0 / kTileRows) * kTileRows];
  const int64_t bank = (int64_t)rel * d_in * d_out;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // Two passes over K: the message half, then the self-loop half.
  for (int half = 0; half < 2; ++half) {
    const float* __restrict__ x = half ? x_dst : x_src;
    const float* __restrict__ w = (half ? w_self : w_msg) + bank;
    for (int k0 = 0; k0 < d_in; k0 += BK) {
      // A slice: BM rows x BK columns of x, stored transposed.
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int idx = tid + l * kThreads;
        const int rr = idx / BK;
        const int kk = idx % BK;
        const int64_t row = row0 + rr;
        const int k = k0 + kk;
        As[kk][rr] = (row < num_edges && k < d_in)
                         ? __ldg(x + row * d_in + k)
                         : 0.f;
      }
      // B slice: BK rows x BN columns of the relation's weight.
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const int idx = tid + l * kThreads;
        const int kk = idx / BN;
        const int nn = idx % BN;
        const int k = k0 + kk;
        const int n = col0 + nn;
        Bs[kk][nn] =
            (k < d_in && n < d_out) ? __ldg(w + (int64_t)k * d_out + n) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
        const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const float* __restrict__ b_rel = bias + (int64_t)rel * d_out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = row0 + ty * TM + i;
    if (row >= num_edges) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = col0 + tx * TN + j;
      if (n < d_out) out[row * d_out + n] = acc[i][j] + __ldg(b_rel + n);
    }
  }
}

}  // namespace

// x_src, x_dst: [E, d_in] f32; rel_sorted: [E] int32; w_msg, w_self:
// [U, d_in, d_out] f32; bias: [U, d_out] f32; out: [E, d_out] f32. All
// contiguous. Launches on `stream`; returns cudaGetLastError().
extern "C" int ghf_edge_transform(const void* x_src, const void* x_dst,
                                  const void* rel_sorted, const void* w_msg,
                                  const void* w_self, const void* bias,
                                  void* out, int num_edges, int d_in,
                                  int d_out, void* stream) {
  if (num_edges <= 0 || d_out <= 0) return (int)cudaSuccess;
  dim3 grid((num_edges + BM - 1) / BM, (d_out + BN - 1) / BN);
  edge_transform_kernel<<<grid, kThreads, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_src), static_cast<const float*>(x_dst),
      static_cast<const int32_t*>(rel_sorted),
      static_cast<const float*>(w_msg), static_cast<const float*>(w_self),
      static_cast<const float*>(bias), static_cast<float*>(out), num_edges,
      d_in, d_out);
  return (int)cudaGetLastError();
}
