// Relation-grouped edge transforms for Hopper (sm_90a), in two forms.
//
// Combined (kernel 2):
//   out[e, :]   = x_src[e, :] @ W_msg[r] + x_dst[e, :] @ W_self[r] + bias[r]
// Two outputs (kernel 5):
//   msg[e, :]   = x_src[e, :] @ W_msg[r] + bias[r]
//   selfc[e, :] = x_dst[e, :] @ W_self[r]
// with r = rel_sorted[(e / 256) * 256]                                 (f32)
//
// The edge rows come relation-sorted and group-padded so that every
// 256-row tile holds one relation (encode_graph(sort_by_relation=True,
// group_pad=256)); a tile takes its relation from its first row, and a
// ragged last tile from that same first row.
//
// The combined form replaces the TPU kernel edge_transform_sorted_combined
// (graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:239), both as
// the `pallas` backend runs it at d=128 and as the `pallas_packed` backend
// runs it at d=64 through [U, 128, 128] block-diagonal banks. The block-
// diagonal packing only fills the TPU's 128 lanes; here the product runs
// directly at the model's width. The two-output form replaces the TPU
// kernel of edge_transform_sorted, _edge_transform_fwd_impl (same file,
// :108, kernel body :77-105); its backward runs it again on the cotangents
// with the banks transposed ([U, d_out, d_in]) and a zero bias, so d_in and
// d_out are free and may differ.
//
// What bounds it on the H100: at d=64 bytes and f32 operations about
// equally (~0.79 GB against ~17 GFLOP at E=1.03M); at d=128 the f32
// operations (~68 GFLOP against ~1.6 GB); kernel 5 writes one more
// [E, d_out] output (~1.05 GB at d=64). Tensor cores would take the
// product in TF32 or bf16 and break the f32 parity gate, so the work runs
// as f32 FMAs on the CUDA cores, whose peak is the bound.
//
// What the design does about it: each block computes a 128-row x 64-column
// output tile as a small GEMM with K = 2 * d_in ([x_src | x_dst] against
// [W_msg ; W_self] of the tile's relation). K is staged through shared
// memory in slices of 8, transposed for the rows so a thread reads its
// 8 rows and 4 columns as float4s, and every thread keeps an 8x4 block of
// outputs in registers: 32 FMAs for each 12 shared-memory words it reads.
// The two-output form keeps the two K halves apart: the grid has a third
// dimension of 2, and a block of plane 0 computes msg (K = d_in, with the
// bias) while a block of plane 1 computes selfc, with the same blocking,
// loop and registers as the combined form's.
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

// kTwo = false: kernel 2, out = msg + selfc, both K halves in each block.
// kTwo = true: kernel 5, one half per block: blockIdx.z 0 writes msg to
// out, 1 writes selfc to out_self.
template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
edge_transform_kernel(const float* __restrict__ x_src,
                      const float* __restrict__ x_dst,
                      const int32_t* __restrict__ rel_sorted,
                      const float* __restrict__ w_msg,
                      const float* __restrict__ w_self,
                      const float* __restrict__ bias,
                      float* __restrict__ out, float* __restrict__ out_self,
                      int num_edges, int d_in, int d_out) {
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

  // Passes over K: the message half, then the self-loop half (kernel 5:
  // the block's one half).
  const int half_end = kTwo ? (int)blockIdx.z + 1 : 2;
  for (int half = kTwo ? (int)blockIdx.z : 0; half < half_end; ++half) {
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

  float* __restrict__ dst = (kTwo && blockIdx.z) ? out_self : out;
  const bool with_bias = !kTwo || blockIdx.z == 0;
  const float* __restrict__ b_rel = bias + (int64_t)rel * d_out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = row0 + ty * TM + i;
    if (row >= num_edges) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = col0 + tx * TN + j;
      if (n < d_out) {
        dst[row * d_out + n] = acc[i][j] + (with_bias ? __ldg(b_rel + n) : 0.f);
      }
    }
  }
}

}  // namespace

// Kernel 2. x_src, x_dst: [E, d_in] f32; rel_sorted: [E] int32; w_msg,
// w_self: [U, d_in, d_out] f32; bias: [U, d_out] f32; out: [E, d_out] f32. All
// contiguous. Launches on `stream`; returns cudaGetLastError().
extern "C" int ghf_edge_transform(const void* x_src, const void* x_dst,
                                  const void* rel_sorted, const void* w_msg,
                                  const void* w_self, const void* bias,
                                  void* out, int num_edges, int d_in,
                                  int d_out, void* stream) {
  if (num_edges <= 0 || d_out <= 0) return (int)cudaSuccess;
  dim3 grid((num_edges + BM - 1) / BM, (d_out + BN - 1) / BN);
  edge_transform_kernel<false><<<grid, kThreads, 0,
                                 reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_src), static_cast<const float*>(x_dst),
      static_cast<const int32_t*>(rel_sorted),
      static_cast<const float*>(w_msg), static_cast<const float*>(w_self),
      static_cast<const float*>(bias), static_cast<float*>(out), nullptr,
      num_edges, d_in, d_out);
  return (int)cudaGetLastError();
}

// Kernel 5. x_src, x_dst: [E, d_in] f32; rel_sorted: [E] int32; w_msg,
// w_self: [U, d_in, d_out] f32; bias: [U, d_out] f32; msg, selfc:
// [E, d_out] f32. All contiguous. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int ghf_edge_transform_two(const void* x_src, const void* x_dst,
                                      const void* rel_sorted,
                                      const void* w_msg, const void* w_self,
                                      const void* bias, void* msg,
                                      void* selfc, int num_edges, int d_in,
                                      int d_out, void* stream) {
  if (num_edges <= 0 || d_out <= 0) return (int)cudaSuccess;
  dim3 grid((num_edges + BM - 1) / BM, (d_out + BN - 1) / BN, 2);
  edge_transform_kernel<true><<<grid, kThreads, 0,
                                reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_src), static_cast<const float*>(x_dst),
      static_cast<const int32_t*>(rel_sorted),
      static_cast<const float*>(w_msg), static_cast<const float*>(w_self),
      static_cast<const float*>(bias), static_cast<float*>(msg),
      static_cast<float*>(selfc), num_edges, d_in, d_out);
  return (int)cudaGetLastError();
}
