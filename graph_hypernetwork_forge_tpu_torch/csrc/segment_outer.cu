// Per-tile outer products of the segment-outer weight gradient (sm_90a).
//
//   partial[t] = x[tile t]^T g[tile t]      ([d_in, d_out] per tile, f32)
//   dW[u]      = sum of partial[t] over the tiles t of relation u
//
// The edge rows come relation-sorted and group-padded, so every 256-row tile
// holds one relation (a ragged last tile's missing rows count as zero). This
// kernel writes one partial per tile; the wrapper sums each relation's
// partials with the CSR segment-sum kernel (segment_sum.cu) over tile
// bounds, so a relation that no tile visits comes out exactly zero and the
// result is bitwise the same from run to run.
//
// Replaces the TPU kernel _segment_outer_impl
// (graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:473, kernel
// body :447-470), the dW half of edge_transform_sorted's backward. On the
// TPU a relation's dW block stays in VMEM while the sequential grid walks
// the relation's consecutive tiles. Hopper's blocks run in no order, so
// each tile writes its own partial and a second, deterministic pass adds
// them: no float atomics. This is kernel 3's dW half (edge_transform_bwd.cu)
// for one bank.
//
// What bounds it on the H100: bytes, nearly evenly with the f32 operations.
// x and g are read once (2 * E * d * 4 bytes, 0.53 GB at E=1.03M, d=64)
// against 2 * E * d_in * d_out operations (8.5 GFLOP). The per-tile
// partials add E / 256 * d_in * d_out * 4 bytes written here and read by
// the reduction (66 MB at d=64). f32 FMAs on the CUDA cores: tensor cores
// would take the product in TF32 or bf16 and break the f32 parity gate.
//
// What the design does about it: one block owns one tile and one 64 x 64
// window of the partial, K = the tile's rows, staged through shared memory
// 8 rows at a time as coalesced row slices of x and g; each thread keeps
// 4 x 4 outputs in registers and reads them as float4s: 16 FMAs for each
// 8 shared-memory words. 4 KB of shared memory a block, so many blocks
// share an SM and hide each other's load latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 256;  // relation tile of the group-padded layout
constexpr int kThreads = 256;
constexpr int BM = 64;          // d_in rows of the partial per block
constexpr int BN = 64;          // d_out columns of the partial per block
constexpr int BK = 8;           // edge rows staged per step
constexpr int TM = 4;           // rows per thread
constexpr int TN = 4;           // columns per thread

static_assert((BM / TM) * (BN / TN) == kThreads, "thread layout");
static_assert(BM == BN, "x and g slices share one load index");
static_assert(BM * BK == 2 * kThreads, "x and g slices: two loads each");

__global__ void __launch_bounds__(kThreads)
segment_outer_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ partial, int num_edges, int d_in,
                     int d_out) {
  __shared__ __align__(16) float Xs[BK][BM];
  __shared__ __align__(16) float Gs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // d_out column group
  const int ty = tid / (BN / TN);  // d_in row group
  const int64_t tile = blockIdx.x;
  const int64_t tile0 = tile * kTileRows;
  const int c0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * BN;
  const int tile_rows =
      (int)min((int64_t)kTileRows, (int64_t)num_edges - tile0);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < tile_rows; k0 += BK) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int idx = tid + l * kThreads;
      const int kk = idx / BM;
      const int cc = idx % BM;
      const int64_t row = tile0 + k0 + kk;
      const bool row_ok = k0 + kk < tile_rows;
      Xs[kk][cc] = (row_ok && c0 + cc < d_in)
                       ? __ldg(x + row * d_in + c0 + cc)
                       : 0.f;
      Gs[kk][cc] = (row_ok && n0 + cc < d_out)
                       ? __ldg(g + row * d_out + n0 + cc)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 xv = *reinterpret_cast<const float4*>(&Xs[kk][ty * TM]);
      const float4 gv = *reinterpret_cast<const float4*>(&Gs[kk][tx * TN]);
      const float u[TM] = {xv.x, xv.y, xv.z, xv.w};
      const float v[TN] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(u[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* __restrict__ p = partial + tile * d_in * d_out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + ty * TM + i;
    if (c >= d_in) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < d_out) p[(int64_t)c * d_out + n] = acc[i][j];
    }
  }
}

}  // namespace

// x: [E, d_in] f32; g: [E, d_out] f32; partial: [ceil(E / 256), d_in,
// d_out] f32, every element written. All contiguous. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int ghf_segment_outer(const void* x, const void* g, void* partial,
                                 int num_edges, int d_in, int d_out,
                                 void* stream) {
  if (num_edges <= 0 || d_in <= 0 || d_out <= 0) return (int)cudaSuccess;
  dim3 grid((num_edges + kTileRows - 1) / kTileRows, (d_in + BM - 1) / BM,
            (d_out + BN - 1) / BN);
  segment_outer_kernel<<<grid, kThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(partial), num_edges, d_in, d_out);
  return (int)cudaGetLastError();
}
